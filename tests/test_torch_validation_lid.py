"""The soft disc in the lid-driven cavity (``validation.soft_disc``)
against ``benchmarks/soft_disc_in_lid_driven.py::run``, the flagship's
published validation: N=32 float64 to t = 0.1 in chunks of 10 steps (the
JAX driver runs once, jitted, ~20 s). Every logged row (t, the centroid,
the least and largest J) to 1e-10 relative, the orbit's x-extent and the
mean deviation from Sugiyama's and Kolahduz's tracks likewise; the row
count equal. Besides: ``mean_track_deviation`` on a track of its own."""
import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.common import mean_track_deviation

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
RUN = dict(N=32, t_end=0.1, log_every=10)
KEYS = ("t", "cx", "cy", "minJ", "maxJ")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.soft_disc_in_lid_driven import run

    traj, x_extent, devs = run(dtype="float64", verbose=False,
                               out_root=str(tmp_path_factory.mktemp("out")),
                               **RUN)
    rows, s = validation.soft_disc_in_lid_driven(dtype=torch.float64,
                                                 device=DEV, **RUN)
    return (traj, x_extent, devs), (rows, s)


def test_soft_disc_rows_match_the_jax_driver(runs):
    (traj, _, _), (rows, s) = runs
    assert len(rows) == len(traj) == 10
    for r, jr in zip(rows, traj):
        np.testing.assert_allclose([r[k] for k in KEYS], jr, rtol=1e-10,
                                   atol=1e-13)
    assert s["steps"] == 100 and s["stable"]


def test_soft_disc_track_deviation_matches_the_jax_driver(runs):
    (_, x_extent, devs), (_, s) = runs
    np.testing.assert_allclose(s["x_extent"], x_extent, rtol=1e-10,
                               atol=1e-13)
    assert set(s["deviations"]) == set(devs) == {"Sugiyama2011",
                                                 "Kolahduz2023"}
    for name, d in devs.items():
        np.testing.assert_allclose(s["deviations"][name], d, rtol=1e-10)
    for name, fn in (("Sugiyama2011", "Sugiyama_1024x1024.csv"),
                     ("Kolahduz2023", "Kolahduz_2023.csv")):
        x = np.loadtxt(validation.common.DATA_DIR / fn, delimiter=",")[:, 0]
        assert s["track_x_extent"][name] == x.max() - x.min()


def test_mean_track_deviation_of_points_on_and_off_a_track():
    rx, ry = np.array([0.0, 1.0, 1.0]), np.array([0.0, 0.0, 1.0])
    assert mean_track_deviation([0.5, 1.0], [0.0, 0.5], rx, ry) == 0.0
    assert mean_track_deviation([0.5], [0.25], rx, ry) == pytest.approx(0.25)
