"""The soft disc in the lid-driven cavity (``validation.soft_disc``)
against ``benchmarks/soft_disc_in_lid_driven.py::run``, the flagship's
published validation: N=32 float64 to t = 0.1 in chunks of 10 steps (the
JAX driver runs once, jitted, ~20 s). Every logged row (t, the centroid,
the least and largest J) to 1e-10 relative, the orbit's x-extent and the
mean deviation from Sugiyama's and Kolahduz's tracks likewise; the row
count equal. The files under ``out_root``: the same names, the same header
and rows of ``centroid.csv`` (1e-10), and the snapshots at
``SNAPSHOTS`` (the first two reached in one chunk) field by field within
1e-10 of the field's size, their attributes likewise; a run without h5py
writes them as ``.npz``. Besides: ``mean_track_deviation`` on a track of
its own."""
import os

import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import io as tio
from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.common import (
    check_outputs,
    compare_outputs,
    mean_track_deviation,
)

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
RUN = dict(N=32, t_end=0.1, log_every=10)
KEYS = ("t", "cx", "cy", "minJ", "maxJ")
# between the chunks' ends (t = 0.01 k): two targets in the second chunk
SNAPSHOTS = (0.015, 0.018, 0.055)
DIR = "soft_disc_lid_N32_semilagrangian"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.soft_disc_in_lid_driven import run

    out = tmp_path_factory.mktemp("out")
    traj, x_extent, devs = run(dtype="float64", verbose=False,
                               out_root=str(out / "jax"),
                               snapshot_times=SNAPSHOTS, **RUN)
    rows, s = validation.soft_disc_in_lid_driven(
        dtype=torch.float64, device=DEV, out_root=str(out / "port"),
        snapshot_times=SNAPSHOTS, **RUN)
    return (traj, x_extent, devs), (rows, s), out


def test_soft_disc_rows_match_the_jax_driver(runs):
    (traj, _, _), (rows, s), _ = runs
    assert len(rows) == len(traj) == 10
    for r, jr in zip(rows, traj):
        np.testing.assert_allclose([r[k] for k in KEYS], jr, rtol=1e-10,
                                   atol=1e-13)
    assert s["steps"] == 100 and s["stable"]


def test_soft_disc_track_deviation_matches_the_jax_driver(runs):
    (_, x_extent, devs), (_, s), _ = runs
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


def test_soft_disc_files_match_the_jax_driver(runs):
    _, (rows, _), out = runs
    names = compare_outputs(out / "port" / DIR, out / "jax" / DIR)
    assert names == ["centroid.csv"] + [
        validation.common.SNAPSHOT.format(t=t) for t in SNAPSHOTS]
    assert os.listdir(out / "port") == [DIR]
    for who in ("port", "jax"):
        found = check_outputs("soft_disc_in_lid_driven", out / who / DIR,
                              rows=len(rows))
        assert found["snap_t00.01.h5"]["phi"] == (32, 32)


def test_soft_disc_snapshots_match_the_jax_driver_field_by_field(runs):
    _, _, out = runs
    for name in ("snap_t00.01.h5", "snap_t00.02.h5"):
        got, got_attrs = tio.load_snapshot(str(out / "port" / DIR / name))
        want, want_attrs = tio.load_snapshot(str(out / "jax" / DIR / name))
        assert sorted(got) == sorted(want) == sorted(
            validation.common.SNAPSHOT_FIELDS)
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-10 * max(1.0, np.abs(want[k]).max()), err_msg=k)
        assert got_attrs["t_target"] == want_attrs["t_target"]
        np.testing.assert_allclose(got_attrs["t"], want_attrs["t"],
                                   rtol=1e-10)
    # the two targets of one chunk hold the same fields
    a, _ = tio.load_snapshot(str(out / "port" / DIR / "snap_t00.01.h5"))
    b, _ = tio.load_snapshot(str(out / "port" / DIR / "snap_t00.02.h5"))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_soft_disc_snapshots_without_h5py_are_npz(runs, tmp_path,
                                                 monkeypatch):
    _, _, out = runs
    monkeypatch.setattr(tio, "_HAVE_H5", False)
    validation.soft_disc_in_lid_driven(
        N=32, t_end=0.02, log_every=10, snapshot_times=SNAPSHOTS[:1],
        dtype=torch.float64, device=DEV, out_root=str(tmp_path))
    assert sorted(os.listdir(tmp_path / DIR)) == ["centroid.csv",
                                                 "snap_t00.01.npz"]
    check_outputs("soft_disc_in_lid_driven", tmp_path / DIR, rows=2)
    got, attrs = tio.load_snapshot(str(tmp_path / DIR / "snap_t00.01.npz"))
    monkeypatch.setattr(tio, "_HAVE_H5", True)
    want, want_attrs = tio.load_snapshot(str(out / "jax" / DIR
                                             / "snap_t00.01.h5"))
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=1e-10 * max(1.0, np.abs(want[k]).max()), err_msg=k)
    assert attrs["t_target"] == want_attrs["t_target"] == SNAPSHOTS[0]


def test_no_out_root_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    validation.soft_disc_in_lid_driven(
        N=16, t_end=0.004, log_every=2, snapshot_times=(0.001,),
        dtype=torch.float64, device=DEV)
    assert os.listdir(tmp_path) == []


def test_mean_track_deviation_of_points_on_and_off_a_track():
    rx, ry = np.array([0.0, 1.0, 1.0]), np.array([0.0, 0.0, 1.0])
    assert mean_track_deviation([0.5, 1.0], [0.0, 0.5], rx, ry) == 0.0
    assert mean_track_deviation([0.5], [0.25], rx, ry) == pytest.approx(0.25)
