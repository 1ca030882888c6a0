"""Solid-solid contact (``validation.two_disc_contact``,
``validation.two_disc_tg_collision``) against the JAX drivers
``benchmarks/two_disc_contact.py::run`` and
``benchmarks/two_disc_tg_collision.py::run`` at N=32 float64 to t = 0.05
in chunks of 10 steps (each JAX driver runs once, jitted): every logged
row (the centroids, the gap, the least J) to 1e-10 relative, the least gap
and the predicates equal; their files under ``out_root``
(``centroids.csv``) with the same names, header and rows likewise. Then the JAX package's contact gate
(tests/test_validation_gates.py::test_gate_two_disc_contact_no_passthrough)
on the port at its own size, N=48 float64 to t = 0.6 (~12 s): the least
centre gap above 2R, 0.5 < min J < 1."""
import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.common import check_outputs, compare_outputs

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
RUN = dict(N=32, t_end=0.05, log_every=10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.two_disc_contact import run as contact_run
    from benchmarks.two_disc_tg_collision import run as collision_run

    out = tmp_path_factory.mktemp("out")
    jax = str(out / "jax")
    kw = dict(dtype=torch.float64, device=DEV, out_root=str(out / "port"),
              **RUN)
    return dict(
        out=out,
        contact=(contact_run(dtype="float64", verbose=False, out_root=jax,
                             **RUN), validation.two_disc_contact(**kw)),
        collision=(collision_run(dtype="float64", verbose=False,
                                 out_root=jax, **RUN),
                   validation.two_disc_tg_collision(**kw)))


@pytest.mark.parametrize("case, keys", [
    ("contact", ("t", "cxa", "cxb", "gap", "minJ")),
    ("collision", ("t", "cya", "cyb", "gap", "minJ"))])
def test_contact_rows_match_the_jax_driver(runs, case, keys):
    jax_out, (rows, s) = runs[case]
    hist, gmin, rebound = jax_out[:3]
    assert len(rows) == len(hist) == 5
    for r, jr in zip(rows, hist):
        np.testing.assert_allclose([r[k] for k in keys], jr, rtol=1e-10,
                                   atol=1e-13)
    np.testing.assert_allclose(s["gmin"], gmin, rtol=1e-10)
    assert s["rebound"] == rebound
    assert s["no_passthrough"]
    if case == "collision":
        assert s["diverged"] == jax_out[3] is False


@pytest.mark.parametrize("case, fn, directory", [
    ("contact", "two_disc_contact", "two_disc_contact_N32"),
    ("collision", "two_disc_tg_collision", "two_disc_tg_N32")])
def test_contact_files_match_the_jax_driver(runs, case, fn, directory):
    out = runs["out"]
    assert compare_outputs(out / "port" / directory,
                           out / "jax" / directory) == ["centroids.csv"]
    for who in ("port", "jax"):
        assert check_outputs(fn, out / who / directory) == {
            "centroids.csv": len(runs[case][1][0])}


def test_gate_two_disc_contact_no_passthrough():
    """The JAX package's gate, on the port."""
    rows, s = validation.two_disc_contact(N=48, t_end=0.6,
                                          dtype=torch.float64, device=DEV)
    assert s["gmin"] > 2 * 0.15, f"discs passed through: {s['gmin']}"
    minJ = min(r["minJ"] for r in rows)
    assert minJ == s["minJ"]
    assert 0.5 < minJ < 1.0, f"min J {minJ} outside the physical range"
