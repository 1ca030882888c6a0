"""The surface-tension and density-contrast gates on the port.

``validation.laplace_drop`` against ``benchmarks/surface_tension_drop.py``
(the cell CSF and the balanced CSF with kappa*, N=32 float64, 60 steps:
the pressure jump to 1e-10 of itself) and ``validation.density_contrast``
against ``benchmarks/density_contrast_disc.py`` (N=32 float64, 4 chunks of
5 steps: every logged row to 1e-10, the CG counts equal), with their
files under ``out_root`` (``laplace_history.csv`` in the JAX driver's
directory of each option set, ``trajectory.csv``: the same names,
header and rows, within those tolerances); then the JAX package's gates (tests/test_validation_gates.py) on the port at their own
sizes, N=48 float64: the Laplace error of the cell CSF below 1.5e-2 and
the balanced CSF with kappa* below it (1200 steps each, ~4 s), and the
heavy disc sinking with at most 100 CG iterations a step and the relative
divergence below 0.2 (to t = 0.25, ~4 s).
"""
import numpy as np
import pytest
import torch

from pyrmt_tpu_torch.validation import density_contrast, laplace_drop
from pyrmt_tpu_torch.validation.common import check_outputs, compare_outputs

torch.set_num_threads(1)
DEV = "cpu"


@pytest.mark.parametrize("st, suffix", [
    (dict(st_method="csf"), ""),
    (dict(st_method="balanced", kappa_interface=True), "_balanced_kstar")],
    ids=["csf", "balanced_kstar"])
def test_laplace_drop_matches_the_jax_driver(st, suffix, tmp_path):
    from benchmarks.surface_tension_drop import run

    dp, target, err = run(N=32, gamma=0.1, R=0.25, n_steps=60,
                          dtype="float64", verbose=False,
                          out_root=str(tmp_path / "jax"), **st)
    s = laplace_drop(N=32, gamma=0.1, R=0.25, n_steps=60,
                     dtype=torch.float64, device=DEV,
                     out_root=str(tmp_path / "port"), **st)
    assert s["target"] == target
    np.testing.assert_allclose(s["dp"], dp, rtol=1e-10)
    np.testing.assert_allclose(s["rel_err"], err, rtol=1e-8)
    d = f"surface_tension_drop_N32{suffix}"
    assert compare_outputs(tmp_path / "port" / d, tmp_path / "jax" / d) == [
        "laplace_history.csv"]
    for who in ("port", "jax"):  # step 1, and each of the last 50
        check_outputs("laplace_drop", tmp_path / who / d, rows=51)


def test_density_contrast_matches_the_jax_driver(tmp_path):
    from benchmarks.density_contrast_disc import run

    j_rows, _ = run(N=32, rho_ratio=10.0, t_end=0.02, dtype="float64",
                    verbose=False, out_root=str(tmp_path / "jax"),
                    log_every=5)
    rows, s = density_contrast(N=32, rho_ratio=10.0, t_end=0.02,
                               dtype=torch.float64, device=DEV, log_every=5,
                               out_root=str(tmp_path / "port"))
    assert len(rows) == len(j_rows) == 4
    for r, jr in zip(rows, j_rows):
        for k in ("t", "xc", "yc", "vc", "minJ", "max_div_rel",
                  "cg_relres"):
            np.testing.assert_allclose(r[k], jr[k], rtol=1e-10, atol=1e-13,
                                       err_msg=k)
        assert r["cg_iters_max"] == jr["cg_iters_max"] > 0
        # the driver divides its int32 sum in float32 (21.4 reads
        # 21.399999618530273); the port's mean is the float64 one
        np.testing.assert_allclose(r["cg_iters_mean"], jr["cg_iters_mean"],
                                   rtol=1e-7)
    assert s["steps"] == 20
    d = "density_contrast_N32"
    assert compare_outputs(tmp_path / "port" / d, tmp_path / "jax" / d,
                           tols=dict(cg_iters_mean=(1e-7, 0.0))) == [
        "trajectory.csv"]
    for who in ("port", "jax"):
        check_outputs("density_contrast", tmp_path / who / d, rows=4)


def test_gate_laplace_law_and_balanced_csf():
    s = laplace_drop(N=48, gamma=0.1, R=0.25, n_steps=1200,
                     dtype=torch.float64, device=DEV)
    assert s["rel_err"] < 1.5e-2, s
    b = laplace_drop(N=48, gamma=0.1, R=0.25, n_steps=1200,
                     st_method="balanced", kappa_interface=True,
                     dtype=torch.float64, device=DEV)
    assert b["rel_err"] < s["rel_err"], (b, s)


def test_gate_density_contrast_sinks_with_bounded_cg():
    _, s = density_contrast(N=48, rho_ratio=10.0, t_end=0.25,
                            dtype=torch.float64, device=DEV)
    assert s["vc_final"] < 0, s
    assert s["cg_iters_max"] < 100, s
    assert s["max_div_rel"] < 0.2, s
