"""The surface-tension and density-contrast gates on the port.

``validation.laplace_drop`` against ``benchmarks/surface_tension_drop.py``
(the cell CSF and the balanced CSF with kappa*, N=32 float64, 60 steps:
the pressure jump to 1e-10 of itself) and ``validation.density_contrast``
against ``benchmarks/density_contrast_disc.py`` (N=32 float64, 4 chunks of
5 steps: every logged row to 1e-10, the CG counts equal); then the JAX
package's gates (tests/test_validation_gates.py) on the port at their own
sizes, N=48 float64: the Laplace error of the cell CSF below 1.5e-2 and
the balanced CSF with kappa* below it (1200 steps each, ~4 s), and the
heavy disc sinking with at most 100 CG iterations a step and the relative
divergence below 0.2 (to t = 0.25, ~4 s).
"""
import numpy as np
import pytest
import torch

from pyrmt_tpu_torch.validation import density_contrast, laplace_drop

torch.set_num_threads(1)
DEV = "cpu"


@pytest.mark.parametrize("st", [dict(st_method="csf"),
                                dict(st_method="balanced",
                                     kappa_interface=True)],
                         ids=["csf", "balanced_kstar"])
def test_laplace_drop_matches_the_jax_driver(st, tmp_path):
    from benchmarks.surface_tension_drop import run

    dp, target, err = run(N=32, gamma=0.1, R=0.25, n_steps=60,
                          dtype="float64", verbose=False,
                          out_root=str(tmp_path), **st)
    s = laplace_drop(N=32, gamma=0.1, R=0.25, n_steps=60,
                     dtype=torch.float64, device=DEV, **st)
    assert s["target"] == target
    np.testing.assert_allclose(s["dp"], dp, rtol=1e-10)
    np.testing.assert_allclose(s["rel_err"], err, rtol=1e-8)


def test_density_contrast_matches_the_jax_driver(tmp_path):
    from benchmarks.density_contrast_disc import run

    j_rows, _ = run(N=32, rho_ratio=10.0, t_end=0.02, dtype="float64",
                    verbose=False, out_root=str(tmp_path), log_every=5)
    rows, s = density_contrast(N=32, rho_ratio=10.0, t_end=0.02,
                               dtype=torch.float64, device=DEV, log_every=5)
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
