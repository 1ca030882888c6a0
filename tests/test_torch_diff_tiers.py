"""Step gradients of the port against ``pyrmt_tpu`` beyond the flagship's
path (tests/test_torch_diff_cases.py): two discs in contact under the adaptive
timestep (the JAX package's contact regression: the contact force's and the
speed norm's sqrt at 0), kappa, rho_s and rho_f traced under gravity
(rho_f is gravity's reference density), and mu_s and rho_s traced on the
split tier (area fix) and the general tier (central2); 3 steps at N=24
float64, 1e-9 relative, finite.
"""
import pytest

from test_torch_diff_cases import check_case, losses

CASES = ("contact, adaptive dt", "kappa, rho_s, rho_f, gravity",
         "mu_s, split tier (area fix)", "mu_s, general tier (central2)")


@pytest.mark.parametrize("case", CASES)
def test_grad_matches_jax(case):
    check_case(case, losses(case))
