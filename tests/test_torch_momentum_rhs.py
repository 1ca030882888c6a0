"""The one-RHS path against ``pyrmt_tpu``, float64 on the CPU.

``physics.velocity_rhs_blended`` with an external force (the plain version
of the one-RHS CUDA kernel) against the Pallas kernel
``velocity_rhs_blended_pallas`` in interpret mode on tests/test_pallas.py's
fields at N=64, and against JAX's XLA function on an odd grid (N=65, where
the TPU kernel falls back to it): max-abs <= 1e-12. Then the port's step
with ``momentum_method='xla', use_pallas_rhs=True`` against JAX's
``momentum_method='xla'`` step (JAX's use_pallas_rhs step cannot run on the
CPU: it passes the Pallas call no interpret flag; tests/test_pallas.py pins
its kernel to this XLA RHS at 1e-12): 3 flagship steps at N=32, u, v, X1,
X2 to 1e-12, p to 1e-11.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.momentum_rhs as mr
from pyrmt_tpu.kernels.momentum_rhs import velocity_rhs_blended_pallas
from pyrmt_tpu.physics import velocity_rhs_blended as j_rhs
from pyrmt_tpu_torch.physics import momentum_core, velocity_rhs_blended
from test_pallas import _fields
from test_torch_projection_stencils import assert_steps_match, step_trajectories

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

ATOL = 1e-12
MU_F = 0.01


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rhs_args(N):
    """(u, v, p, sxx, sxy, syy, dx, dy, mu_f, Hf, rho, fx, fy) of
    tests/test_pallas.py: a disc's blended stress, rho 1 to 1.2 and a
    seeded random force."""
    dx, dy, u, v, p, sxx, sxy, syy, H, rho, fx, fy = _fields(N)
    return (u, v, p, sxx, sxy, syy, dx, dy, MU_F, H, rho, fx, fy)


def as_jax(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]


def as_torch(args):
    return [tt(a) if isinstance(a, np.ndarray) else a for a in args]


def assert_close(out, ref):
    for o, r in zip(out, ref):
        err = float(np.max(np.abs(o.numpy() - np.asarray(r))))
        assert err <= ATOL, err


def test_rhs_with_force_matches_pallas_interpret():
    args = rhs_args(64)
    ref = velocity_rhs_blended_pallas(*as_jax(args), tile=32, interpret=True)
    out = velocity_rhs_blended(*as_torch(args))
    assert_close(out, ref)
    # the force counts: without it the RHS moves by more than the bound
    bare = velocity_rhs_blended(*as_torch(args[:11]))
    assert float((bare[0] - out[0]).abs().max()) > 1e-3


def test_rhs_with_force_on_odd_grid_matches_xla():
    args = rhs_args(65)
    assert_close(velocity_rhs_blended(*as_torch(args)), j_rhs(*as_jax(args)))


def test_cpu_tensors_take_the_plain_version():
    args = as_torch(rhs_args(16))
    before = mr.launches
    for o, r in zip(mr.velocity_rhs_blended_fused(*args),
                    velocity_rhs_blended(*args)):
        assert torch.equal(o, r)
    assert mr.launches == before


def test_zero_force_stage_rhs_keeps_momentum_core_bits():
    """The stage loop with the one-RHS wrapper and zero forces (the step's
    use_pallas_rhs path) equals the default stage loop bit for bit: adding
    a zero force rounds nothing."""
    u, v, p, sxx, sxy, syy, dx, dy, mu_f, H, rho, _, _ = as_torch(rhs_args(32))
    mkv = (H < 0.5).to(H.dtype) * (1.0 - H)
    zero = torch.zeros_like(u)
    kw = dict(eta_s=0.01, dx=dx, dy=dy, dt=tt(1e-3), mu_f=mu_f)
    fields = (u, v, p, sxx, sxy, syy, H, rho, mkv, pt.make_lid_bc(1.0))
    ref = momentum_core(*fields, **kw)
    out = momentum_core(*fields, **kw, rhs_fn=functools.partial(
        mr.velocity_rhs_blended_fused, f_ext_x=zero, f_ext_y=zero))
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


@pytest.mark.parametrize("projection", ["auto", "pallas"])
def test_rhs_step_matches_jax(projection):
    """momentum_method='xla' with use_pallas_rhs in the port, alone and
    with the projection's stencils too (both switches, as in JAX's
    bench.py --pallas)."""
    j = dict(projection_method=projection)
    assert_steps_match(step_trajectories(j, dict(j, use_pallas_rhs=True)))


@pytest.mark.parametrize("method,use_rhs,calls", [
    ("xla", True, 4), ("xla", False, 0), ("auto", True, 0),
    ("pallas", True, 0)])
def test_step_selects_the_stage_rhs(method, use_rhs, calls):
    """The one-RHS block runs at each of the 4 RK4 stages with
    momentum_method='xla' and use_pallas_rhs; the RK4 kernel's methods
    ignore use_pallas_rhs, as the JAX package does."""
    seen = []

    def rhs(*a, **kw):
        seen.append(kw["f_ext_x"].shape)
        return mr.velocity_rhs_blended_fused(*a, **kw)

    cfg = pt.RMTConfig(grid=pt.Grid(16, 16, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, momentum_method=method,
                       use_pallas_rhs=use_rhs)
    disc = pt.Disc(0.6, 0.5, 0.2)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (disc,),
                        dtype=torch.float64, device=DEV,
                        momentum_rhs_impl=rhs)
    s = pt.make_init_state(cfg, (disc,), dtype=torch.float64, device=DEV)
    s, _ = step(s, 1.0)
    assert seen == [(16, 16)] * calls and not bool(pt.diverged(s))
