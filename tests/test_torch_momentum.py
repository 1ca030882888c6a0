"""The port's plain RK4 momentum update against
``pyrmt_tpu.physics.momentum_core`` (the XLA twin the Pallas kernel is
pinned to in tests/test_pallas.py), over both stock wall BCs and with and
without Kelvin-Voigt damping: float64, atol 1e-13. The CUDA kernel is held
to this plain version on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as j_bcs
import pyrmt_tpu_torch.bcs as t_bcs
import pyrmt_tpu_torch.kernels.momentum_rk4 as mk
from pyrmt_tpu.physics import compute_timestep as j_timestep
from pyrmt_tpu.physics import momentum_core as j_momentum_core
from pyrmt_tpu.physics import velocity_rhs_blended as j_rhs
from pyrmt_tpu_torch.physics import compute_timestep, momentum_core
from pyrmt_tpu_torch.physics import velocity_rhs_blended as t_rhs

torch.set_num_threads(1)

N = 64


def inputs(seed=0):
    """Taylor-Green velocity and pressure with seeded noise, blended fields
    of a disc at (0.6, 0.5)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    dx = 1.0 / (N - 1)
    u = 0.1 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.1 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    u += 0.01 * rng.standard_normal((N, N))
    v += 0.01 * rng.standard_normal((N, N))
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    phi = np.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2
    H = 0.5 * (1 + np.tanh(phi / (2 * dx)))
    one_m = 1.0 - H
    sxx = one_m * (1.0 + 0.1 * np.sin(3 * X))
    sxy = one_m * 0.05 * np.cos(2 * Y)
    syy = one_m * (1.0 - 0.1 * X * Y)
    rho = H * 1.0 + one_m * 1.2
    mkv = (phi <= 0).astype(np.float64) * one_m
    return dx, (u, v, p, sxx, sxy, syy, H, rho), mkv


@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("bc_name", ["lid", "free_slip"])
def test_plain_momentum_rk4_matches_jax(bc_name, eta_s):
    dx, fields, mkv = inputs()
    dt = 1e-3
    kw = dict(eta_s=eta_s, dx=dx, dy=dx, dt=dt, mu_f=0.01)
    j_bc = j_bcs.make_lid_bc(1.0) if bc_name == "lid" else j_bcs.free_slip_box_bc
    t_bc = t_bcs.make_lid_bc(1.0) if bc_name == "lid" else t_bcs.free_slip_box_bc
    zero = jnp.zeros((N, N))
    ref = j_momentum_core(*(jnp.asarray(f) for f in fields), zero, zero,
                          jnp.asarray(mkv), j_bc, **kw)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    out = momentum_core(*(t(f) for f in fields), t(mkv), t_bc, **kw)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-13)
    # the wrapper takes the plain version on a CPU tensor, with dt a 0-d
    # tensor as the step passes it
    before = mk.launches
    out_w = mk.momentum_rk4_fused(*(t(f) for f in fields), t(mkv), t_bc,
                                  **dict(kw, dt=t(dt)))
    assert mk.launches == before
    for o, w in zip(out, out_w):
        np.testing.assert_allclose(w.numpy(), o.numpy(), rtol=0, atol=1e-15)


def test_velocity_rhs_blended_matches_jax():
    dx, fields, _ = inputs(seed=1)
    u, v, p, sxx, sxy, syy, H, rho = fields
    ref = j_rhs(*(jnp.asarray(f) for f in (u, v, p, sxx, sxy, syy)), dx, dx,
                0.01, jnp.asarray(H), jnp.asarray(rho), 0.0, 0.0)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    out = t_rhs(*(t(f) for f in (u, v, p, sxx, sxy, syy)), dx, dx, 0.01,
                t(H), t(rho))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("speed", [0.0, 0.5, 40.0])
def test_compute_timestep_matches_jax(speed):
    """Adaptive dt at rest, CFL-limited and viscous/solid-limited."""
    dx, fields, _ = inputs()
    u, v = speed * fields[0], speed * fields[1]
    args = (dx, dx, 0.2, 1e-3, 0.1, 1.0, 0.0, 1.0)
    kw = dict(mu_f=0.01, eta_s=0.01, kappa=0.0)
    ref = float(j_timestep(jnp.asarray(u), jnp.asarray(v), *args, **kw))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    out = compute_timestep(t(u), t(v), *args, **kw)
    assert out.dim() == 0
    assert abs(float(out) - ref) <= 1e-16
