"""The port's plain RMT block against the composed pyrmt_tpu ops.

Recipe of tests/test_pallas.py::test_rmt_block_fused_matches_composed_ops
(N=64, the flagship disc at (0.6, 0.5), a Taylor-Green velocity, one
block): all 12 outputs agree in float64 to 1e-13, J to 1e-12. The CUDA
kernel is held to this plain version on the card (chip_smoke.py and
tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu.ops.advect import advect_semilagrangian_rk4_local
from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu.ops.stress import smoothed_heaviside, solid_cauchy_stress
from pyrmt_tpu.sim import RMTConfig as JConfig
from pyrmt_tpu.sim import make_init_state as j_init
from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_fused, rmt_block_plain
from pyrmt_tpu_torch.ops.levelset import Disc

torch.set_num_threads(1)

N = 64
MU_S, KAPPA, RHO_S, RHO_F = 0.1, 0.0, 1.3, 1.0
NAMES = ("X1e", "X2e", "phis", "sxx", "sxy", "syy", "J", "Hf", "rho_local",
         "sig_sxx_el", "sig_sxy_el", "sig_syy_el")


def j_phi(X, Y):
    return jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2


@pytest.fixture(scope="module")
def case():
    g = JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    cfg = JConfig(grid=g, mu_s=MU_S, eta_s=0.01, rho_s=RHO_S, mu_f=0.01,
                  rho_f=RHO_F, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    state = j_init(cfg, (j_phi,), dtype=jnp.float64)
    X, Y = g.coords(dtype=jnp.float64)
    u = 0.3 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v = -0.3 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    dt = 1e-3

    # the JAX composed ops (the XLA twin the Pallas kernel is pinned to)
    phi0 = j_phi(state.X1[0], state.X2[0])
    mask = (phi0 <= 0.0).astype(jnp.float64)
    qs = advect_semilagrangian_rk4_local(
        jnp.concatenate([state.X1, state.X2]), u, v, dt, g.dx, g.dy)
    X1e, X2e = extrapolate_reference_map(qs[0] * mask, qs[1] * mask, phi0,
                                         g.dx, g.dy, 3)
    phi2 = j_phi(X1e, X2e)
    sxx, sxy, syy, J = solid_cauchy_stress(X1e, X2e, g.dx, g.dy, MU_S, KAPPA,
                                           phi2)
    H = smoothed_heaviside(phi2, cfg.w_t)
    ref = (X1e, X2e, phi2, sxx, sxy, syy, J, H, H * RHO_F + (1 - H) * RHO_S,
           (1 - H) * sxx, (1 - H) * sxy, (1 - H) * syy)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    args = (t(u), t(v), t(state.X1), t(state.X2), t(dt))
    kw = dict(phi_inits=(Disc(0.6, 0.5, 0.2),), dx=g.dx, dy=g.dy,
              num_layers=3, w_t=cfg.w_t,
              params=t([MU_S, KAPPA, RHO_S, RHO_F]))
    return args, kw, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_plain_rmt_block_matches_jax(case, i):
    args, kw, ref = case
    out = rmt_block_plain(*args, **kw)[i]
    if out.dim() == 3:
        out = out[0]
    atol = 1e-12 if NAMES[i] == "J" else 1e-13
    np.testing.assert_allclose(out.numpy(), ref[i], rtol=0, atol=atol)


def test_cpu_tensor_takes_the_plain_version(case):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    import pyrmt_tpu_torch.kernels.rmt_block as rb

    args, kw, _ = case
    before = rb.launches
    for a, b in zip(rmt_block_fused(*args, **kw), rmt_block_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert rb.launches == before


def test_solid_free_rows_and_a_moving_disc(case):
    """The block moved the interface and left solid-free rows untouched:
    far from the disc the map stays 0, J 1 and the stress 0."""
    args, kw, ref = case
    out = rmt_block_plain(*args, **kw)
    X1e, J, sxx = out[0][0], out[6][0], out[3][0]
    assert float(X1e[:5].abs().max()) == 0.0
    assert float((J[:5] - 1.0).abs().max()) == 0.0
    assert float(sxx[:5].abs().max()) == 0.0
    assert float((X1e - args[2][0]).abs().max()) > 0.0
