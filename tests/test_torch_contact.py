"""The port's contact force and body forces against ``pyrmt_tpu``.

``ops.contact.compute_contact_force`` against
``pyrmt_tpu.ops.contact.compute_contact_force``, and ``physics.
external_forces`` / ``body_forces`` against ``pyrmt_tpu.physics.
external_forces`` plus the gravity term of
``pyrmt_tpu.physics.momentum_step_rk4_multi`` ((rho_local - rho_ref) g),
for two and three solids: float64, N=64, level sets of discs with seeded
noise, within 1e-13 of the field's size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrmt_tpu.ops.contact import compute_contact_force as j_contact
from pyrmt_tpu.ops.stress import smoothed_heaviside as j_heaviside
from pyrmt_tpu.physics import external_forces as j_external_forces
from pyrmt_tpu_torch.ops.contact import compute_contact_force
from pyrmt_tpu_torch.physics import body_forces, external_forces

torch.set_num_threads(1)

N = 64
DX = 1.0 / (N - 1)
W_T = 2.0 * DX
DISCS = ((0.38, 0.5, 0.14), (0.66, 0.5, 0.14), (0.52, 0.78, 0.12))


def level_sets(S, seed=0):
    """(S, N, N) signed distances to the first S discs, with seeded noise
    of a tenth of a cell, and a density that varies across them."""
    rng = np.random.default_rng(seed)
    x = np.arange(N) * DX
    X, Y = np.meshgrid(x, x)
    phis = np.stack([np.hypot(X - x0, Y - y0) - R for x0, y0, R in DISCS[:S]])
    phis += 0.1 * DX * rng.standard_normal(phis.shape)
    rho = 1.0 + 0.2 * np.sum(phis < 0.0, axis=0) + 0.01 * rng.standard_normal(
        (N, N))
    return phis, rho


def assert_close_to_size(out, ref):
    ref = np.asarray(ref)
    size = float(np.abs(ref).max())
    assert size > 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-13 * size)


@pytest.mark.parametrize("w_c", [3.0 * DX, 1.5 * DX])
@pytest.mark.parametrize("k_rep", [2.0, 0.5])
def test_contact_force_matches_jax(k_rep, w_c):
    phis, _ = level_sets(2)
    ref = j_contact(jnp.asarray(phis[0]), jnp.asarray(phis[1]), k_rep, w_c,
                    DX, DX)
    out = compute_contact_force(torch.tensor(phis[0]), torch.tensor(phis[1]),
                                k_rep, w_c, DX, DX)
    for o, r in zip(out, ref):
        assert_close_to_size(o, r)


def test_contact_force_on_a_flat_mid_surface_is_zero():
    """Two equal level sets: the mid-surface phi12 is 0 and its gradient
    exactly 0, so the double-where norm gives a zero normal and no NaN, as
    in JAX."""
    phis, _ = level_sets(2)
    out = compute_contact_force(torch.tensor(phis[0]), torch.tensor(phis[0]),
                                2.0, 3 * DX, DX, DX)
    ref = j_contact(jnp.asarray(phis[0]), jnp.asarray(phis[0]), 2.0, 3 * DX,
                    DX, DX)
    for o, r in zip(out, ref):
        assert bool(torch.isfinite(o).all())
        assert float(o.abs().max()) == 0.0 == float(jnp.abs(r).max())


@pytest.mark.parametrize("w_c", [3.0 * DX, None], ids=["w_c", "w_c_none"])
@pytest.mark.parametrize("S", [2, 3])
def test_external_forces_match_jax(S, w_c):
    phis, _ = level_sets(S, seed=S)
    H = j_heaviside(jnp.asarray(phis), W_T)
    ref = j_external_forces(jnp.asarray(phis), H, DX, DX, gamma=0.0,
                            k_rep=2.0, w_c=w_c, w_t=W_T)
    out = external_forces(torch.tensor(phis), None, DX, DX, gamma=0.0,
                          k_rep=2.0, w_c=w_c, w_t=W_T)
    for o, r in zip(out, ref):
        assert_close_to_size(o, r)


@pytest.mark.parametrize("g", [(0.0, -1.0), (0.3, -2.0)], ids=["g_y", "g_xy"])
@pytest.mark.parametrize("S", [2, 3])
def test_body_forces_with_gravity_match_jax(S, g):
    """Contact plus gravity, as pyrmt_tpu.physics.momentum_step_rk4_multi
    adds them (pyrmt_tpu/physics.py:335-342), with rho_f as the reference
    density and with another one."""
    phis, rho = level_sets(S, seed=10 + S)
    g_x, g_y = g
    for rho_ref in (1.0, 1.1):
        fx, fy = j_external_forces(
            jnp.asarray(phis), None, DX, DX, gamma=0.0, k_rep=2.0,
            w_c=3 * DX, w_t=W_T)
        drho = jnp.asarray(rho) - rho_ref
        ref = (fx + drho * g_x, fy + drho * g_y)
        out = body_forces(torch.tensor(phis), torch.tensor(rho), DX, DX,
                          gamma=0.0, k_rep=2.0, w_c=3 * DX, w_t=W_T, g_x=g_x,
                          g_y=g_y, g_rho_ref=rho_ref)
        for o, r in zip(out, ref):
            assert_close_to_size(o, r)


def test_body_forces_without_contact_or_gravity():
    """One solid, or contact off, and no gravity: no force at all (the
    kernels then run without force operands); gravity alone is
    (rho - rho_ref) g."""
    phis, rho = level_sets(2)
    t_phis, t_rho = torch.tensor(phis), torch.tensor(rho)
    kw = dict(gamma=0.0, w_c=None, w_t=W_T)
    assert body_forces(t_phis[:1], t_rho, DX, DX, k_rep=2.0, **kw) == (
        None, None)
    assert body_forces(t_phis, t_rho, DX, DX, k_rep=0.0, **kw) == (None, None)
    fx, fy = body_forces(t_phis, t_rho, DX, DX, k_rep=0.0, g_y=-1.0,
                         g_rho_ref=1.0, **kw)
    assert torch.equal(fy, (t_rho - 1.0) * -1.0)
    assert float(fx.abs().max()) == 0.0


def test_surface_tension_raises():
    """Surface tension beside contact (it raised before it was ported):
    the CSF plus the contact of two solids, against JAX."""
    phis, _ = level_sets(2)
    H = j_heaviside(jnp.asarray(phis), W_T)
    ref = j_external_forces(jnp.asarray(phis), H, DX, DX, gamma=0.1,
                            k_rep=2.0, w_c=None, w_t=W_T)
    out = external_forces(torch.tensor(phis), torch.tensor(np.asarray(H)),
                          DX, DX, gamma=0.1, k_rep=2.0, w_c=None, w_t=W_T)
    for o, r in zip(out, ref):
        assert_close_to_size(o, r)
