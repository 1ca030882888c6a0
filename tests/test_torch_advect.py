"""The advection schemes and the momentum step from the maps in the port
against the JAX package (``pyrmt_tpu.ops.advect``,
``pyrmt_tpu.physics.momentum_step_rk4_multi`` and its two wrappers).

Inputs are float64, made from a numpy seed on an anisotropic grid (Ny=36,
Nx=40, dx != dy): a velocity of random Fourier modes of either sign, maps
with a smooth part and a jump (so that the WENO5 weights leave their
linear values), a disc's level set. Each function of ``ops/advect.py``
agrees with its JAX counterpart to 1e-13 of the field's size: the WENO5
faces, the derivative along both axes under a positive, a negative and a
mixed wind (the negative one reads the fixed right-biased minus face, and
every column and row is compared, the edge fallbacks i < 3 and i + 3 >= N
among them), the banded right-hand sides at three ``w_cut``, both SSP-RK3
schemes, the RK4 backtrace over more than a cell, the gather path bilinear
and bicubic (with a ``cubic_mask``), with NaN and 1e300 in the velocity
and in the maps, the dispatcher and its ValueErrors. The stacked
evaluation that the step uses (2S maps, one phi each) equals the maps one
by one bit for bit. The momentum step and its wrappers agree to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.ops.advect as jadv
import pyrmt_tpu.ops.fd as jfd
import pyrmt_tpu.physics as jphys
import pyrmt_tpu_torch.ops.advect as tadv
import pyrmt_tpu_torch.ops.fd as tfd
import pyrmt_tpu_torch.physics as tphys
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu_torch.bcs import make_lid_bc as t_lid_bc

torch.set_num_threads(1)

NY, NX = 36, 40
LX, LY = 1.0, 0.9
DX, DY = LX / (NX - 1), LY / (NY - 1)


def grid():
    x = np.linspace(0.0, LX, NX)
    y = np.linspace(0.0, LY, NY)
    return np.meshgrid(x, y)


def velocity(seed, sign=0):
    """A smooth velocity of random Fourier modes, max |u| = 1; ``sign`` +1
    or -1 makes both components of one sign."""
    rng = np.random.default_rng(seed)
    X, Y = grid()
    a = np.zeros_like(X)
    b = np.zeros_like(X)
    for _ in range(3):
        kx, ky = rng.integers(1, 4, size=2)
        c = rng.standard_normal(4)
        a += c[0] * np.sin(np.pi * kx * X + c[2]) * np.cos(np.pi * ky * Y)
        b += c[1] * np.cos(np.pi * kx * X) * np.sin(np.pi * ky * Y + c[3])
    if sign:
        a, b = sign * (np.abs(a) + 0.1), sign * (np.abs(b) + 0.1)
    s = max(np.abs(a).max(), np.abs(b).max())
    return a / s, b / s


def maps(seed, K=2):
    """K map-like fields: the identity with a smooth wobble, and a jump
    across a line, so that WENO5's smoothness indicators differ."""
    rng = np.random.default_rng(seed)
    X, Y = grid()
    out = []
    for k in range(K):
        r = rng.standard_normal(3)
        f = (X if k % 2 == 0 else Y) + 0.05 * np.sin(3 * X + r[0]) * np.cos(
            2 * Y + r[1])
        f = f + 0.3 * (X + 0.4 * Y > 0.55 + 0.1 * r[2])
        out.append(f)
    return np.stack(out)


def disc_phi(x0=0.55, y0=0.45, R=0.22):
    X, Y = grid()
    return np.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def assert_close(out, ref, rel=1e-13):
    """max-abs <= rel times the reference's largest finite magnitude, NaN
    where the reference has NaN."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    scale = max(np.abs(ref[fin]).max(), 1e-300)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=rel * scale)


def test_weno5_faces_match_jax():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((5, 200))
    vals[:, :20] *= 1e-5  # smooth: the weights near their linear values
    for tf, jf in ((tadv._weno5_left, jadv._weno5_left),
                   (tadv._weno5_right, jadv._weno5_right)):
        assert_close(tf(*map(t, vals)), jf(*map(j, vals)))


@pytest.mark.parametrize("wind", ["positive", "negative", "mixed"])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_weno5_derivative_matches_jax(axis, wind):
    q = maps(1, K=1)[0]
    a, b = velocity(2, sign={"positive": 1, "negative": -1, "mixed": 0}[wind])
    vel, h = (a, DX) if axis == "x" else (b, DY)
    tshift = tfd._shift_x if axis == "x" else tfd._shift_y
    jshift = jfd._shift_x if axis == "x" else jfd._shift_y
    out = tadv._weno5_deriv_1d(t(q), t(vel), h, tshift).numpy()
    ref = np.asarray(jadv._weno5_deriv_1d(j(q), j(vel), h, jshift))
    assert_close(out, ref)
    # the minus-face fix: a negative wind still sees the gradient
    assert np.abs(out).max() > 0.1


@pytest.mark.parametrize("w_cut", [0.0, 0.05, -0.02])
@pytest.mark.parametrize("scheme", ["weno5", "central2"])
def test_banded_rhs_matches_jax(scheme, w_cut):
    q = maps(3, K=1)[0]
    a, b = velocity(4)
    phi = disc_phi()
    tf = tadv.weno5_rhs if scheme == "weno5" else tadv.central2_rhs
    jf = jadv.weno5_rhs if scheme == "weno5" else jadv.central2_rhs
    out = tf(t(q), t(a), t(b), DX, DY, t(phi), w_cut).numpy()
    ref = np.asarray(jf(j(q), j(a), j(b), DX, DY, j(phi), w_cut))
    assert_close(out, ref)
    margin = 2 if scheme == "weno5" else 1
    band = phi <= w_cut
    band[:margin] = band[-margin:] = False
    band[:, :margin] = band[:, -margin:] = False
    assert np.all(out[~band] == 0.0) and np.abs(out[band]).max() > 0.0


@pytest.mark.parametrize("scheme", ["weno5", "central2"])
def test_rk3_schemes_match_jax(scheme):
    q = maps(5, K=1)[0]
    a, b = velocity(6)
    phi = disc_phi()
    dt = 0.4 * min(DX, DY)
    tf = (tadv.advect_weno5_rk3 if scheme == "weno5"
          else tadv.advect_central2_rk3)
    jf = (jadv.advect_weno5_rk3 if scheme == "weno5"
          else jadv.advect_central2_rk3)
    for dtt in (dt, t(dt)):  # a float or a 0-d tensor
        out = tf(t(q), t(a), t(b), DX, DY, dtt, t(phi), 0.03).numpy()
        ref = np.asarray(jf(j(q), j(a), j(b), DX, DY, dt, j(phi), 0.03))
        assert_close(out, ref)
    assert not np.array_equal(out, q)


def test_backtrace_over_more_than_a_cell_matches_jax():
    a, b = velocity(7)
    X, Y = grid()
    dt = 2.5 * min(DX, DY)  # up to 2.5 cells
    out = tadv.backtrace_rk4(t(a), t(b), t(X), t(Y), t(dt), DX, DY)
    ref = jadv.backtrace_rk4(j(a), j(b), j(X), j(Y), dt, DX, DY)
    for o, r in zip(out, ref):
        assert_close(o.numpy(), r)
    cells = max(np.abs(out[0].numpy() - X).max() / DX,
                np.abs(out[1].numpy() - Y).max() / DY)
    assert cells > 1.5


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "bicubic_mask"])
def test_gather_path_matches_jax(interp):
    qs = maps(8, K=3)
    a, b = velocity(9)
    X, Y = grid()
    dt = 1.7 * min(DX, DY)
    mask = disc_phi() < -3 * DX if interp == "bicubic_mask" else None
    kind = interp.split("_")[0]
    out = tadv.advect_semilagrangian_rk4_multi(
        t(qs), t(a), t(b), t(X), t(Y), t(dt), DX, DY, interp=kind,
        cubic_mask=None if mask is None else torch.tensor(mask))
    ref = jadv.advect_semilagrangian_rk4_multi(
        j(qs), j(a), j(b), j(X), j(Y), dt, DX, DY, interp=kind,
        cubic_mask=None if mask is None else jnp.asarray(mask))
    assert_close(out.numpy(), ref)
    one = tadv.advect_semilagrangian_rk4(t(qs[0]), t(a), t(b), t(X), t(Y),
                                         dt, DX, DY)
    assert_close(one.numpy(), jadv.advect_semilagrangian_rk4(
        j(qs[0]), j(a), j(b), j(X), j(Y), dt, DX, DY))


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_gather_path_takes_nan_and_far_queries_as_jax(interp):
    """A NaN and a 1e300 in the velocity send departure points to NaN and
    far outside the grid; a NaN and a 1e300 in a map spread through its
    samples: the same NaNs and values in both packages."""
    qs = maps(10, K=2)
    qs[1, 20, 25] = np.nan
    qs[1, 5, 33] = 1e300
    a, b = velocity(11)
    a[12, 17] = np.nan
    b[30, 3] = 1e300
    a[2, 2] = -1e300
    X, Y = grid()
    dt = 0.9 * min(DX, DY)
    out = tadv.advect_semilagrangian_rk4_multi(
        t(qs), t(a), t(b), t(X), t(Y), dt, DX, DY, interp=interp).numpy()
    ref = np.asarray(jadv.advect_semilagrangian_rk4_multi(
        j(qs), j(a), j(b), j(X), j(Y), dt, DX, DY, interp=interp))
    assert np.isnan(ref).any() and np.isfinite(ref[0]).sum() > 0
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("scheme", ["semilagrangian", "weno5", "central2"])
def test_dispatcher_matches_jax(scheme):
    qs = maps(12, K=2)
    a, b = velocity(13)
    X, Y = grid()
    phi = disc_phi()
    dt = 0.5 * min(DX, DY)
    out = tadv.advect_reference_map_multi(t(qs), t(a), t(b), t(X), t(Y),
                                          t(dt), DX, DY, t(phi), scheme, 0.02)
    ref = jadv.advect_reference_map_multi(j(qs), j(a), j(b), j(X), j(Y), dt,
                                          DX, DY, j(phi), scheme, 0.02)
    assert_close(out.numpy(), ref)
    one = tadv.advect_reference_map(t(qs[1]), t(a), t(b), t(X), t(Y), dt,
                                    DX, DY, t(phi), scheme, 0.02)
    assert_close(one.numpy(), jadv.advect_reference_map(
        j(qs[1]), j(a), j(b), j(X), j(Y), dt, DX, DY, j(phi), scheme, 0.02))


def test_unknown_scheme_and_interpolant_raise_as_jax():
    qs = maps(14, K=1)
    a, b = velocity(15)
    X, Y = grid()
    for kw in (dict(scheme="upwind"), dict(sl_interp="lanczos")):
        with pytest.raises(ValueError) as jerr:
            jadv.advect_reference_map_multi(j(qs), j(a), j(b), j(X), j(Y),
                                            0.01, DX, DY, None, **kw)
        with pytest.raises(ValueError) as terr:
            tadv.advect_reference_map_multi(t(qs), t(a), t(b), t(X), t(Y),
                                            0.01, DX, DY, None, **kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("scheme", ["weno5", "central2"])
def test_stacked_maps_equal_maps_one_by_one(scheme):
    """The step advects the 2S components of S solids as one stack, each
    with its solid's phi: bit for bit the components one at a time."""
    qs = t(maps(16, K=4))
    a, b = velocity(17)
    X, Y = grid()
    phis = t(np.stack([disc_phi(0.3, 0.4, 0.15), disc_phi(0.7, 0.5, 0.18)]))
    phi2 = torch.cat([phis, phis])
    dt = t(0.4 * min(DX, DY))
    args = (t(a), t(b), t(X), t(Y), dt, DX, DY)
    stacked = tadv.advect_reference_map_multi(qs, *args, phi2, scheme, 0.01)
    for k in range(4):
        alone = tadv.advect_reference_map(qs[k], *args, phi2[k], scheme, 0.01)
        assert torch.equal(stacked[k], alone), k


# ── the momentum step from the maps ─────────────────────────────────────


def momentum_inputs(S, seed=20):
    """u, v, p, maps (the identity, wobbled: det G off 1) and level sets
    of S discs."""
    rng = np.random.default_rng(seed)
    X, Y = grid()
    a, b = velocity(seed)
    p = 0.05 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    centres = [(0.3, 0.45, 0.15), (0.68, 0.45, 0.16)][:S] if S > 1 else [
        (0.55, 0.45, 0.22)]
    X1s, X2s, phis = [], [], []
    for (x0, y0, R) in centres:
        r = rng.standard_normal(2)
        X1 = X + 0.02 * np.sin(4 * Y + r[0])
        X2 = Y + 0.02 * np.sin(3 * X + r[1])
        X1s.append(X1)
        X2s.append(X2)
        phis.append(np.sqrt((X1 - x0) ** 2 + (X2 - y0) ** 2) - R)
    return 0.3 * a, 0.3 * b, p, np.stack(X1s), np.stack(X2s), np.stack(phis)


PHYS = dict(mu_s=0.4, kappa=0.3, dx=DX, dy=DY, dt=2e-3, rho_s=1.3,
            rho_f=1.0, mu_f=0.01, w_t=2 * DX)


@pytest.mark.parametrize("case", ["one_kv_csf_gravity", "two_contact_clamp",
                                  "one_band_override"])
def test_momentum_step_rk4_multi_matches_jax(case):
    S = 2 if case.startswith("two") else 1
    u, v, p, X1s, X2s, phis = momentum_inputs(S)
    kw = dict(PHYS, eta_s=0.01 if S == 1 else 0.0)
    if case == "one_kv_csf_gravity":
        kw.update(gamma=0.05, g_y=-1.0, g_rho_ref=1.1)
    elif case == "two_contact_clamp":
        kw.update(k_rep=2.0, w_c=3 * DX, stress_clamp=1.05, g_x=0.5)
    else:
        kw.update(stress_w_cut=2 * DX, stress_clamp=1.05)
    rng = np.random.default_rng(21)
    override = 0.01 * rng.standard_normal((2, NY, NX))
    args = lambda f: (f(u), f(v), f(p), f(X1s), f(X2s), f(phis))
    t_kw, j_kw = dict(kw), dict(kw)
    if case == "one_band_override":
        t_kw["ext_override"] = (t(override[0]), t(override[1]))
        j_kw["ext_override"] = (j(override[0]), j(override[1]))
    out = tphys.momentum_step_rk4_multi(*args(t), t_lid_bc(1.0), **t_kw)
    ref = jphys.momentum_step_rk4_multi(*args(j), j_lid_bc(1.0), **j_kw)
    for name, o, r in zip(("u", "v", "sxx", "sxy", "syy", "J"), out, ref):
        assert o.shape == r.shape, name
        assert_close(o.numpy(), r, rel=1e-12)
    assert float(out[2].abs().max()) > 0.0


@pytest.mark.parametrize("stress_band", [False, True])
def test_momentum_step_rk4_matches_jax(stress_band):
    u, v, p, X1s, X2s, phis = momentum_inputs(1, seed=22)
    args = lambda f, bc: (f(u), f(v), f(p), f(X1s[0]), f(X2s[0]), bc, 0.4,
                          0.3, 0.01, DX, DY, 2e-3, 1.3, 1.0, f(phis[0]),
                          0.01, 2 * DX)
    kw = dict(gamma=0.05, stress_band=stress_band, detg_clamp=1.05)
    out = tphys.momentum_step_rk4(*args(t, t_lid_bc(1.0)), **kw)
    ref = jphys.momentum_step_rk4(*args(j, j_lid_bc(1.0)), **kw)
    for o, r in zip(out, ref):
        assert_close(o.numpy(), r, rel=1e-12)


def test_momentum_step_rk4_2solids_matches_jax():
    u, v, p, X1s, X2s, phis = momentum_inputs(2, seed=23)
    args = lambda f, bc: (f(u), f(v), f(p), f(X1s[0]), f(X2s[0]), f(X1s[1]),
                          f(X2s[1]), bc, 0.4, 0.3, 0.01, DX, DY, 2e-3, 1.3,
                          1.0, f(phis[0]), f(phis[1]), 0.01, 2 * DX)
    kw = dict(k_rep=2.0, w_c=3 * DX, detg_clamp=1.05)
    out = tphys.momentum_step_rk4_2solids(*args(t, t_lid_bc(1.0)), **kw)
    ref = jphys.momentum_step_rk4_2solids(*args(j, j_lid_bc(1.0)), **kw)
    for o, r in zip(out, ref):
        assert_close(o.numpy(), r, rel=1e-12)
