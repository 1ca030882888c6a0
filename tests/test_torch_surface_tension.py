"""The port's curvature estimators and surface-tension forces against
``pyrmt_tpu``.

``ops.levelset.{compute_curvature, sharp_solid_fraction,
compute_curvature_hf}``, ``physics.{_solid_curvature, external_forces,
balanced_csf_forces, body_forces}`` and ``ops.poisson.
compute_divergence_rc`` with the balanced CSF's face forces, each against
its JAX function on the same float64 inputs made from a numpy seed: level
sets of discs and an ellipse with noise of a tenth of a cell, one rotated
a quarter turn (the 45-degree orientation switch of the height function),
and a level set flat beyond a band (the far field the guards keep
finite). Tolerance: 1e-12 of the field's size; the ellipse level set
against the driver's ``make_ellipse_phi_init`` to 1e-15 of its size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.ops.levelset as jls
import pyrmt_tpu.ops.poisson as jp
import pyrmt_tpu.physics as jph
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.ops.levelset as tls
import pyrmt_tpu_torch.ops.poisson as tp
import pyrmt_tpu_torch.physics as tph
from benchmarks.capillary_drop_coupled import make_ellipse_phi_init
from pyrmt_tpu.ops.stress import smoothed_heaviside as j_heaviside
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside

torch.set_num_threads(1)

N = 48
DX = 1.0 / (N - 1)
W_T = 2.0 * DX
ELLIPSE = (0.5, 0.5, 0.23, 0.174)


def grid(n=N):
    x = np.arange(n) / (n - 1)
    return np.meshgrid(x, x)


def level_set(kind, seed=0, noise=0.1):
    """A float64 (N, N) level set: 'disc', 'ellipse', 'tilted' (an ellipse
    turned 45 degrees, so the preferred column orientation switches along
    it) or 'flat' (a disc's distance clamped at +-3 cells: zero gradient
    beyond); with seeded noise of ``noise`` cells."""
    rng = np.random.default_rng(seed)
    X, Y = grid()
    if kind == "disc":
        phi = np.hypot(X - 0.52, Y - 0.47) - 0.25
    elif kind == "ellipse":
        phi = np.asarray(make_ellipse_phi_init(*ELLIPSE)(
            jnp.asarray(X), jnp.asarray(Y)))
    elif kind == "tilted":
        c = np.sqrt(0.5)
        xr, yr = c * (X - 0.5) + c * (Y - 0.5), -c * (X - 0.5) + c * (Y - 0.5)
        phi = np.hypot(xr / 0.3, yr / 0.18) * 0.22 - 0.22
    else:
        phi = np.clip(np.hypot(X - 0.5, Y - 0.5) - 0.2, -3 * DX, 3 * DX)
    if noise:
        phi = phi + noise * DX * rng.standard_normal(phi.shape) * (
            np.abs(phi) < 3 * DX)
    return phi


KINDS = ("disc", "ellipse", "tilted", "flat")


def close(out, ref, rel=1e-12):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    size = max(float(np.abs(ref).max()), 1e-300)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * size)


@pytest.mark.parametrize("kind", KINDS)
def test_curvature_and_sharp_fraction_match_jax(kind):
    phi = level_set(kind)
    close(tls.compute_curvature(torch.tensor(phi), DX, DX),
          jls.compute_curvature(jnp.asarray(phi), DX, DX))
    close(tls.sharp_solid_fraction(torch.tensor(phi), DX, DX),
          jls.sharp_solid_fraction(jnp.asarray(phi), DX, DX))


@pytest.mark.parametrize("smooth", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_height_function_curvature_matches_jax(kind, smooth):
    phi = level_set(kind, seed=1)
    fb = np.random.default_rng(2).standard_normal(phi.shape)
    hh = max(3, int(np.ceil(np.sqrt(2.0) * W_T / DX)) + 2)
    ref = jls.compute_curvature_hf(jnp.asarray(phi), DX, DX, hh,
                                   jnp.asarray(fb), smooth=smooth)
    out = tls.compute_curvature_hf(torch.tensor(phi), DX, DX, hh,
                                   torch.tensor(fb), smooth=smooth)
    close(out, ref)
    if kind == "tilted":  # both orientations and the fallback are taken
        assert 0.0 < float(np.mean(np.asarray(ref) == fb)) < 1.0


def test_straight_interface_has_zero_height_function_curvature():
    """A straight interface at slope 0.3: the sharp fractions are exact, so
    the raw height-function curvature is 0 in the force band a column's
    reach from the domain's edge (tests/test_curvature.py's check of the
    JAX function); with and without smoothing the port equals the JAX
    function there and everywhere."""
    X, Y = grid()
    phi = (Y - 0.3 * X - 0.35) / np.sqrt(1.09)
    hh = 5
    inner = np.zeros(phi.shape, bool)
    inner[hh + 1:-hh - 1, hh + 1:-hh - 1] = True
    for smooth in (0, 2):
        out = tls.compute_curvature_hf(torch.tensor(phi), DX, DX, hh,
                                       torch.zeros(phi.shape),
                                       smooth=smooth).numpy()
        ref = jls.compute_curvature_hf(jnp.asarray(phi), DX, DX, hh,
                                       jnp.zeros(phi.shape), smooth=smooth)
        close(out, ref)
    band = (np.abs(phi) < W_T) & inner
    out = tls.compute_curvature_hf(torch.tensor(phi), DX, DX, hh,
                                   torch.zeros(phi.shape)).numpy()
    assert band.sum() > N and np.abs(out[band]).max() < 1e-9


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("curv,kstar,smooth", [
    ("fd", False, 0), ("fd", True, 0), ("hf", False, 0), ("hf", True, 2)])
def test_solid_curvature_matches_jax(kind, curv, kstar, smooth):
    phi = level_set(kind, seed=3)
    ref = jph._solid_curvature(jnp.asarray(phi), DX, DX, W_T, curv, kstar,
                               hf_smooth=smooth)
    out = tph._solid_curvature(torch.tensor(phi), DX, DX, W_T, curv, kstar,
                               hf_smooth=smooth)
    close(out, ref)


def stack(kinds, seed=4):
    phis = np.stack([level_set(k, seed=seed + i) for i, k in
                     enumerate(kinds)])
    return phis, np.asarray(j_heaviside(jnp.asarray(phis), W_T))


@pytest.mark.parametrize("kinds,k_rep", [(("disc",), 0.0),
                                         (("ellipse",), 0.0),
                                         (("disc", "tilted"), 2.0)])
@pytest.mark.parametrize("curv,kstar,smooth", [
    ("fd", False, 0), ("fd", True, 0), ("hf", True, 2)])
def test_csf_forces_match_jax(kinds, k_rep, curv, kstar, smooth):
    phis, H = stack(kinds)
    kw = dict(gamma=0.1, k_rep=k_rep, w_c=3 * DX, w_t=W_T, curvature=curv,
              kappa_interface=kstar, hf_smooth=smooth)
    ref = jph.external_forces(jnp.asarray(phis), jnp.asarray(H), DX, DX,
                              **kw)
    out = tph.external_forces(torch.tensor(phis), torch.tensor(H), DX, DX,
                              **kw)
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("kinds", [("disc",), ("ellipse",),
                                   ("disc", "tilted")])
@pytest.mark.parametrize("curv,kstar,smooth", [
    ("fd", False, 0), ("fd", True, 0), ("hf", False, 0), ("hf", True, 2)])
def test_balanced_csf_forces_match_jax(kinds, curv, kstar, smooth):
    phis, H = stack(kinds)
    kw = dict(kappa_interface=kstar, curvature=curv, w_t=W_T,
              hf_smooth=smooth)
    ref = jph.balanced_csf_forces(jnp.asarray(phis), jnp.asarray(H), DX, DX,
                                  0.1, **kw)
    out = tph.balanced_csf_forces(torch.tensor(phis), torch.tensor(H), DX,
                                  DX, 0.1, **kw)
    assert out[2].shape == (N, N - 1) and out[3].shape == (N - 1, N)
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("st_method", ["csf", "balanced"])
@pytest.mark.parametrize("gravity", [0.0, -1.0])
def test_body_forces_match_the_jax_step(st_method, gravity):
    """The step's force as JAX's fused branch assembles it (sim.py:926-950):
    the balanced CSF plus contact at gamma 0, or the CSF through
    external_forces, then the buoyancy; the face forces for the
    projection."""
    phis, H = stack(("disc", "tilted"))
    rho = 1.0 + 0.5 * (phis[0] < 0)
    kw = dict(k_rep=2.0, w_c=3 * DX, w_t=W_T)
    jphis = jnp.asarray(phis)
    if st_method == "balanced":
        fxc, fyc, Fx, Fy = jph.balanced_csf_forces(
            jphis, jnp.asarray(H), DX, DX, 0.1, kappa_interface=True,
            curvature="fd", w_t=W_T)
        cfx, cfy = jph.external_forces(jphis, jnp.asarray(H), DX, DX,
                                       gamma=0.0, **kw)
        fx, fy, faces = fxc + cfx, fyc + cfy, (Fx, Fy, fxc, fyc)
    else:
        fx, fy = jph.external_forces(jphis, jnp.asarray(H), DX, DX,
                                     gamma=0.1, kappa_interface=True, **kw)
        faces = None
    fx = fx + (rho - 1.0) * 0.0
    fy = fy + (rho - 1.0) * gravity
    out = tph.body_forces(torch.tensor(phis), torch.tensor(rho), DX, DX,
                          gamma=0.1, g_y=gravity, g_rho_ref=1.0,
                          st_method=st_method, st_kappa_interface=True,
                          with_faces=True, **kw)
    close(out[0], fx)
    close(out[1], fy)
    if faces is None:
        assert out[2] is None
    else:
        for o, r in zip(out[2], faces):
            close(o, r)


def test_divergence_with_face_forces_matches_jax():
    rng = np.random.default_rng(5)
    a, b, p = (rng.standard_normal((N, N)) for _ in range(3))
    phis, H = stack(("ellipse",))
    rho = 1.0 + 0.3 * rng.random((N, N))
    faces = jph.balanced_csf_forces(jnp.asarray(phis), jnp.asarray(H), DX,
                                    DX, 0.1, kappa_interface=True, w_t=W_T)
    j_faces = (faces[2], faces[3], faces[0], faces[1])
    t_faces = tuple(torch.tensor(np.asarray(f)) for f in j_faces)
    dt = 3e-4
    for var in (False, True):
        ref = jp.compute_divergence_rc(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(p), dt,
            jnp.asarray(rho), DX, DX, var, st_faces=j_faces)
        out = tp.compute_divergence_rc(
            torch.tensor(a), torch.tensor(b), torch.tensor(p),
            torch.tensor(dt, dtype=torch.float64), torch.tensor(rho), DX, DX,
            variable_rho=var,
            st_faces=t_faces)
        close(out, ref)


def test_ellipse_matches_the_drivers_level_set():
    rng = np.random.default_rng(6)
    X1 = rng.uniform(-0.2, 1.2, (N, N))
    X2 = rng.uniform(-0.2, 1.2, (N, N))
    X1[0, 0], X2[0, 0] = ELLIPSE[:2]  # the centre: r = 1e-15
    ref = make_ellipse_phi_init(*ELLIPSE)(jnp.asarray(X1), jnp.asarray(X2))
    ell = pt.Ellipse(*ELLIPSE)
    assert ell.kernel_spec == ("ellipse",) + ELLIPSE
    close(ell(torch.tensor(X1), torch.tensor(X2)), ref, rel=1e-15)


def test_balanced_csf_balances_a_face_constant_curvature():
    """The exact-balance case of tests/test_physics.py on the port: with a
    constant curvature override the equilibrium p = gamma kappa H + const
    leaves the velocity at roundoff after one projection (the balanced
    force's property), where the cell CSF leaves currents."""
    from pyrmt_tpu_torch.bcs import free_slip_box_bc
    from pyrmt_tpu_torch.ops.poisson import (
        precompute_dct_matrices,
        precompute_poisson_eigenvalues,
    )
    from pyrmt_tpu_torch.ops.projection import pressure_projection

    n, gamma, kap0 = 48, 0.1, 1.0 / 0.25
    dx = 1.0 / (n - 1)
    x = torch.arange(n, dtype=torch.float64) * dx
    Y, X = torch.meshgrid(x, x, indexing="ij")
    phi = torch.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.25
    H = smoothed_heaviside(phi, 2 * dx)[None]
    kappas = torch.full((1, n, n), kap0, dtype=torch.float64)
    fxc, fyc, Fx, Fy = tph.balanced_csf_forces(phi[None], H, dx, dx, gamma,
                                               kappas=kappas)
    p_eq = gamma * kap0 * H[0]
    p_eq = p_eq - p_eq.mean()
    dt = torch.tensor(1e-3, dtype=torch.float64)
    rho = torch.ones(n, n, dtype=torch.float64)
    # one explicit step of the force against the equilibrium pressure
    u_star = dt * (fxc - tp.compute_pressure_gradient(p_eq, dx, dx)[0])
    v_star = dt * (fyc - tp.compute_pressure_gradient(p_eq, dx, dx)[1])
    u_star, v_star = free_slip_box_bc(u_star, v_star)
    eig = precompute_poisson_eigenvalues(n, n, dx, dx, torch.float64, "cpu")
    mats = precompute_dct_matrices(n, n, torch.float64, "cpu")
    a, b, _ = pressure_projection(u_star, v_star, dx, dx, dt, rho,
                                  free_slip_box_bc, p_eq, eig, dct_mats=mats,
                                  st_faces=(Fx, Fy, fxc, fyc))
    assert float(torch.hypot(a, b).max()) < 1e-12
    a_c, b_c, _ = pressure_projection(u_star, v_star, dx, dx, dt, rho,
                                      free_slip_box_bc, p_eq, eig,
                                      dct_mats=mats)
    assert float(torch.hypot(a_c, b_c).max()) > 1e-6
