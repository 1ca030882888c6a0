"""The port's doubly-periodic stack against the JAX package's.

Each function gets the same float64 inputs, made from a numpy seed, in both
packages: the overlap-grid wrap stencils and ``wrap_pad`` to 1e-13, the
FFT solve's eigenvalues to 1e-13 and the solve itself to 1e-11, the
periodic divergence and gradient to 1e-13 of the field's size, the
periodic projection branch, the RHS and the RK4 update with the periodic
stencils to 1e-12, the seam checks exactly. Then 3 float64 steps at N=64
of the ``bench.py --periodic`` configuration (the flagship disc on the
doubly-periodic box, seeded with a Taylor-Green vortex) and of the same on
the split tier (area fix), the JAX step on its XLA paths with jit disabled
(op by op: seconds, where compiling it takes tens of seconds): u, v, X1, X2
to 1e-12, p to 1e-11, t to 1e-15.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as jbcs
import pyrmt_tpu.ops.fd as jfd
import pyrmt_tpu.ops.levelset as jls
import pyrmt_tpu.ops.poisson as jpo
import pyrmt_tpu.ops.projection as jproj
import pyrmt_tpu.physics as jphys
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.ops.fd as tfd
import pyrmt_tpu_torch.ops.poisson as tpo
import pyrmt_tpu_torch.ops.projection as tproj
import pyrmt_tpu_torch.physics as tphys
import pyrmt_tpu_torch.sim as tsim
from __graft_entry__ import _flagship
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "phis0": 1e-12,
        "p": 1e-11, "t": 1e-15, "step": 0}


def fields(shape, n, seed=0):
    """n seeded smooth-plus-noise float64 fields of ``shape``,
    overlap-consistent (the last row and column repeat the first)."""
    rng = np.random.default_rng(seed)
    Ny, Nx = shape
    x = np.linspace(0.0, 1.0, Nx)
    y = np.linspace(0.0, 1.0, Ny)
    X, Y = np.meshgrid(x, y)
    out = []
    for _ in range(n):
        a, b, c = rng.standard_normal(3)
        f = (a * np.sin(2 * np.pi * X + c) * np.cos(4 * np.pi * Y)
             + b * np.cos(2 * np.pi * Y)
             + 0.1 * rng.standard_normal(shape))
        f[:, -1] = f[:, 0]
        f[-1, :] = f[0, :]
        out.append(f)
    return out


def both(a):
    return jnp.asarray(a), torch.tensor(a)


def close(t, j, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol, err_msg=what)


SHAPES = [(33, 33), (17, 24), (9, 7)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", [
    "wrap_pad_x1", "wrap_pad_x2", "wrap_pad_y1", "wrap_pad_y2",
    "grad_x", "grad_y", "upwind_x", "upwind_y"])
def test_periodic_stencils_match_jax(name, shape):
    f, u = fields(shape, 2)
    (jf, tf), (ju, tu) = both(f), both(u)
    h = 0.037
    if name.startswith("wrap_pad"):
        k = int(name[-1])
        fn = name[:-1]
        ref = getattr(jfd, fn)(jf, k)
        out = getattr(tfd, fn)(tf, k)
    elif name.startswith("grad"):
        fn = f"grad_central_{name[-1]}_2nd_periodic"
        ref = getattr(jfd, fn)(jf, h)
        out = getattr(tfd, fn)(tf, h)
    else:
        axis = 1 if name.endswith("x") else 0
        ref = jfd.diff_upwind_3rd_periodic(jf, ju, h, axis)
        out = tfd.diff_upwind_3rd_periodic(tf, tu, h, axis)
    assert tuple(out.shape) == ref.shape
    close(out, ref, 1e-13 * max(1.0, float(jnp.abs(ref).max())), name)


@pytest.mark.parametrize("shape", SHAPES)
def test_periodic_bc_and_tile_overlap_match_jax(shape):
    u, v = fields(shape, 2, seed=1)
    u[0, -1] += 1.0  # the corner copy's order shows
    ju, jv = jbcs.periodic_bc(jnp.asarray(u), jnp.asarray(v))
    tu, tv = pt.periodic_bc(torch.tensor(u), torch.tensor(v))
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert pt.periodic_bc.kernel_spec == jbcs.periodic_bc.kernel_spec
    red = u[:-1, :-1]
    Ny, Nx = shape
    assert np.array_equal(tpo.tile_overlap(torch.tensor(red), Ny, Nx).numpy(),
                          np.asarray(jpo.tile_overlap(jnp.asarray(red), Ny,
                                                      Nx)))


@pytest.mark.parametrize("shape", SHAPES + [(65, 65)])
def test_fft_solve_matches_jax(shape):
    Ny, Nx = shape
    dx, dy = 1.0 / (Nx - 1), 1.0 / (Ny - 1)
    jeig = jpo.precompute_poisson_eigenvalues_periodic(Nx, Ny, dx, dy,
                                                       dtype=jnp.float64)
    teig = tpo.precompute_poisson_eigenvalues_periodic(
        Nx, Ny, dx, dy, dtype=torch.float64, device=DEV)
    close(teig[0], jeig[0], 1e-13 * float(jnp.abs(jeig[0]).max()), "eig")
    assert np.array_equal(teig[1].numpy(), np.asarray(jeig[1]))
    (rhs,) = fields(shape, 1, seed=2)
    rhs = 1e3 * rhs
    ref = jpo.solve_poisson_fft(jnp.asarray(rhs), jeig)
    out = tpo.solve_poisson_fft(torch.tensor(rhs), teig)
    close(out, ref, 1e-11, "p")
    # float32 takes complex64, as jnp.fft does
    out32 = tpo.solve_poisson_fft(
        torch.tensor(rhs, dtype=torch.float32),
        tpo.precompute_poisson_eigenvalues_periodic(
            Nx, Ny, dx, dy, dtype=torch.float32, device=DEV))
    assert out32.dtype == torch.float32
    close(out32, ref, 1e-4 * float(jnp.abs(ref).max()), "p float32")


@pytest.mark.parametrize("shape", SHAPES)
def test_periodic_divergence_and_gradient_match_jax(shape):
    a, b = fields(shape, 2, seed=3)
    dx, dy = 0.031, 0.027
    ref = jpo.compute_divergence_periodic(jnp.asarray(a), jnp.asarray(b),
                                          dx, dy)
    out = tpo.compute_divergence_periodic(torch.tensor(a), torch.tensor(b),
                                          dx, dy)
    close(out, ref, 1e-13 * float(jnp.abs(ref).max()), "div")
    for o, r, k in zip(tpo.compute_pressure_gradient_periodic(
            torch.tensor(a), dx, dy),
            jpo.compute_pressure_gradient_periodic(jnp.asarray(a), dx, dy),
            ("dpdx", "dpdy")):
        close(o, r, 1e-13 * float(jnp.abs(r).max()), k)


@pytest.mark.parametrize("shape", [(33, 33), (17, 24)])
def test_periodic_projection_matches_jax(shape):
    Ny, Nx = shape
    dx, dy = 1.0 / (Nx - 1), 1.0 / (Ny - 1)
    a, b, p, r = fields(shape, 4, seed=4)
    rho = 1.0 + 0.2 * (r - r.min()) / np.ptp(r)
    dt = 2e-3
    jeig = jpo.precompute_poisson_eigenvalues_periodic(Nx, Ny, dx, dy,
                                                       dtype=jnp.float64)
    teig = tpo.precompute_poisson_eigenvalues_periodic(
        Nx, Ny, dx, dy, dtype=torch.float64, device=DEV)
    ref = jproj.pressure_projection(
        jnp.asarray(a), jnp.asarray(b), dx, dy, dt, jnp.asarray(rho),
        jbcs.periodic_bc, p_prev=jnp.asarray(p), eigenvalues=jeig,
        bc_type="periodic")
    args = (torch.tensor(a), torch.tensor(b), dx, dy,
            torch.tensor(dt, dtype=torch.float64), torch.tensor(rho),
            pt.periodic_bc, torch.tensor(p), teig)
    out = tproj.pressure_projection(*args, bc_type="periodic")
    for o, r_, k in zip(out, ref, ("a", "b", "p")):
        close(o, r_, (1e-11 if k == "p" else 1e-12), k)
    # the stencil pair is the Neumann branch's: the periodic one ignores it
    kern = tproj.pressure_projection(
        *args, stencils=(pt.rc_rhs_fused, pt.grad_correct_fused),
        bc_type="periodic")
    for o, k in zip(kern, out):
        assert torch.equal(o, k)
    with pytest.raises(ValueError):
        tproj.pressure_projection(*args, bc_type="bogus")


def momentum_fields(shape, seed=5):
    """The RK4 operands on the periodic box, overlap-consistent: velocity,
    pressure, solid stresses, Hf in [0, 1], rho in [1, 1.3], the
    Kelvin-Voigt mask and a force."""
    u, v, p, sxx, sxy, syy, h, mkv, fx, fy = fields(shape, 10, seed)
    scale = 0.5 / max(np.abs(u).max(), np.abs(v).max())
    Hf = (h - h.min()) / np.ptp(h)
    rho = 1.0 + 0.3 * (1.0 - Hf)
    return (u * scale, v * scale, 0.05 * p, 0.1 * sxx, 0.1 * sxy, 0.1 * syy,
            Hf, rho, np.abs(mkv) / np.abs(mkv).max(), 0.01 * fx, 0.01 * fy)


@pytest.mark.parametrize("force", [False, True], ids=["free", "force"])
@pytest.mark.parametrize("shape", [(33, 33), (17, 24)])
def test_periodic_rhs_matches_jax(shape, force):
    u, v, p, sxx, sxy, syy, Hf, rho, _, fx, fy = momentum_fields(shape)
    dx, dy, mu_f = 1.0 / (shape[1] - 1), 1.0 / (shape[0] - 1), 0.01
    if not force:
        fx = fy = np.zeros(shape)
    j = [jnp.asarray(a) for a in (u, v, p, sxx, sxy, syy)]
    ref = jphys.velocity_rhs_blended(*j, dx, dy, mu_f, jnp.asarray(Hf),
                                     jnp.asarray(rho), jnp.asarray(fx),
                                     jnp.asarray(fy), periodic=True)
    t = [torch.tensor(a) for a in (u, v, p, sxx, sxy, syy)]
    kw = (dict(f_ext_x=torch.tensor(fx), f_ext_y=torch.tensor(fy))
          if force else {})
    out = tphys.velocity_rhs_blended(*t, dx, dy, mu_f, torch.tensor(Hf),
                                     torch.tensor(rho), periodic=True, **kw)
    for o, r, k in zip(out, ref, ("rhs_u", "rhs_v")):
        close(o, r, 1e-12 * max(1.0, float(jnp.abs(r).max())), k)


@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("force", [False, True], ids=["free", "force"])
def test_periodic_rk4_matches_jax(force, eta_s):
    shape = (33, 33)
    u, v, p, sxx, sxy, syy, Hf, rho, mkv, fx, fy = momentum_fields(shape, 6)
    dx = dy = 1.0 / 32
    dt, mu_f = 1e-3, 0.01
    if not force:
        fx = fy = np.zeros(shape)
    jargs = [jnp.asarray(a) for a in (u, v, p, sxx, sxy, syy, Hf, rho)]
    ref = jphys.momentum_core(*jargs, jnp.asarray(fx), jnp.asarray(fy),
                              jnp.asarray(mkv), jbcs.periodic_bc,
                              eta_s=eta_s, dx=dx, dy=dy, dt=dt, mu_f=mu_f,
                              periodic=True)
    targs = [torch.tensor(a) for a in (u, v, p, sxx, sxy, syy, Hf, rho, mkv)]
    kw = (dict(f_ext_x=torch.tensor(fx), f_ext_y=torch.tensor(fy))
          if force else {})
    out = tphys.momentum_core(*targs, pt.periodic_bc, eta_s=eta_s, dx=dx,
                              dy=dy, dt=torch.tensor(dt, dtype=torch.float64),
                              mu_f=mu_f, periodic=True, **kw)
    # the wrapper pre-applies the BC; on overlap-consistent inputs that
    # leaves the update as it is
    from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_fused

    wrapped = momentum_rk4_fused(*targs, pt.periodic_bc, eta_s=eta_s, dx=dx,
                                 dy=dy,
                                 dt=torch.tensor(dt, dtype=torch.float64),
                                 mu_f=mu_f, periodic=True, **kw)
    for o, w, r, k in zip(out, wrapped, ref, ("u", "v")):
        close(o, r, 1e-12, k)
        assert torch.equal(o, w), k
    with pytest.raises(ValueError):  # the flag and the BC disagree
        momentum_rk4_fused(*targs, pt.make_lid_bc(1.0), eta_s=eta_s, dx=dx,
                           dy=dy, dt=torch.tensor(dt), mu_f=mu_f,
                           periodic=True)


def test_rk4_takes_the_plain_rhs_on_the_periodic_box():
    """The JAX package skips its one-RHS kernel under periodic BCs; so does
    the port's stage loop, whatever rhs_fn it is given."""
    u, v, p, sxx, sxy, syy, Hf, rho, mkv, _, _ = momentum_fields((17, 17))
    targs = [torch.tensor(a) for a in (u, v, p, sxx, sxy, syy, Hf, rho, mkv)]

    def refuse(*args, **kw):
        raise AssertionError("rhs_fn called on the periodic box")

    kw = dict(eta_s=0.0, dx=1 / 16, dy=1 / 16, dt=torch.tensor(1e-3),
              mu_f=0.01, periodic=True)
    a = tphys.momentum_core(*targs, pt.periodic_bc, rhs_fn=refuse, **kw)
    b = tphys.momentum_core(*targs, pt.periodic_bc, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_apply_phi_bcs_matches_jax():
    (phi,) = fields((20, 23), 1, seed=7)
    ref = jls.apply_phi_BCs(jnp.asarray(phi))
    out = pt.apply_phi_BCs(torch.tensor(phi))
    assert np.array_equal(out.numpy(), np.asarray(ref))


def _seam_cfgs(**kw):
    jg = jsim.RMTConfig(
        grid=jax_grid(64), mu_s=0.05, mu_f=0.01, bc_type="periodic",
        CFL=0.2, dt_min_cap=1e-3, **kw)
    return jg, port_config(jg)


def jax_grid(N):
    from pyrmt_tpu.grid import Grid as JGrid

    return JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)


def j_disc(x0, y0, R):
    return lambda X, Y: jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R


@pytest.mark.parametrize("kw", [{}, dict(sl_interp="bicubic"),
                                dict(num_layers=5, w_t_cells=2.5)])
def test_seam_clearance_matches_jax(kw):
    jcfg, tcfg = _seam_cfgs(**kw)
    assert (tsim.periodic_seam_clearance_cells(tcfg)
            == jsim.periodic_seam_clearance_cells(jcfg))


@pytest.mark.parametrize("disc", [(0.08, 0.5, 0.07), (0.5, 0.93, 0.05),
                                  (0.5, 0.5, 0.2)],
                         ids=["left_seam", "top_seam", "clear"])
def test_seam_check_raises_as_in_jax(disc):
    """A disc on the seam raises the same ValueError in both packages at
    make_init_state; a disc clear of it starts."""
    jcfg, tcfg = _seam_cfgs()
    on_seam = disc[0] != 0.5 or disc[1] != 0.5
    if on_seam:
        with pytest.raises(ValueError, match="periodic seam"):
            jsim.make_init_state(jcfg, (j_disc(*disc),), dtype=jnp.float64)
        with pytest.raises(ValueError, match="periodic seam"):
            pt.make_init_state(tcfg, (pt.Disc(*disc),), dtype=torch.float64,
                               device=DEV)
    else:
        with jax.disable_jit():  # op by op: compiling takes ~20 s
            jsim.make_init_state(jcfg, (j_disc(*disc),), dtype=jnp.float64)
        pt.make_init_state(tcfg, (pt.Disc(*disc),), dtype=torch.float64,
                           device=DEV)


def test_seam_predicate_matches_jax():
    jcfg, tcfg = _seam_cfgs()
    k = tsim.periodic_seam_clearance_cells(tcfg)
    dx = tcfg.grid.dx
    X, Y = tcfg.grid.coords(dtype=torch.float64, device=DEV)
    jX, jY = jcfg.grid.coords(dtype=jnp.float64)
    for disc in ((0.5, 0.5, 0.2), (k * dx + 0.03, 0.5, 0.06),
                 (0.5, 1.0 - k * dx - 0.03, 0.06)):
        t = pt.Disc(*disc)(X, Y)[None]
        j = j_disc(*disc)(jX, jY)[None]
        assert (bool(tsim.solid_near_periodic_seam(t, k))
                == bool(jsim.solid_near_periodic_seam(j, k)))


def jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def periodic_flagship(N, **overrides):
    """``bench.py --periodic``: the flagship on the doubly-periodic box, on
    the JAX package's XLA paths, with its Taylor-Green seed."""
    jcfg, _, jphis = _flagship(N, jnp.float64)
    jcfg = dataclasses.replace(
        jcfg, bc_type="periodic", rmt_method="xla", momentum_method="xla",
        extrap_method="xla", dct_method="fft", **overrides)
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    u0 = 0.5 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v0 = -0.5 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    return jcfg, jphis, u0, v0


@pytest.fixture(scope="module", params=["fused", "split"])
def periodic_runs(request):
    """3 float64 steps at N=64 of the periodic flagship in both packages
    (the split tier: with the area fix, which reaches advext_block)."""
    extra = {} if request.param == "fused" else dict(phi_area_fix=True)
    jcfg, jphis, u0, v0 = periodic_flagship(64, **extra)
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, jbcs.periodic_bc, jphis,
                               dtype=jnp.float64)
        js = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0,
                                  dtype=jnp.float64)
        tcfg = port_config(jcfg)
        disc = (pt.Disc(0.6, 0.5, 0.2),)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        tstep = pt.make_step(tcfg, pt.periodic_bc, disc, dtype=torch.float64,
                             device=DEV)
        traj = []
        for _ in range(3):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            traj.append((jax_numpy(js), state_to_numpy(ts),
                         np.asarray(jaux["J"]), taux["J"].numpy()))
    return request.param, traj


@pytest.mark.parametrize("n", range(3))
def test_periodic_flagship_step_matches_jax(periodic_runs, n):
    tier, traj = periodic_runs
    js, ts, jJ, tJ = traj[n]
    for k, atol in ATOL.items():
        close(ts[k], js[k], atol, f"{tier} step {n + 1}: {k}")
    close(tJ, jJ, 1e-12, f"{tier} step {n + 1}: J")
    assert float(np.abs(ts["u"]).max()) > 0.1  # the vortex moves


def test_periodic_split_step_reaches_advext_block_plain(monkeypatch):
    """On a CPU state the split tier's advect-extrapolate block is the
    plain version, under periodic BCs as under walls."""
    from pyrmt_tpu_torch.kernels import rmt_block as rb

    calls = []
    plain = rb.advext_block_plain

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(rb, "advext_block_plain", spy)
    jcfg, _, u0, v0 = periodic_flagship(32, phi_area_fix=True)
    tcfg = port_config(jcfg)
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    step = pt.make_step(tcfg, pt.periodic_bc, disc, dtype=torch.float64,
                        device=DEV)
    s = pt.make_init_state(tcfg, disc, u0=torch.tensor(np.asarray(u0)),
                           v0=torch.tensor(np.asarray(v0)),
                           dtype=torch.float64, device=DEV)
    s, aux = step(s, 1.0)
    assert calls == [1]
    assert not bool(tsim.solid_near_periodic_seam(
        aux["phis"], tsim.periodic_seam_clearance_cells(tcfg)))
