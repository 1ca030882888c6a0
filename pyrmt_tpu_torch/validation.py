"""The JAX package's validation gates, as functions of the port (the cores
of ``benchmarks/periodic_taylor_green.py::run``,
``benchmarks/lid_driven_cavity.py::run``,
``benchmarks/surface_tension_drop.py::run`` and
``benchmarks/density_contrast_disc.py::run``, without their file output).

``taylor_green_decay``: the Taylor-Green vortex on the doubly-periodic unit
box, an exact Navier-Stokes solution whose kinetic energy decays at
16 pi^2 nu. ``lid_driven_cavity``: the pure-fluid cavity run to steady
state, its centreline u(y) against Ghia et al. (1982). ``laplace_drop``: a
static drop held by surface tension, whose pressure jump must approach
Laplace's gamma / R. ``density_contrast``: a disc ten times as dense as
the fluid sinking under gravity through the variable-density CG
projection. They run on the card unless ``device='cpu'``; their gates
(tests/test_validation_gates.py) are ``rate_rel_err < 1e-2``,
``profile_rel_err < 5e-3``, ``maxdiv < 1e-6`` and ``stable`` for the
first at N=65 float64 to t = 0.5, an RMS below 5e-3 for the second at
Re = 100, N=65 float64, a relative error below 1.5e-2 for the cell CSF
and a smaller one for the balanced CSF with kappa* for the third at N=48
float64 (1200 steps), and for the last at N=48 float64 to t = 0.25 a
sinking disc (``vc_final < 0``), ``cg_iters_max < 100`` and
``max_div_rel < 0.2``.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc, make_lid_bc, periodic_bc
from pyrmt_tpu_torch.diagnostics import (
    divergence_2d_interior,
    extract_centerlines,
)
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger
from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_fused
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.ops.poisson import (
    compute_divergence_periodic,
    precompute_dct_matrices,
    precompute_poisson_eigenvalues,
)
from pyrmt_tpu_torch.ops.projection import pressure_projection
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside
from pyrmt_tpu_torch.physics import balanced_csf_forces, external_forces
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step


def taylor_green_config(N, nu=0.01):
    """The periodic Taylor-Green configuration of
    ``benchmarks/periodic_taylor_green.py`` with no solid."""
    return RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=0.0, rho_s=1.0,
                     mu_f=nu, rho_f=1.0, bc_type="periodic",
                     scheme="semilagrangian", num_layers=3, CFL=0.3,
                     dt_min_cap=1e-3)


def taylor_green_velocity(cfg, U0=0.5, dtype=torch.float64, device="cuda"):
    """u = U0 sin(2 pi x) cos(2 pi y), v = -U0 cos(2 pi x) sin(2 pi y)."""
    X, Y = cfg.grid.coords(dtype=dtype, device=device)
    return (U0 * torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y),
            -U0 * torch.cos(2 * math.pi * X) * torch.sin(2 * math.pi * Y))


def taylor_green_decay(N=65, nu=0.01, U0=0.5, t_end=0.5,
                       dtype=torch.float64, device="cuda", log_every=100,
                       **step_kw):
    """Run the decaying vortex to ``t_end``, logging t, the kinetic energy
    and the largest periodic divergence every ``log_every`` steps. Returns
    (rows, summary): ``stable``, the fitted decay ``rate`` against
    ``rate_exact`` and their ``rate_rel_err``, ``profile_rel_err`` (the
    final u against the exact one, relative to its amplitude), ``maxdiv``,
    ``steps`` (log_every per chunk, as the JAX package's benchmark counts
    them) and ``wall_s``. ``step_kw`` goes to ``make_step``."""
    cfg = taylor_green_config(N, nu)
    g = cfg.grid
    u0, v0 = taylor_green_velocity(cfg, U0, dtype, device)
    step = make_step(cfg, periodic_bc, (), dtype=dtype, device=device,
                     **step_kw)
    state = make_init_state(cfg, (), u0=u0, v0=v0, dtype=dtype,
                            device=device)
    rate_exact = 16.0 * np.pi**2 * nu
    log = EnergyLogger()
    nsteps = 0
    wall = time.perf_counter()
    while float(state.t) < t_end:
        for _ in range(log_every):
            state, _ = step(state, t_end)
        nsteps += log_every
        ke = 0.5 * torch.sum(state.u**2 + state.v**2) * g.dx * g.dy
        div = compute_divergence_periodic(state.u, state.v, g.dx, g.dy)
        log.log(t=float(state.t), ke=float(ke),
                maxdiv=float(torch.max(torch.abs(div))))
        if bool(diverged(state)):
            break
    wall = time.perf_counter() - wall

    rows = log.array("t", "ke", "maxdiv")
    rate = float(np.polyfit(rows[:, 0], np.log(rows[:, 1]), 1)[0])
    t_f = float(state.t)
    X, Y = g.coords(dtype=dtype, device="cpu")
    amp = U0 * np.exp(-8 * np.pi**2 * nu * t_f)
    ua = (U0 * np.sin(2 * np.pi * X.numpy()) * np.cos(2 * np.pi * Y.numpy())
          * np.exp(-8 * np.pi**2 * nu * t_f))
    summary = dict(
        stable=not bool(diverged(state)), rate=rate, rate_exact=-rate_exact,
        rate_rel_err=abs(rate + rate_exact) / rate_exact,
        profile_rel_err=float(np.max(np.abs(state.u.cpu().numpy() - ua))
                              / amp),
        maxdiv=float(np.max(rows[:, 2])), steps=nsteps, wall_s=wall)
    return log.rows, summary


def lid_cavity_config(N, Re=100.0):
    """The pure-fluid lid-driven cavity of
    ``benchmarks/lid_driven_cavity.py``: lid speed 1, mu_f = 1/Re."""
    return RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_f=1.0 / Re, rho_f=1.0,
                     CFL=0.2, dt_min_cap=1e-2, bc_type="neumann")


def lid_cavity_state(cfg, dtype=torch.float64, device="cuda"):
    """make_init_state with no solid, the lid BC applied to the velocity."""
    state = make_init_state(cfg, (), dtype=dtype, device=device)
    u0, v0 = make_lid_bc(1.0)(state.u, state.v)
    return dataclasses.replace(state, u=u0, v=v0)


def lid_driven_cavity(Re=100.0, N=65, max_steps=60000, steady_tol=2e-5,
                      chunk=200, dtype=torch.float64, device="cuda",
                      ghia_csv=None, **step_kw):
    """Run the pure-fluid cavity (lid speed 1, mu_f = 1/Re) until the
    steady residual max|u - u_prev| / (dt chunk) over a chunk of steps
    falls below ``steady_tol``. Returns a summary: ``steps``, ``t``,
    ``residual``, ``wall_s``, the centreline (``y``, ``u``) and, with
    ``ghia_csv`` (the y,u table of data/plot_u_y_Ghia<Re>.csv), ``rms``:
    the RMS of the centreline interpolated at Ghia's points against
    Ghia's u. ``step_kw`` goes to ``make_step``."""
    cfg = lid_cavity_config(N, Re)
    g = cfg.grid
    step = make_step(cfg, make_lid_bc(1.0), (), dtype=dtype, device=device,
                     **step_kw)
    state = lid_cavity_state(cfg, dtype, device)
    t_end = 1e9  # a steady-state run: dt is never clipped
    n, res = 0, math.inf
    wall = time.perf_counter()
    while n < max_steps:
        u_prev = state.u
        for _ in range(chunk):
            state, aux = step(state, t_end)
        n += chunk
        res = float(torch.max(torch.abs(state.u - u_prev))
                    / (aux["dt"] * chunk))
        if res < steady_tol:
            break
    wall = time.perf_counter() - wall
    X, Y = g.coords(dtype=dtype, device=device)
    y, u_line, _, _ = extract_centerlines(state.u, state.v, X, Y)
    y, u_line = y.cpu().numpy(), u_line.cpu().numpy()
    summary = dict(steps=n, t=float(state.t), residual=res, wall_s=wall,
                   steady=res < steady_tol, y=y, u=u_line)
    if ghia_csv is not None:
        data = np.loadtxt(ghia_csv, delimiter=",", skiprows=1)
        yg, ug = data[:, 0], data[:, 1]
        summary["rms"] = float(np.sqrt(np.mean(
            (np.interp(yg, y, u_line) - ug) ** 2)))
    return summary


def laplace_drop(N=48, gamma=0.1, R=0.25, n_steps=1200, st_method="csf",
                 kappa_interface=False, curvature="fd", hf_smooth=0,
                 dtype=torch.float64, device="cuda"):
    """The static drop of ``benchmarks/surface_tension_drop.py``: a disc of
    radius R at the centre of the free-slip unit box, held fixed (the
    identity map, mu_s = 0, phi frozen), equal densities, mu_f = 0.01,
    w_t = 2 dx, dt = half the capillary limit. Each step is the RK4
    momentum update (``kernels.momentum_rk4.momentum_rk4_fused``: the plain
    stage loop on a CPU state, the kernel on the card) with the surface
    tension force, then the Neumann projection: the cell CSF (fd
    curvature, as the driver's ``momentum_step_rk4``), or with
    ``st_method='balanced'`` the balanced CSF with ``kappa_interface``,
    ``curvature`` and ``hf_smooth``, its face forces to the projection.
    The pressure jump is the mean p over phi < -2 w_t less the mean over
    phi > 2 w_t, averaged over the last 50 steps. Returns a summary:
    ``dp``, ``target`` (gamma / R), ``rel_err``, ``max_u`` (the largest
    spurious speed after the last step), ``steps`` and ``wall_s``."""
    if gamma <= 0.0:
        raise ValueError("laplace_drop requires gamma > 0")
    kw = dict(dtype=dtype, device=device)
    g = Grid(N, N, 1.0, 1.0)
    dx, dy = g.dx, g.dy
    X, Y = g.coords(**kw)
    phi = Disc(0.5, 0.5, R)(X, Y)
    mu_f, rho_f, rho_s = 0.01, 1.0, 1.0
    w_t = 2.0 * dx
    target = gamma / R
    eig = precompute_poisson_eigenvalues(N, N, dx, dy, **kw)
    mats = precompute_dct_matrices(N, N, **kw)
    dt = torch.tensor(0.5 * np.sqrt(rho_f * dx**3 / (2.0 * np.pi * gamma)),
                      **kw)
    H = smoothed_heaviside(phi, w_t)
    rho_proj = (1 - H) * rho_s + H * rho_f   # the driver's projection rho
    rho_mom = H * rho_f + (1.0 - H) * rho_s  # the momentum's mixture
    zero = torch.zeros_like(phi)
    if st_method == "balanced":
        fx, fy, Fx, Fy = balanced_csf_forces(
            phi[None], H[None], dx, dy, gamma,
            kappa_interface=kappa_interface, curvature=curvature, w_t=w_t,
            hf_smooth=hf_smooth)
        st_faces = (Fx, Fy, fx, fy)
    else:
        fx, fy = external_forces(phi[None], H[None], dx, dy, gamma=gamma,
                                 k_rep=0.0, w_c=None, w_t=w_t)
        st_faces = None
    inside, outside = phi < -2.0 * w_t, phi > 2.0 * w_t
    n_in, n_out = inside.sum(), outside.sum()
    u, v, p = zero, zero, zero
    dp_sum = torch.zeros((), **kw)
    wall = time.perf_counter()
    for n in range(1, n_steps + 1):
        u_star, v_star = momentum_rk4_fused(
            u, v, p, zero, zero, zero, H, rho_mom, zero, free_slip_box_bc,
            eta_s=0.0, dx=dx, dy=dy, dt=dt, mu_f=mu_f, f_ext_x=fx,
            f_ext_y=fy)
        u, v, p = pressure_projection(u_star, v_star, dx, dy, dt, rho_proj,
                                      free_slip_box_bc, p, eig, mats,
                                      st_faces=st_faces)
        if n > n_steps - 50:
            dp_sum = dp_sum + (torch.where(inside, p, 0.0).sum() / n_in
                               - torch.where(outside, p, 0.0).sum() / n_out)
    dp = float(dp_sum) / min(50, n_steps)
    wall = time.perf_counter() - wall
    return dict(dp=dp, target=target, rel_err=abs(dp - target) / target,
                max_u=float(torch.hypot(u, v).max()), steps=n_steps,
                wall_s=wall)


def density_contrast_config(N, rho_ratio=10.0, g0=1.0):
    """``benchmarks/density_contrast_disc.py``'s configuration: a soft
    disc (mu_s = 1) of density ``rho_ratio`` in fluid of density 1 under
    gravity g0 downwards, free-slip walls, the CG projection (tolerance
    1e-6, at most 200 iterations)."""
    return RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=1.0, kappa=0.0,
                     rho_s=rho_ratio, eta_s=0.0, mu_f=1.0e-3, rho_f=1.0,
                     g_y=-g0, w_t_cells=2.0, scheme="semilagrangian",
                     bc_type="neumann", variable_rho=True, num_layers=3,
                     CFL=0.2, dt_min_cap=1e-3, cg_tol=1e-6, cg_maxiter=200)


DENSITY_DISC = Disc(0.5, 0.7, 0.15)


def density_contrast(N=48, rho_ratio=10.0, t_end=0.25, g0=1.0,
                     dtype=torch.float64, device="cuda", log_every=50,
                     **step_kw):
    """Release the heavy disc at rest and run to ``t_end`` in chunks of
    ``log_every`` steps, logging after each chunk the time, the solid's
    centroid and mean vertical velocity (weights 1 - H), the least J,
    the largest CG iteration count and the mean of the chunk, the last
    step's CG residual, and the interior central divergence over
    max|u| / dx. Returns (rows, summary): ``accel_early`` (the slope of the
    solid's velocity over t in [0.02, 0.12]) against ``accel_added_mass``
    -g0 (ratio - 1) / (ratio + 1), ``yc_final``, ``vc_final``,
    ``descent_monotone``, ``cg_iters_mean``, ``cg_iters_max``,
    ``max_div_rel`` (over the chunks from 0.4 t of the last), ``minJ``,
    ``steps``, ``wall_s``, ``steps_per_s``. ``step_kw`` goes to
    ``make_step``."""
    kw = dict(dtype=dtype, device=device)
    cfg = density_contrast_config(N, rho_ratio, g0)
    g = cfg.grid
    step = make_step(cfg, free_slip_box_bc, (DENSITY_DISC,), **kw, **step_kw)
    state = make_init_state(cfg, (DENSITY_DISC,), **kw)
    X, Y = g.coords(**kw)
    log = EnergyLogger()
    nsteps = 0
    wall = time.perf_counter()
    while float(state.t) < t_end:
        state, aux = step(state, t_end)
        it_max, it_sum = aux["cg_iters"], aux["cg_iters"]
        for _ in range(log_every - 1):
            state, aux = step(state, t_end)
            it_max = torch.maximum(it_max, aux["cg_iters"])
            it_sum = it_sum + aux["cg_iters"]
        nsteps += log_every
        w = 1.0 - smoothed_heaviside(aux["phis"][0], cfg.w_t)
        wsum = torch.sum(w)
        _, div_i = divergence_2d_interior(state.u, state.v, g.dx, g.dy)
        umax = torch.amax(torch.hypot(state.u, state.v))
        div_rel = torch.amax(torch.abs(div_i)) / torch.clamp(
            umax / g.dx, min=1e-12)
        stats = torch.stack([
            state.t.double(), (torch.sum(w * X) / wsum).double(),
            (torch.sum(w * Y) / wsum).double(),
            (torch.sum(w * state.v) / wsum).double(),
            torch.amin(aux["J"]).double(), div_rel.double(),
            it_max.double(), it_sum.double() / log_every,
            aux["cg_relres"].double()]).cpu().numpy()
        t, xc, yc, vc, minJ, div, itmax, itmean, relres = map(float, stats)
        log.log(t=t, xc=xc, yc=yc, vc=vc, minJ=minJ, max_div_rel=div,
                cg_iters_max=itmax, cg_iters_mean=itmean, cg_relres=relres)
        if bool(diverged(state)):
            break
    wall = time.perf_counter() - wall

    rows = log.array("t", "yc", "vc", "cg_iters_mean", "cg_iters_max",
                     "max_div_rel", "minJ")
    m = (rows[:, 0] >= 0.02) & (rows[:, 0] <= 0.12)
    accel = float(np.polyfit(rows[m, 0], rows[m, 2], 1)[0]) \
        if m.sum() >= 2 else float("nan")
    a_theory = -g0 * (rho_ratio - 1.0) / (rho_ratio + 1.0)
    summary = dict(
        accel_early=accel, accel_added_mass=a_theory,
        accel_rel_err=abs(accel - a_theory) / abs(a_theory),
        yc_final=float(rows[-1, 1]), vc_final=float(rows[-1, 2]),
        descent_monotone=bool(np.all(np.diff(rows[:, 1]) < 0)),
        cg_iters_mean=float(np.mean(rows[:, 3])),
        cg_iters_max=float(np.max(rows[:, 4])),
        max_div_rel=float(np.max(rows[rows[:, 0] >= 0.4 * rows[-1, 0], 5])),
        minJ=float(np.min(rows[:, 6])),
        steps=nsteps, wall_s=wall, steps_per_s=nsteps / wall)
    return log.rows, summary
