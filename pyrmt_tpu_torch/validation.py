"""The JAX package's two solid-free validation gates, as functions of the
port (the cores of ``benchmarks/periodic_taylor_green.py::run`` and
``benchmarks/lid_driven_cavity.py::run``, without their file output).

``taylor_green_decay``: the Taylor-Green vortex on the doubly-periodic unit
box, an exact Navier-Stokes solution whose kinetic energy decays at
16 pi^2 nu. ``lid_driven_cavity``: the pure-fluid cavity run to steady
state, its centreline u(y) against Ghia et al. (1982). Both run through
``make_step`` with no solid, on the card unless ``device='cpu'``; their
gates (tests/test_validation_gates.py) are ``rate_rel_err < 1e-2``,
``profile_rel_err < 5e-3``, ``maxdiv < 1e-6`` and ``stable`` for the
first at N=65 float64 to t = 0.5, an RMS below 5e-3 for the second at
Re = 100, N=65 float64.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from pyrmt_tpu_torch.bcs import make_lid_bc, periodic_bc
from pyrmt_tpu_torch.diagnostics import extract_centerlines
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger
from pyrmt_tpu_torch.ops.poisson import compute_divergence_periodic
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
