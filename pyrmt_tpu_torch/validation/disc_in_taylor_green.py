"""A soft disc in a Taylor-Green vortex (Jain et al. 2019, Sec. 4.4): the
core of ``benchmarks/disc_in_taylor_green.py::run``, with its file under
``out_root`` (``common.OUTPUTS``).

A neo-Hookean disc (R = 0.2 at the centre, mu_s = 1) in the vortex of
amplitude 0.05 between free-slip walls (mu_f = 1e-3, equal densities):
the flow stretches the disc and elasticity pulls it back. The kinetic and
strain energies and the viscous dissipation, integrated over every step,
are logged; the total energy's drift over t in [0, 1] is the result (the
JAX driver's, float64 at N=128: -2.96 %)."""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc
from pyrmt_tpu_torch.diagnostics import (
    compute_kinetic_energy,
    compute_strain_energy,
    compute_viscous_dissipation,
)
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    advance,
    output_dir,
    say,
    stop_time,
    timing,
    torch_dtype,
    vortex_state_velocity,
)

TG_DISC = Disc(0.5, 0.5, 0.2)


def disc_tg_config(N, scheme="semilagrangian", stress_band=False,
                   reinit_method="none"):
    """The driver's configuration."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=1.0, kappa=0.0, rho_s=1.0,
        eta_s=0.0, mu_f=1.0e-3, rho_f=1.0, w_t_cells=2.0, scheme=scheme,
        bc_type="neumann", reinit_method=reinit_method,
        stress_band=stress_band, num_layers=3, CFL=0.2, dt_min_cap=1e-4)


def solid_radius_y(phi, Y):
    """Half the solid's extent in y (NaN without a solid cell)."""
    solid = phi <= 0.0
    top = torch.amax(torch.where(solid, Y, -torch.inf))
    bottom = torch.amin(torch.where(solid, Y, torch.inf))
    return torch.where(torch.any(solid), 0.5 * (top - bottom),
                       torch.full_like(top, float("nan")))


def disc_in_taylor_green(N=128, scheme="semilagrangian", t_end=1.0,
                         out_root=None, stress_band=False,
                         reinit_method="none", dtype=torch.float32,
                         log_every=50, verbose=False, cfg_overrides=None, *,
                         device="cuda", **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, integrating the
    dissipation over every step of a chunk on the device; after each chunk
    log t, the kinetic energy ``ke``, the strain energy ``se``, the
    ``dissipation``, its integral so far, ``total_energy`` = ke + se +
    the integral, ``radius_y`` and the least J (``common.advance``: of
    the last step that advanced); with ``out_root`` (None: no files) the
    rows go to ``energy_history.csv`` in ``disc_tg_N{N}_{scheme}``.
    Returns (rows,
    summary): ``drift`` (the total energy's, in percent of the first
    row's), ``stable``, ``steps``, ``wall_s``, ``steps_per_s``.
    ``step_kw`` goes to ``make_step``."""
    dtype = torch_dtype(dtype)
    cfg = disc_tg_config(N, scheme, stress_band, reinit_method)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    g = cfg.grid
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, free_slip_box_bc, (TG_DISC,), **kw, **step_kw)
    u0, v0 = vortex_state_velocity(cfg, 0.05, free_slip_box_bc, **kw)
    state = make_init_state(cfg, (TG_DISC,), u0=u0, v0=v0, **kw)
    _, Y = g.coords(**kw)

    def dissipation(s, aux):
        return compute_viscous_dissipation(s.u, s.v, cfg.mu_f,
                                           aux["phis"][0], cfg.w_t, g.dx,
                                           g.dy, cfg.eta_s)

    def integrate(acc, s, aux, active):
        return acc + torch.where(active, dissipation(s, aux) * aux["dt"],
                                 0.0)

    log = EnergyLogger()
    integ = 0.0
    nsteps = 0
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, dint = advance(step, state, t_end, log_every, integrate,
                                   0.0)
        nsteps += log_every
        phi = aux["phis"][0]
        ke = compute_kinetic_energy(state.u, state.v, cfg.rho_f, cfg.rho_s,
                                    phi, cfg.w_t, g.dx, g.dy)
        se = compute_strain_energy(state.X1[0], state.X2[0], phi, cfg.mu_s,
                                   g.dx, g.dy, kappa=cfg.kappa)
        stats = torch.stack([ke, se, dissipation(state, aux), dint,
                             solid_radius_y(phi, Y), torch.amin(aux["J"]),
                             state.t.to(ke.dtype)])
        ke, se, diss, dint, ry, minJ, t = map(float, stats.cpu().numpy())
        integ += dint
        log.log(t=t, ke=ke, se=se, dissipation=diss,
                integrated_dissipation=integ, total_energy=ke + se + integ,
                radius_y=ry, minJ=minJ)
        say(verbose, "disc-in-TG", step=nsteps, **log.rows[-1])
        if bool(diverged(state)):
            break
    wall = time.perf_counter() - wall
    out_dir = output_dir("disc_in_taylor_green", out_root, N=N,
                         scheme=scheme)
    if out_dir is not None:
        log.to_csv(os.path.join(out_dir, "energy_history.csv"))
    rows = log.array("t", "ke", "se", "total_energy")
    drift = (rows[-1, 3] - rows[0, 3]) / max(abs(rows[0, 3]), 1e-30) * 100
    say(verbose, "disc-in-TG", drift=float(drift), steps=nsteps,
        wall_s=wall)
    return log.rows, dict(drift=float(drift),
                          stable=not bool(diverged(state)),
                          **timing(nsteps, wall))
