"""Two soft discs driven together by a Taylor-Green vortex (Jain et al.
2019 Sec. 4.6): the core of ``benchmarks/two_disc_tg_collision.py::run``,
with its file under ``out_root`` (``common.OUTPUTS``).

Two discs (R = 0.12 at y = 0.35 and 0.65 on x = 0.5; mu_s = 0.5) in the
vortex of amplitude U0 between free-slip walls (mu_f = 0.02, equal
densities: the constant-density projection); the repulsion (k_rep,
w_c = 2 cells, the two-solid clamp 4) keeps them apart and they rebound.
A divergence ends the run and is reported, not raised."""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc
from pyrmt_tpu_torch.diagnostics import disc_centroid
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

COLLISION_R = 0.12
COLLISION_DISCS = (Disc(0.5, 0.35, COLLISION_R),
                   Disc(0.5, 0.65, COLLISION_R))


def collision_config(N, k_rep=3.0):
    """The driver's configuration."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=0.5, kappa=0.0, rho_s=1.0,
        eta_s=0.0, mu_f=0.02, rho_f=1.0, w_t_cells=2.0, w_c_cells=2.0,
        k_rep=k_rep, two_solid_clamp=4.0, num_layers=3, CFL=0.2,
        dt_min_cap=1e-3)


def two_disc_tg_collision(N=128, t_end=2.0, U0=0.12, k_rep=3.0,
                          out_root=None, dtype=torch.float32, log_every=50,
                          verbose=False, cfg_overrides=None, *,
                          device="cuda", **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, logging after each
    chunk t, the two centroids' y (cya, cyb), the ``gap`` cyb - cya and
    the least J (``common.advance``: of the last step that advanced);
    with ``out_root`` (None: no files) the rows go to ``centroids.csv`` in
    ``two_disc_tg_N{N}``. Returns (rows, summary): ``gmin``, ``minJ``,
    ``rebound`` (the least gap is not the last row's and the last row's
    exceeds it by 5e-3), ``no_passthrough`` (gmin > 0), ``diverged``,
    ``steps``, ``wall_s``, ``steps_per_s``. ``step_kw`` goes to
    ``make_step``."""
    cfg = collision_config(N, k_rep)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    dtype = torch_dtype(dtype)
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, free_slip_box_bc, COLLISION_DISCS, **kw, **step_kw)
    u0, v0 = vortex_state_velocity(cfg, U0, free_slip_box_bc, **kw)
    state = make_init_state(cfg, COLLISION_DISCS, u0=u0, v0=v0, **kw)
    X, Y = cfg.grid.coords(**kw)
    log = EnergyLogger()
    nsteps = 0
    was_diverged = False
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, _ = advance(step, state, t_end, log_every)
        nsteps += log_every
        _, cya = disc_centroid(aux["phis"][0], X, Y)
        _, cyb = disc_centroid(aux["phis"][1], X, Y)
        stats = torch.stack([cya, cyb, torch.amin(aux["J"]),
                             state.t.to(cya.dtype)])
        cya, cyb, minJ, t = map(float, stats.cpu().numpy())
        log.log(t=t, cya=cya, cyb=cyb, gap=cyb - cya, minJ=minJ)
        say(verbose, "tg-contact", step=nsteps, **log.rows[-1])
        if bool(diverged(state)):
            was_diverged = True
            break
    wall = time.perf_counter() - wall
    out_dir = output_dir("two_disc_tg_collision", out_root, N=N)
    if out_dir is not None:
        log.to_csv(os.path.join(out_dir, "centroids.csv"))
    hist = log.array("t", "cya", "cyb", "gap", "minJ")
    gmin = float(hist[:, 3].min())
    imin = int(hist[:, 3].argmin())
    rebound = imin < len(hist) - 1 and bool(hist[-1, 3] > gmin + 5e-3)
    return log.rows, dict(gmin=gmin, minJ=float(hist[:, 4].min()),
                          rebound=rebound, no_passthrough=gmin > 0,
                          diverged=was_diverged, **timing(nsteps, wall))
