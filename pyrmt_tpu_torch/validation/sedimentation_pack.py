"""Many-solid sedimentation: the core of
``benchmarks/sedimentation_pack.py::run``, with its files under
``out_root`` (``common.OUTPUTS``).

A staggered pack of S heavy discs (radius R, density ratio ``rho_ratio``)
released at rest in a closed free-slip box under gravity settles through
the variable-density CG projection, the S (S - 1) / 2 pairs' repulsive
contact keeping it impenetrable. The checks: no pass-through (the least
centre distance of any pair over the logged chunks above 2R - w_c: the
shells may compress into the bump's range, never through), a
monotonically falling mean height, every disc's area drift at interface
level, the CG's iterations bounded. The JAX package's gate
(tests/test_validation_gates.py) runs N=48, S=3, R=0.1 to t = 0.25 in
float64: stable, no pass-through, monotone, at most 99 CG iterations,
area drift below 5 %."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    Checkpoint,
    advance,
    output_dir,
    pack_positions,
    say,
    stop_time,
    timing,
    torch_dtype,
)


def sedimentation_config(N, rho_ratio=2.0, g0=1.0):
    """The driver's configuration."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=1.0, kappa=0.0, rho_s=rho_ratio,
        eta_s=0.0, mu_f=5e-3, rho_f=1.0, g_y=-g0, w_t_cells=2.0, k_rep=2.0,
        w_c_cells=3.0, scheme="semilagrangian", bc_type="neumann",
        variable_rho=True, num_layers=3, CFL=0.2, dt_min_cap=1e-3,
        cg_tol=1e-6, cg_maxiter=200)


def pack_stats(cfg, state, aux, it_max, X, Y):
    """t, the least pairwise centroid distance, the kinetic energy, the
    mean centroid height, the least J and the chunk's largest CG count,
    then each disc's centroid height and area: one stacked tensor."""
    g = cfg.grid
    S = aux["phis"].shape[0]
    w = 1.0 - smoothed_heaviside(aux["phis"], cfg.w_t)
    wsum = torch.sum(w, dim=(1, 2))
    xc = torch.sum(w * X, dim=(1, 2)) / wsum
    yc = torch.sum(w * Y, dim=(1, 2)) / wsum
    areas = wsum * g.dx * g.dy
    ke = 0.5 * torch.sum(state.u**2 + state.v**2) * g.dx * g.dy
    d2 = ((xc[:, None] - xc[None, :]) ** 2 + (yc[:, None] - yc[None, :]) ** 2
          + torch.eye(S, dtype=xc.dtype, device=xc.device) * 1e9)
    ty = state.t.dtype
    return torch.cat([
        torch.stack([state.t, torch.sqrt(torch.amin(d2)).to(ty), ke.to(ty),
                     torch.mean(yc).to(ty), torch.amin(aux["J"]).to(ty),
                     it_max.to(ty)]),
        yc.to(ty), areas.to(ty)])


def sedimentation_pack(N=256, S=10, R=0.06, rho_ratio=2.0, t_end=2.0,
                       g0=1.0, out_root=None, dtype=torch.float32,
                       log_every=50, verbose=False, cfg_overrides=None,
                       resume=False, ckpt_every=10, max_chunks=None, *,
                       device="cuda", ckpt_dir=None, **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, logging after each
    chunk t, ``dmin`` (the least pairwise centroid distance), ``ke``,
    ``ybar`` (the mean centroid height), the least J and the chunk's
    largest CG iteration count (of the steps that advanced,
    ``common.advance``) and the largest relative area change of a disc
    since the first chunk. With ``out_root`` (None: no files) the run's
    directory is the JAX driver's ``sedimentation_N{N}_S{S}`` under it
    (``ckpt_dir``, the port's older keyword, names it too; ValueError
    where the two differ): the first areas (``resume_meta.npz``) go there
    after the first chunk, the state (``checkpoint.npz``,
    ``io.save_checkpoint``) and the rows (``settling.csv``) every
    ``ckpt_every`` chunks and at ``max_chunks`` (an interruption), the
    rows again at the end, and ``resume`` continues from them. Returns
    (rows, summary):
    ``stable``, ``dmin`` against ``gap_floor`` (2R - w_c),
    ``no_passthrough``, ``ybar_final``, ``ybar_monotone`` (every chunk's
    rise below 1e-4), ``ke_final``, ``ke_peak``, ``minJ``,
    ``cg_iters_max``, ``area_drift``, ``steps`` (the logged rows' chunks),
    ``wall_s``, ``steps_per_s`` (this call's). ``step_kw`` goes to
    ``make_step``."""
    dtype = torch_dtype(dtype)
    cfg = sedimentation_config(N, rho_ratio, g0)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    kw = dict(dtype=dtype, device=device)
    discs = tuple(Disc(x, y, R) for x, y in pack_positions(S, R))
    step = make_step(cfg, free_slip_box_bc, discs, **kw, **step_kw)
    ckpt = Checkpoint(output_dir("sedimentation_pack", out_root, ckpt_dir,
                                 N=N, S=S), "settling.csv")
    saved = ckpt.load(**kw) if resume else None
    areas0 = None
    if saved is not None:
        state, log, extra = saved
        areas0 = extra.get("areas0")
    else:
        state, log = make_init_state(cfg, discs, **kw), EnergyLogger()
    X, Y = cfg.grid.coords(**kw)

    def most(it_max, s, aux, active):
        return torch.maximum(it_max, torch.where(active, aux["cg_iters"], 0))

    nsteps = len(log.rows) * log_every
    n_chunks = 0
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, it_max = advance(step, state, t_end, log_every, most,
                                     torch.zeros((), dtype=torch.int32,
                                                 device=device))
        nsteps += log_every
        n_chunks += 1
        arr = pack_stats(cfg, state, aux, it_max, X, Y).cpu().numpy()
        t, dmin, ke, ybar, minJ, itmax = map(float, arr[:6])
        areas = arr[6 + S:6 + 2 * S]
        if areas0 is None:
            areas0 = areas.copy()
            ckpt.save_meta(areas0=areas0)
        adrift = float(np.max(np.abs(areas / areas0 - 1.0)))
        log.log(t=t, dmin=dmin, ke=ke, ybar=ybar, minJ=minJ,
                cg_iters_max=itmax, area_drift=adrift)
        say(verbose, "sedimentation", step=nsteps, **log.rows[-1])
        if n_chunks % ckpt_every == 0:
            ckpt.save(state, log)
        if bool(diverged(state)):
            break
        if max_chunks is not None and n_chunks >= max_chunks:
            ckpt.save(state, log)
            break
    wall = time.perf_counter() - wall
    ckpt.save_rows(log)
    rows = log.array("t", "dmin", "ke", "ybar", "minJ", "cg_iters_max",
                     "area_drift")
    gap_floor = 2 * R - cfg.w_c
    summary = dict(
        stable=not bool(diverged(state)),
        dmin=float(np.min(rows[:, 1])), gap_floor=gap_floor,
        no_passthrough=bool(np.min(rows[:, 1]) > gap_floor),
        ybar_final=float(rows[-1, 3]),
        ybar_monotone=bool(np.all(np.diff(rows[:, 3]) < 1e-4)),
        ke_final=float(rows[-1, 2]), ke_peak=float(np.max(rows[:, 2])),
        minJ=float(np.min(rows[:, 4])),
        cg_iters_max=float(np.max(rows[:, 5])),
        area_drift=float(np.max(rows[:, 6])), **timing(nsteps, wall))
    summary["steps_per_s"] = n_chunks * log_every / wall if wall else 0.0
    return log.rows, summary
