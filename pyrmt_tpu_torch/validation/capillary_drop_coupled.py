"""The coupled moving capillary drop: the core of
``benchmarks/capillary_drop_coupled.py::run``, with its files under
``out_root`` (``common.OUTPUTS``).

An elliptic near-fluid drop (mu_s = mu_f = 1e-3, gamma = 0.1, area-equal
to the disc of R = 0.2: semi-axes R ecc and R / ecc) rings toward a
circle under surface tension through the whole RMT loop, between
free-slip walls. The n = 2 period from the aspect's successive maxima and
minima is held to Rayleigh's inviscid 2D period T = 2 pi sqrt(R^3 /
(3 gamma)) (1.026 at the defaults; the driver's record 1.087 at N=128
with the balanced CSF and kappa*). After the ringing the residual speed
is the coupled loop's parasitic current: it must plateau (a bounded
capillary number), not grow; the drop's area drift stays at the
interface's resolution. The ellipse runs on the fused tier
(``rmt_block``'s ellipse instantiation on the card); the overrides
``phi_area_fix`` (``--areafix``), ``reinit_method='fmm'`` (``--reinit``)
and ``map_rebase_minj`` (``--rebase[=thr]``) take the split tier."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger
from pyrmt_tpu_torch.ops.levelset import Ellipse
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    Checkpoint,
    advance,
    output_dir,
    say,
    stop_time,
    timing,
    torch_dtype,
)


def capillary_config(N, gamma=0.1, mu_s=1e-3, mu_f=1e-3,
                     st_method="balanced", kappa_interface=False):
    """The driver's configuration."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=mu_s, kappa=0.0, rho_s=1.0,
        eta_s=0.0, mu_f=mu_f, rho_f=1.0, gamma=gamma, w_t_cells=2.0,
        st_method=st_method, st_kappa_interface=kappa_interface,
        scheme="semilagrangian", bc_type="neumann", num_layers=3, CFL=0.4,
        dt_min_cap=1e-3)


def drop_stats(cfg, state, aux, X, Y):
    """t, the signed x/y aspect sqrt(Ixx / Iyy) of the solid fraction, its
    area, max |u| and the least J: a 0-d tensor each, stacked."""
    g = cfg.grid
    w = 1.0 - smoothed_heaviside(aux["phis"][0], cfg.w_t)
    wsum = torch.sum(w)
    xc, yc = torch.sum(w * X) / wsum, torch.sum(w * Y) / wsum
    ixx = torch.sum(w * (X - xc) ** 2) / wsum
    iyy = torch.sum(w * (Y - yc) ** 2) / wsum
    ty = state.t.dtype
    return torch.stack([state.t, torch.sqrt(ixx / iyy).to(ty),
                        (wsum * g.dx * g.dy).to(ty),
                        torch.amax(torch.hypot(state.u, state.v)).to(ty),
                        torch.amin(aux["J"]).to(ty)])


def oscillation_summary(rows, t_rayleigh, mu_f, gamma):
    """The driver's summary of the logged rows: the mean interval between
    successive aspect maxima (> 1.005) and minima (< 0.995), the envelope
    ratio of the last maximum's amplitude to the first's, the area drift,
    the largest speed over the last 20 % of the run and its capillary
    number."""
    a_s, t_s = rows[:, 1], rows[:, 0]
    peaks = [i for i in range(1, len(a_s) - 1)
             if a_s[i] >= a_s[i - 1] and a_s[i] > a_s[i + 1]
             and a_s[i] > 1.005]
    troughs = [i for i in range(1, len(a_s) - 1)
               if a_s[i] <= a_s[i - 1] and a_s[i] < a_s[i + 1]
               and a_s[i] < 0.995]
    intervals = []
    for fam in (peaks, troughs):
        if len(fam) >= 2:
            intervals.extend(np.diff(t_s[fam]).tolist())
    period = float(np.mean(intervals)) if intervals else np.nan
    envelope = np.nan
    if len(peaks) >= 2:
        envelope = float((a_s[peaks[-1]] - 1.0) / (a_s[peaks[0]] - 1.0))
    area0 = float(rows[0, 2])
    tail = rows[t_s >= 0.8 * t_s[-1]]
    u_tail = float(np.max(tail[:, 3])) if len(tail) else float("nan")
    return dict(
        period=period, period_rayleigh=t_rayleigh,
        period_rel_err=(abs(period - t_rayleigh) / t_rayleigh
                        if period == period else float("nan")),
        area_drift=float(np.max(np.abs(rows[:, 2] - area0)) / area0),
        umax_tail=u_tail, ca_tail=u_tail * mu_f / gamma,
        envelope_ratio=envelope, aspect_final=float(a_s[-1]))


def capillary_suffix(st_method="balanced", kappa_interface=False, tag=""):
    """The JAX driver's directory suffix of a run's options and tag."""
    suffix = "" if st_method == "balanced" else f"_{st_method}"
    if kappa_interface:
        suffix += "_kstar"
    return suffix + (f"_{tag}" if tag else "")


def capillary_drop_coupled(N=128, gamma=0.1, R=0.2, ecc=1.15, mu_s=1e-3,
                           mu_f=1e-3, t_end=4.5, out_root=None,
                           dtype=torch.float32, log_every=100,
                           st_method="balanced", kappa_interface=False,
                           verbose=False, cfg_overrides=None, tag="",
                           resume=False, ckpt_every=10, max_chunks=None, *,
                           device="cuda", ckpt_dir=None, **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, logging after each
    chunk t, the ``aspect``, the ``area``, ``umax``, the least J
    (``common.advance``: of the last step that advanced) and the chunk's
    rebase events (``aux['rebased']``, counted on the
    device; 0 without rebasing). With ``out_root`` (None: no files) the
    run's directory is the JAX driver's ``capillary_drop_N{N}`` and
    ``capillary_suffix`` under it (``ckpt_dir``, the port's older keyword,
    names it too; ValueError where the two differ): the state
    (``checkpoint.npz``, ``io.save_checkpoint``) and the rows
    (``oscillation.csv``) go there every ``ckpt_every`` chunks and at
    ``max_chunks`` (an interruption), the rows again at the end, and
    ``resume`` continues from them. Returns (rows, summary): ``stable``,
    ``period`` against ``period_rayleigh`` (``period_rel_err``),
    ``area_drift``,
    ``umax_tail``, ``ca_tail``, ``envelope_ratio``, ``rebases``,
    ``aspect_final``, ``steps`` (the logged rows' chunks), ``wall_s``,
    ``steps_per_s`` (this call's). ``step_kw`` goes to ``make_step``."""
    dtype = torch_dtype(dtype)
    cfg = capillary_config(N, gamma, mu_s, mu_f, st_method, kappa_interface)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    kw = dict(dtype=dtype, device=device)
    drop = Ellipse(0.5, 0.5, R * ecc, R / ecc)
    step = make_step(cfg, free_slip_box_bc, (drop,), **kw, **step_kw)
    ckpt = Checkpoint(output_dir(
        "capillary_drop_coupled", out_root, ckpt_dir, N=N,
        suffix=capillary_suffix(st_method, kappa_interface, tag)),
        "oscillation.csv")
    saved = ckpt.load(**kw) if resume else None
    if saved is not None:
        state, log, _ = saved
    else:
        state, log = make_init_state(cfg, (drop,), **kw), EnergyLogger()
    X, Y = cfg.grid.coords(**kw)
    t_rayleigh = 2.0 * np.pi * np.sqrt(R**3 / (3.0 * gamma))
    rebasing = cfg.map_rebase_minj > 0.0

    def count(nreb, s, aux, active):
        return nreb + torch.sum(aux["rebased"].to(torch.int32))
    nsteps = len(log.rows) * log_every
    n_chunks = 0
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, nreb = advance(
            step, state, t_end, log_every, count if rebasing else None,
            torch.zeros((), dtype=torch.int32, device=device))
        nsteps += log_every
        n_chunks += 1
        stats = torch.cat([drop_stats(cfg, state, aux, X, Y),
                           nreb.to(state.t.dtype)[None]])
        t, aspect, area, umax, minJ, nreb = map(float, stats.cpu().numpy())
        log.log(t=t, aspect=aspect, area=area, umax=umax, minJ=minJ,
                rebases=nreb)
        say(verbose, "capillary-drop", step=nsteps, **log.rows[-1])
        if n_chunks % ckpt_every == 0:
            ckpt.save(state, log)
        if bool(diverged(state)):
            break
        if max_chunks is not None and n_chunks >= max_chunks:
            ckpt.save(state, log)
            break
    wall = time.perf_counter() - wall
    ckpt.save_rows(log)
    rows = log.array("t", "aspect", "area", "umax")
    summary = dict(stable=not bool(diverged(state)),
                   **oscillation_summary(rows, t_rayleigh, mu_f, gamma),
                   rebases=float(sum(r.get("rebases", 0.0)
                                     for r in log.rows)),
                   **timing(nsteps, wall))
    summary["steps_per_s"] = n_chunks * log_every / wall if wall else 0.0
    return log.rows, summary
