"""Two soft discs colliding head-on (Jain et al. 2019 Sec. 3.6 and 4.6):
the core of ``benchmarks/two_disc_contact.py::run`` with its file under
``out_root`` (``common.OUTPUTS``).

Two neo-Hookean discs (R = 0.15 at x = 0.3 and 0.7) approach at V0 each
in a free-slip box; the short-range repulsion (k_rep, w_c = 3 cells, the
two-solid clamp 4) keeps them apart and they rebound. The centres' gap
falls to a positive least value (no pass-through) and grows again. The
JAX package's gate (tests/test_validation_gates.py) at N=48 float64 to
t = 0.6: least gap above 2R, 0.5 < min J < 1; the published run at N=64
to t = 1.5 has min J 0.685 (0.6725 upstream)."""
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
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    advance,
    output_dir,
    say,
    stop_time,
    timing,
    torch_dtype,
)

CONTACT_R = 0.15
CONTACT_DISCS = (Disc(0.30, 0.50, CONTACT_R), Disc(0.70, 0.50, CONTACT_R))


def contact_config(N, k_rep=2.0):
    """The driver's configuration."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=1.0, kappa=0.0, rho_s=1.0,
        eta_s=0.0, mu_f=0.01, rho_f=1.0, w_t_cells=2.0, w_c_cells=3.0,
        k_rep=k_rep, two_solid_clamp=4.0, num_layers=3, CFL=0.2,
        dt_min_cap=1e-3)


def two_disc_contact(N=128, t_end=2.0, V0=0.15, k_rep=2.0, out_root=None,
                     dtype=torch.float32, log_every=50, verbose=False,
                     cfg_overrides=None, *, device="cuda", **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, logging after each
    chunk t, the two centroids' x (cxa, cxb), the ``gap`` cxb - cxa and the
    least J over every step of the chunk that advanced; with ``out_root``
    (None: no files) the rows go to ``centroids.csv`` in
    ``two_disc_contact_N{N}``. Returns (rows, summary): ``gmin`` (the
    least gap), ``minJ``, ``rebound`` (the gap's least value is not the
    last row's and the last row's exceeds it by 1e-3), ``no_passthrough``
    (gmin > 0), ``stable``, ``steps``, ``wall_s``, ``steps_per_s``.
    ``step_kw`` goes to ``make_step``."""
    cfg = contact_config(N, k_rep)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    dtype = torch_dtype(dtype)
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, free_slip_box_bc, CONTACT_DISCS, **kw, **step_kw)
    X, Y = cfg.grid.coords(**kw)
    Ha, Hb = (smoothed_heaviside(d(X, Y), cfg.w_t) for d in CONTACT_DISCS)
    u0, v0 = free_slip_box_bc(V0 * (1 - Ha) - V0 * (1 - Hb),
                              torch.zeros_like(X))
    state = make_init_state(cfg, CONTACT_DISCS, u0=u0, v0=v0, **kw)
    def least(jmin, s, aux, active):
        return torch.minimum(jmin, torch.where(active, torch.amin(aux["J"]),
                                               torch.inf))

    log = EnergyLogger()
    nsteps = 0
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, jmin = advance(step, state, t_end, log_every, least,
                                   torch.full((), torch.inf, **kw))
        nsteps += log_every
        cxa, _ = disc_centroid(aux["phis"][0], X, Y)
        cxb, _ = disc_centroid(aux["phis"][1], X, Y)
        stats = torch.stack([cxa, cxb, jmin, state.t.to(cxa.dtype)])
        cxa, cxb, jmin, t = map(float, stats.cpu().numpy())
        log.log(t=t, cxa=cxa, cxb=cxb, gap=cxb - cxa, minJ=jmin)
        say(verbose, "contact", step=nsteps, **log.rows[-1])
        if bool(diverged(state)):
            break
    wall = time.perf_counter() - wall
    out_dir = output_dir("two_disc_contact", out_root, N=N)
    if out_dir is not None:
        log.to_csv(os.path.join(out_dir, "centroids.csv"))
    hist = log.array("t", "cxa", "cxb", "gap", "minJ")
    gmin = float(hist[:, 3].min())
    approached = int(hist[:, 3].argmin()) < len(hist) - 1
    rebounded = bool(hist[-1, 3] > gmin + 1e-3)
    return log.rows, dict(gmin=gmin, minJ=float(hist[:, 4].min()),
                          rebound=approached and rebounded,
                          no_passthrough=gmin > 0,
                          stable=not bool(diverged(state)),
                          **timing(nsteps, wall))
