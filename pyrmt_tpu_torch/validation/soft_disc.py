"""The soft disc in the lid-driven cavity (Jain et al. 2019 Sec. 4.5;
Sugiyama et al. 2011): the core of ``benchmarks/soft_disc_in_lid_driven.py
::run``, the flagship's own published validation, with its files under
``out_root`` (``common.OUTPUTS``).

A neo-Hookean disc (R = 0.2 at (0.6, 0.5); mu_s = 0.1, eta_s = 0.01)
carried by the cavity's flow (lid speed 1, mu_f = 0.01, equal densities,
no-slip walls, the Neumann projection): its centroid's track is held to
Sugiyama et al.'s 1024^2 track and Kolahduz's (data/Sugiyama_1024x1024.csv,
data/Kolahduz_2023.csv) by the mean distance of the centroid samples from
each published polyline. The driver's record is 0.0052 from Sugiyama's at
N=128 to t = 8 (benchmarks/README.md)."""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from pyrmt_tpu_torch.bcs import make_lid_bc
from pyrmt_tpu_torch.diagnostics import compute_kinetic_energy, disc_centroid
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import EnergyLogger, save_snapshot
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.sim import RMTConfig, diverged, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    DATA_DIR,
    SNAPSHOT,
    advance,
    load_xy_csv,
    mean_track_deviation,
    output_dir,
    save_table,
    say,
    stop_time,
    timing,
    torch_dtype,
)

SOFT_DISC = Disc(0.6, 0.5, 0.2)
TRACKS = {"Sugiyama2011": "Sugiyama_1024x1024.csv",
          "Kolahduz2023": "Kolahduz_2023.csv"}


def soft_disc_config(N, scheme="semilagrangian", reinit_method="none",
                     stress_band=False, detg_clamp=3.0):
    """The driver's configuration; the band-mode stress differentiates the
    outermost extrapolated ring and takes 4 layers (benchmarks/README.md)."""
    return RMTConfig(
        grid=Grid(N, N, 1.0, 1.0), mu_s=0.1, kappa=0.0, rho_s=1.0,
        eta_s=0.01, mu_f=0.01, rho_f=1.0, w_t_cells=2.0, scheme=scheme,
        bc_type="neumann", reinit_method=reinit_method,
        stress_band=stress_band, detg_clamp=detg_clamp,
        num_layers=4 if stress_band else 3, CFL=0.2, dt_min_cap=1e-3)


def soft_disc_in_lid_driven(N=128, scheme="semilagrangian", t_end=8.0,
                            reinit_method="none", out_root=None,
                            stress_band=False, detg_clamp=3.0,
                            dtype=torch.float32, log_every=100,
                            snapshot_times=None, verbose=False,
                            cfg_overrides=None, *, device="cuda", **step_kw):
    """Run to ``t_end`` in chunks of ``log_every`` steps, logging after each
    chunk t, the centroid (cx, cy) of the solid cells, the kinetic energy
    and the least and largest J (``common.advance``: of the last step that
    advanced). With ``out_root`` (None: no files), the JAX driver's files
    in ``soft_disc_lid_N{N}_{scheme}``: ``centroid.csv`` (t, cx, cy, minJ,
    maxJ) and, after the chunk that first reaches each of the
    ``snapshot_times``, ``snap_t{target:05.2f}.h5`` (``io.save_snapshot``:
    ``.npz`` without h5py) with the fields phi, X1, X2, a, b, p, J and the
    stresses of that step and the attributes t and t_target. Returns (rows,
    summary): ``x_extent`` (the orbit's x-extent; grid-converged ~0.70),
    ``deviations`` ({track: mean distance from the published track}),
    ``track_x_extent`` (each track's), ``stable``, ``steps``, ``wall_s``,
    ``steps_per_s``. ``step_kw`` goes to ``make_step``."""
    dtype = torch_dtype(dtype)
    cfg = soft_disc_config(N, scheme, reinit_method, stress_band, detg_clamp)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    g = cfg.grid
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, make_lid_bc(1.0), (SOFT_DISC,), **kw, **step_kw)
    state = make_init_state(cfg, (SOFT_DISC,), **kw)
    X, Y = g.coords(**kw)
    out_dir = output_dir("soft_disc_in_lid_driven", out_root, N=N,
                         scheme=scheme)
    targets = sorted(snapshot_times or ())
    log = EnergyLogger()
    nsteps = 0
    wall = time.perf_counter()
    while float(state.t) < stop_time(t_end, dtype):
        state, aux, _ = advance(step, state, t_end, log_every)
        nsteps += log_every
        phi = aux["phis"][0]
        cx, cy = disc_centroid(phi, X, Y)
        ke = compute_kinetic_energy(state.u, state.v, cfg.rho_f, cfg.rho_s,
                                    phi, cfg.w_t, g.dx, g.dy)
        stats = torch.stack([cx, cy, ke, torch.amin(aux["J"]),
                             torch.amax(aux["J"]), state.t.to(ke.dtype)])
        cx, cy, ke, minJ, maxJ, t = map(float, stats.cpu().numpy())
        log.log(t=t, cx=cx, cy=cy, ke=ke, minJ=minJ, maxJ=maxJ)
        say(verbose, "soft-disc-lid", step=nsteps, **log.rows[-1])
        # every target this chunk reached, the same fields under each
        while targets and t >= targets[0]:
            tt = targets.pop(0)
            if out_dir is not None:
                save_snapshot(
                    os.path.join(out_dir, SNAPSHOT.format(t=tt)),
                    {"phi": phi, "X1": state.X1[0], "X2": state.X2[0],
                     "a": state.u, "b": state.v, "p": state.p,
                     "J": aux["J"][0], "sigma_xx": aux["sxx"][0],
                     "sigma_xy": aux["sxy"][0], "sigma_yy": aux["syy"][0]},
                    attrs={"t": t, "t_target": tt})
        if bool(diverged(state)):
            break
    wall = time.perf_counter() - wall

    traj = log.array("t", "cx", "cy", "minJ", "maxJ")
    if out_dir is not None:
        save_table(os.path.join(out_dir, "centroid.csv"), traj,
                   ("t", "cx", "cy", "minJ", "maxJ"))
    x_extent = float(traj[:, 1].max() - traj[:, 1].min())
    devs, extents = {}, {}
    for name, fn in TRACKS.items():
        rx, ry = load_xy_csv(DATA_DIR / fn)
        extents[name] = float(rx.max() - rx.min())
        devs[name] = mean_track_deviation(traj[:, 1], traj[:, 2], rx, ry)
    summary = dict(x_extent=x_extent, deviations=devs,
                   track_x_extent=extents, stable=not bool(diverged(state)),
                   **timing(nsteps, wall))
    say(verbose, "soft-disc-lid", x_extent=x_extent, **devs,
        steps=nsteps, wall_s=wall)
    return log.rows, summary
