"""The spatial convergence study of the soft disc in a Taylor-Green vortex
(Jain et al. 2019, Fig. 15): the core of
``benchmarks/convergence_taylor_green.py::run``, with its error table and
its per-grid field cache under ``out_root`` (``common.OUTPUTS``).

Runs at a fixed dt on the grids ``grids`` and a finer reference grid
``N_ref``; the L2 errors of |u|, p (means removed) and X1 (on the solid)
against the reference sampled bilinearly at each grid's nodes, and of the
kinetic and strain energies; the observed orders (the slopes of
log error over log dx) and the reference-free Richardson orders of the
energies from grid triplets. benchmarks/README.md's protocol runs float64
(its recorded orders belong to another grid set)."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from pyrmt_tpu_torch.bcs import free_slip_box_bc
from pyrmt_tpu_torch.diagnostics import (
    compute_kinetic_energy,
    compute_strain_energy,
)
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.sim import RMTConfig, make_init_state, make_step
from pyrmt_tpu_torch.validation.common import (
    CACHE,
    dtype_name,
    l2,
    output_dir,
    richardson_order,
    sample_ref_on,
    save_table,
    say,
    timing,
    torch_dtype,
    vortex_state_velocity,
)

ORDER_NAMES = ("|u|", "p", "X1", "ke", "se")


def simulate_tg(N, scheme="semilagrangian", t_end=0.25, dt=1.0e-4,
                stress_band=False, dtype=torch.float32, num_layers=3,
                sl_interp="bilinear", sl_band_guard=3.0, *, device="cuda",
                **step_kw):
    """The disc in the vortex to ``t_end`` with a truly fixed dt
    (``fixed_dt``: the adaptive viscous limit would otherwise bind below
    it at large N), round(t_end / dt) steps counted exactly. Returns the
    JAX driver's dict: ``N``, ``dx``, the final fields as numpy arrays
    (``X``, ``Y``, ``a``, ``b``, ``p``, ``X1``, ``X2``, ``phi``) and the
    energies ``ke`` and ``se``."""
    dtype = torch_dtype(dtype)
    g = Grid(N, N, 1.0, 1.0)
    disc = Disc(0.5, 0.5, 0.2)
    cfg = RMTConfig(
        grid=g, mu_s=1.0, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1.0e-3,
        rho_f=1.0, w_t_cells=2.0, scheme=scheme, stress_band=stress_band,
        num_layers=num_layers, CFL=0.2, sl_interp=sl_interp,
        sl_band_guard=sl_band_guard, fixed_dt=dt)
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, free_slip_box_bc, (disc,), **kw, **step_kw)
    u0, v0 = vortex_state_velocity(cfg, 0.05, free_slip_box_bc, **kw)
    state = make_init_state(cfg, (disc,), u0=u0, v0=v0, **kw)
    t_never = 1e9  # never clip: the steps are counted
    for _ in range(int(round(t_end / dt))):
        state, aux = step(state, t_never)
    phi = aux["phis"][0]
    ke = float(compute_kinetic_energy(state.u, state.v, cfg.rho_f,
                                      cfg.rho_s, phi, cfg.w_t, g.dx, g.dy))
    se = float(compute_strain_energy(state.X1[0], state.X2[0], phi,
                                     cfg.mu_s, g.dx, g.dy, kappa=cfg.kappa))
    X, Y = g.coords(**kw)
    fields = dict(X=X, Y=Y, a=state.u, b=state.v, p=state.p, X1=state.X1[0],
                  X2=state.X2[0], phi=phi)
    return dict(N=N, dx=g.dx, **{k: v.cpu().numpy()
                                 for k, v in fields.items()}, ke=ke, se=se)


def convergence_tag(scheme="semilagrangian", stress_band=False,
                    num_layers=3, sl_interp="bilinear", sl_band_guard=3.0):
    """The JAX driver's directory name of a study
    (``benchmarks/convergence_taylor_green.py:120-128``)."""
    return (f"convergence_tg_{scheme}" + ("_band" if stress_band else "")
            + (f"_L{num_layers}" if num_layers != 3 else "")
            + (f"_{sl_interp}" if sl_interp != "bilinear" else "")
            + ("_raw" if sl_interp != "bilinear" and sl_band_guard <= 0.0
               else ""))


def convergence_taylor_green(scheme="semilagrangian", grids=(32, 64, 128),
                             N_ref=256, t_end=0.25, dt=1.0e-4,
                             stress_band=False, dtype=torch.float32,
                             out_root=None, verbose=False, cache=False,
                             num_layers=3, sl_interp="bilinear",
                             sl_band_guard=3.0, *, device="cuda", **step_kw):
    """``simulate_tg`` on each grid and the reference. With ``out_root``
    (None: no files), in ``convergence_tag``'s directory: ``errors.csv``
    (the JAX driver's table: dx and the five errors a grid) and, with
    ``cache``, each grid's fields as ``sol_N{N}_{dtype}_t{t_end}_dt{dt}
    .npz`` (the JAX driver's keys, its scalars 0-d arrays), which a later
    run with ``cache`` reads instead of running that grid: a cache of
    either package loads in the other. Returns (rows, summary): a row per
    grid (``N``, ``dx`` and the errors ``E_v``, ``E_p``, ``E_X1``,
    ``E_ke``, ``E_se``); ``orders`` ({name: the observed order against
    the reference}, the JAX driver's result), ``richardson`` ({'ke'|'se':
    [(N, order)]}), ``ke`` and ``se`` ({N: energy}), ``steps`` (those
    run: a cached grid runs none), ``wall_s``, ``steps_per_s``.
    ``step_kw`` goes to ``make_step``."""
    if cache and out_root is None:
        raise ValueError("cache=True keeps the fields under out_root")
    dtype = torch_dtype(dtype)
    out_dir = output_dir("convergence_taylor_green", out_root,
                         tag=convergence_tag(scheme, stress_band, num_layers,
                                             sl_interp, sl_band_guard))
    sols, steps = {}, 0
    wall = time.perf_counter()
    for N in list(grids) + [N_ref]:
        cpath = None if out_dir is None else os.path.join(
            out_dir, CACHE.format(N=N, dtype=dtype_name(dtype), t_end=t_end,
                                  dt=dt))
        if cache and os.path.exists(cpath):
            with np.load(cpath) as z:
                sols[N] = {k: (z[k] if z[k].ndim else z[k].item())
                           for k in z.files}
            say(verbose, "convergence-TG", N=N, cached=cpath)
            continue
        sols[N] = simulate_tg(N, scheme, t_end, dt, stress_band, dtype,
                              num_layers, sl_interp, sl_band_guard,
                              device=device, **step_kw)
        steps += int(round(t_end / dt))
        say(verbose, "convergence-TG", N=N, ke=sols[N]["ke"],
            se=sols[N]["se"])
        if cache:
            np.savez_compressed(cpath, **sols[N])
    wall = time.perf_counter() - wall
    ref = sols[N_ref]
    rows = []
    for N in grids:
        c = sols[N]
        umag_c = np.hypot(c["a"], c["b"])
        umag_r = np.hypot(sample_ref_on(c, ref, "a"),
                          sample_ref_on(c, ref, "b"))
        p_r = sample_ref_on(c, ref, "p")
        p_r -= p_r.mean()
        pc = c["p"] - c["p"].mean()
        X1_r = sample_ref_on(c, ref, "X1")
        rows.append(dict(N=N, dx=c["dx"], E_v=l2(umag_c - umag_r),
                         E_p=l2(pc - p_r),
                         E_X1=l2(c["X1"] - X1_r, mask=c["phi"] <= 0),
                         E_ke=abs(c["ke"] - ref["ke"]),
                         E_se=abs(c["se"] - ref["se"])))
    columns = ("dx", "E_v", "E_p", "E_X1", "E_ke", "E_se")
    errs = np.array([[r[k] for k in columns] for r in rows])
    if out_dir is not None:
        save_table(os.path.join(out_dir, "errors.csv"), errs, columns)
    orders = {}
    for k, name in enumerate(ORDER_NAMES):
        E = errs[:, k + 1]
        good = E > 0
        orders[name] = (float(np.polyfit(np.log(errs[good, 0]),
                                         np.log(E[good]), 1)[0])
                        if good.sum() > 1 else float("nan"))
    say(verbose, "convergence-TG", **orders)
    richardson = {name: richardson_order([(N, sols[N][name])
                                          for N in sorted(sols)])
                  for name in ("ke", "se")}
    return rows, dict(orders=orders, richardson=richardson,
                      ke={N: s["ke"] for N, s in sols.items()},
                      se={N: s["se"] for N, s in sols.items()},
                      **timing(steps, wall))
