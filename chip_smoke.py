#!/usr/bin/env python3
"""Smoke run of pyrmt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases:

  1. probe: torch and CUDA versions, nvcc, the card's name and power limit;
  2. build the five CUDA sources of pyrmt_tpu_torch/csrc side by side;
  3. each of the seven kernels against its plain PyTorch version on the
     same tensors on the card: float64 at N=256 (max-abs <= 1e-11), float32
     at N=256 and at the flagship's N=1024 (bounds below), the disc
     touching the domain's edge at N=256 (the solid-block kernels),
     grad_correct under the lid, free-slip and no-op BCs, velocity_rhs with
     a random external force, and the times of both at N=1024;
  4. the flagship soft disc in the lid-driven cavity at N=1024 float32
     (the fused tier): 50 warm-up steps, one step under sync-debug, 500
     timed steps with the launch counts checked;
  4b. the flagship with projection_method='pallas' (the projection's
     stencil kernels): 20 warm-up steps, one under sync-debug, 200 timed;
  4c. the same with momentum_method='xla', use_pallas_rhs=True added (the
     one-RHS kernel at each RK4 stage in place of the RK4 kernel);
  5. the split tier at full width: the flagship with the area fix and PDE
     reinitialisation, 20 warm-up steps, one under sync-debug, 200 timed;
  6. rebasing at full width: make_rebase_runner on the flagship with
     map_rebase_minj=0.5, one pre-rebase step under sync-debug, a 50-step
     chunk, a forced rebase (timed, with its fast-sweeping redistance), 20
     post-rebase steps;
  7. paths: 3 float64 steps at N=128 through the kernels and through the
     plain versions, for the flagship, for area fix + PDE reinit, for a
     rebase on every step, for the flagship with both opt-in switches and
     for area fix + PDE reinit with the projection's stencil kernels.

It then prints a JSON line of the kernels, the card's name and power limit
as nvidia-smi gives them, and last one JSON line
{"ok": true, "device": {...}}. Any failure raises before that line and
exits nonzero; so does a machine without CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pyrmt_tpu_torch import (  # noqa: E402
    Disc,
    Grid,
    RMTConfig,
    diverged,
    free_slip_box_bc,
    make_init_state,
    make_lid_bc,
    make_rebase_runner,
    make_step,
    noop_bc,
)
from pyrmt_tpu_torch.kernels import _build  # noqa: E402
from pyrmt_tpu_torch.kernels import extrapolate_fused as ef  # noqa: E402
from pyrmt_tpu_torch.kernels import momentum_rhs as mr  # noqa: E402
from pyrmt_tpu_torch.kernels import momentum_rk4 as mk  # noqa: E402
from pyrmt_tpu_torch.kernels import projection_stencils as ps  # noqa: E402
from pyrmt_tpu_torch.kernels import rmt_block as rb  # noqa: E402
from pyrmt_tpu_torch.ops.extrapolate import (  # noqa: E402
    extrapolate_reference_map,
)
from pyrmt_tpu_torch.ops.levelset import (  # noqa: E402
    reinitialize_phi_fsm,
    smoothed_solid_area,
)
from pyrmt_tpu_torch.ops.stress import solid_cauchy_stress  # noqa: E402
from pyrmt_tpu_torch.physics import (  # noqa: E402
    compute_timestep,
    momentum_core,
    velocity_rhs_blended,
)

# Tolerances of kernel vs plain version on the same inputs. Both evaluate
# the same IEEE operations in the same order (nvcc --fmad=false; a
# division by a constant is a product by its reciprocal in both), and on
# the H100 with CUDA 12.9 they agree bit for bit. The bounds leave room for
# a toolkit whose sin or sqrt rounds differently from PyTorch's.
# float64: an ulp of difference anywhere stays far below 1e-11.
TOL_F64 = 1e-11
# float32: an ulp of the map X (6e-8 at |X| ~ 0.5) over 2 dx = 2/1023 is
# ~2e-5 relative in grad X, so J and sigma may move by ~1e-5 of their size
# when the map moves by an ulp. The bound is 1e-4 times max(1, max |plain|):
# sigma and J grow large where det G is small, and there only the relative
# error means anything. The velocity update sees those differences times
# dt, hence 1e-5 there. The projection stencils and the one RHS read no
# map: 1e-5 (their expected difference is 0, as for the others).
TOL_F32_RMT = 1e-4
TOL_F32_MOMENTUM = 1e-5

FLAGSHIP_DISC = Disc(0.6, 0.5, 0.2)
EDGE_DISC = Disc(0.08, 0.9, 0.15)  # clipped by the domain's edge
SOURCES = ("rmt_block", "momentum_rk4", "extrapolate_fused",
           "projection_stencils", "momentum_rhs")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "rmt_block": ("pyrmt_tpu_torch/csrc/rmt_block.cu",
                  "pyrmt_tpu/kernels/rmt_block.py:825"),
    "momentum_rk4": ("pyrmt_tpu_torch/csrc/momentum_rk4.cu",
                     "pyrmt_tpu/kernels/momentum_rk4.py:453"),
    "advext_block": ("pyrmt_tpu_torch/csrc/rmt_block.cu",
                     "pyrmt_tpu/kernels/rmt_block.py:1085"),
    "extrapolate_fused": ("pyrmt_tpu_torch/csrc/extrapolate_fused.cu",
                          "pyrmt_tpu/kernels/extrapolate_fused.py:202"),
    "rc_rhs": ("pyrmt_tpu_torch/csrc/projection_stencils.cu",
               "pyrmt_tpu/kernels/projection_stencils.py:185"),
    "grad_correct": ("pyrmt_tpu_torch/csrc/projection_stencils.cu",
                     "pyrmt_tpu/kernels/projection_stencils.py:218"),
    "velocity_rhs": ("pyrmt_tpu_torch/csrc/momentum_rhs.cu",
                     "pyrmt_tpu/kernels/momentum_rhs.py:260"),
}
# the opt-in switches of phases 4c and 7
BOTH_SWITCHES = dict(projection_method="pallas", momentum_method="xla",
                     use_pallas_rhs=True)
PLAIN_IMPLS = dict(rmt_block_impl=rb.rmt_block_plain,
                   momentum_rk4_impl=momentum_core,
                   advext_impl=rb.advext_block_plain,
                   extrap_impl=extrapolate_reference_map,
                   momentum_rhs_impl=velocity_rhs_blended,
                   projection_stencils_impl=(ps.rc_rhs_plain,
                                             ps.grad_correct_plain))
OUT_NAMES = ("X1e", "X2e", "phi", "sxx", "sxy", "syy", "J", "Hf", "rho",
             "sb_xx", "sb_xy", "sb_yy")


def flagship(N, **overrides):
    """The flagship configuration of __graft_entry__._flagship."""
    return RMTConfig(grid=Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), mu_s=0.1,
                     eta_s=0.01, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                     num_layers=3, CFL=0.2, dt_min_cap=1e-3, **overrides)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(N, dtype, device, seed=0, disc=FLAGSHIP_DISC):
    """Seeded smooth inputs around a disc: a velocity of a few random
    Fourier modes scaled to a sub-cell displacement, the disc's initial map
    plus a smooth sub-cell perturbation, a smooth pressure, the split
    tier's pre-advection phi (the map's rebuild, shifted and wobbled by a
    fraction of a cell, as reinit and the area fix move it), a pressure
    correction and an external force of random noise."""
    rng = np.random.default_rng(seed)
    cfg = flagship(N)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    u = np.zeros((N, N))
    v = np.zeros((N, N))
    for _ in range(4):
        kx, ky = rng.integers(1, 4, size=2)
        a, b, c = rng.standard_normal(3)
        u += a * np.sin(np.pi * kx * X + c) * np.cos(np.pi * ky * Y)
        v += b * np.cos(np.pi * kx * X) * np.sin(np.pi * ky * Y + c)
    scale = 0.5 / max(np.abs(u).max(), np.abs(v).max())
    u, v = u * scale, v * scale
    p = 0.05 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    state = make_init_state(cfg, (disc,), dtype=dtype, device=device)
    # half a cell: a larger shift would move the level set past the
    # num_layers-cell band the map was extrapolated into
    pert = 0.5 * cfg.grid.dx * np.sin(3 * np.pi * X + rng.standard_normal()) \
        * np.sin(2 * np.pi * Y)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    X1s = (state.X1 + t(pert)).contiguous()
    X2s = (state.X2 - t(pert.T)).contiguous()
    # dt such that max|u| dt / dx = 0.4 cells
    dt = t(0.4 * cfg.grid.dx / 0.5)
    params = t([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f])
    wobble = 0.3 * cfg.grid.dx * np.sin(4 * np.pi * X + rng.standard_normal())
    phis = (disc(X1s[0], X2s[0]) + t(wobble))[None].contiguous()
    # the identity map inside phis <= 0, as a rebase extrapolates it
    Xg, Yg = cfg.grid.coords(dtype=dtype, device=device)
    mask = (phis[0] <= 0.0).to(dtype)
    p_corr = 1e-3 * rng.standard_normal((N, N))
    fx, fy = 0.01 * rng.standard_normal((2, N, N))
    return cfg, dict(u=t(u), v=t(v), p=t(p), X1s=X1s, X2s=X2s, dt=dt,
                     params=params, phis=phis, Xm=Xg * mask, Ym=Yg * mask,
                     disc=disc, p_corr=t(p_corr), fx=t(fx), fy=t(fy))


def rmt_call(fn, cfg, d):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["dt"],
              phi_inits=(d["disc"],), dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t, params=d["params"])


def advext_call(fn, cfg, d):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["phis"], d["dt"],
              dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=cfg.num_layers)


def extrap_call(fn, cfg, d):
    return fn(d["Xm"], d["Ym"], d["phis"][0], cfg.grid.dx, cfg.grid.dy,
              cfg.num_layers)


def momentum_args(cfg, d, rmt_out, eta_s):
    """The momentum operands the step builds from the block's outputs, with
    the flagship's adaptive dt (viscous-limited at N=1024; the block's
    sub-cell dt would be far past the RK4 stability bound)."""
    Hf, rho, sbxx, sbxy, sbyy = rmt_out[7:]
    mkv = (rmt_out[2][0] <= 0.0).to(Hf.dtype) * (1.0 - Hf)
    dt = compute_timestep(d["u"], d["v"], cfg.grid.dx, cfg.grid.dy, cfg.CFL,
                          cfg.dt_min_cap, cfg.mu_s, cfg.rho_s, cfg.gamma,
                          cfg.rho_f, mu_f=cfg.mu_f, eta_s=cfg.eta_s,
                          kappa=cfg.kappa)
    return (d["u"], d["v"], d["p"], sbxx, sbxy, sbyy, Hf, rho, mkv), dict(
        eta_s=eta_s, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt, mu_f=cfg.mu_f)


def stencil_args(cfg, d, rmt_out, fields, dt):
    """The operands of the projection kernels and of the one RHS, from
    ``momentum_args``' fields and dt: the velocity as a*, b*, a density
    1 .. 1.3 across the disc's interface (the flagship's is 1 everywhere);
    rc_rhs's (a*, b*, p_prev, rho, dt, d_scalar), grad_correct's (p_corr,
    a*, b*, rho, dt) and velocity_rhs's full argument list."""
    Hf = rmt_out[7]
    rho = 1.0 + 0.3 * (1.0 - Hf)
    g = cfg.grid
    u, v, p = d["u"], d["v"], d["p"]
    rc = (u, v, p, rho, dt, dt / rho.mean())
    gc = (d["p_corr"], u, v, rho, dt)
    rhs = (*fields[:6], g.dx, g.dy, cfg.mu_f, Hf, rho, d["fx"], d["fy"])
    return rc, gc, rhs


def max_errs(a, b):
    """(max-abs, max |b|) of two tensors."""
    return float((a - b).abs().max()), float(b.abs().max())


def check_close(what, err, scale, f64, tol_f32):
    """float64: max-abs <= TOL_F64; float32: max-abs <= tol_f32 times
    max(1, max |plain|). Prints the line and raises past the bound."""
    bound = TOL_F64 if f64 else tol_f32 * max(1.0, scale)
    print(f"[kernels] {what}: max_abs={err:.3e} "
          f"max_rel={err / max(scale, 1e-300):.3e} (bound {bound:.3g})")
    if not err <= bound:
        raise AssertionError(f"{what} differs by {err:.3e} > {bound:.3g}")


def compare_kernels(N, dtype, device, disc=FLAGSHIP_DISC):
    """Each kernel against its plain version on the same tensors (the
    momentum kernel for the flagship disc only). Returns {kernel: max-abs
    over its outputs}; raises past the tolerance."""
    f64 = dtype == torch.float64
    cfg, d = kernel_inputs(N, dtype, device, disc=disc)
    tag = f"N={N} {str(dtype)[6:]}" + ("" if disc == FLAGSHIP_DISC
                                       else " edge disc")
    worst = {}

    def hold(name, outs, kern, plain, tol_f32=TOL_F32_RMT):
        torch.cuda.synchronize()
        for out_name, a, b in zip(outs, kern, plain):
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"plain {name} {out_name} is not finite")
            err, scale = max_errs(a, b)
            check_close(f"{tag} {name} {out_name}", err, scale, f64, tol_f32)
            worst[name] = max(worst.get(name, 0.0), err)

    plain = rmt_call(rb.rmt_block_plain, cfg, d)
    hold("rmt_block", OUT_NAMES, rmt_call(rb.rmt_block_fused, cfg, d), plain)
    hold("advext_block", ("X1e", "X2e"),
         advext_call(rb.advext_block_fused, cfg, d),
         advext_call(rb.advext_block_plain, cfg, d))
    hold("extrapolate_fused", ("X1e", "X2e"),
         extrap_call(ef.extrapolate_reference_map_fused, cfg, d),
         extrap_call(extrapolate_reference_map, cfg, d))
    if disc != FLAGSHIP_DISC:
        return worst
    dx, dy = cfg.grid.dx, cfg.grid.dy
    fields, mkw = momentum_args(cfg, d, plain, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain, fields, mkw["dt"])
    hold("rc_rhs", ("rhs",), [ps.rc_rhs_fused(*rc, dx, dy)],
         [ps.rc_rhs_plain(*rc, dx, dy)], TOL_F32_MOMENTUM)
    for bc_name, bc in (("lid", make_lid_bc(1.0)),
                        ("free_slip", free_slip_box_bc), ("noop", noop_bc)):
        hold("grad_correct", (f"a {bc_name}", f"b {bc_name}"),
             ps.grad_correct_fused(*gc, dx, dy, bc),
             ps.grad_correct_plain(*gc, dx, dy, bc), TOL_F32_MOMENTUM)
    hold("velocity_rhs", ("rhs_u", "rhs_v"),
         mr.velocity_rhs_blended_fused(*rhs), velocity_rhs_blended(*rhs),
         TOL_F32_MOMENTUM)
    worst["momentum_rk4"] = 0.0
    for bc_name, bc, eta_s in (("lid", make_lid_bc(1.0), cfg.eta_s),
                               ("free_slip", free_slip_box_bc, 0.0)):
        args, kw = momentum_args(cfg, d, plain, eta_s)
        ref = momentum_core(*args, bc, **kw)
        out = mk.momentum_rk4_fused(*args, bc, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("u_new", "v_new"), out, ref):
            err, scale = max_errs(a, b)
            check_close(f"{tag} momentum_rk4 {bc_name} eta_s={eta_s} {name}",
                        err, scale, f64, TOL_F32_MOMENTUM)
            worst["momentum_rk4"] = max(worst["momentum_rk4"], err)
    return worst


def time_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(N, device, reps=20):
    """Kernel and plain times at the flagship's N and float32, in turns
    (plain, kernel, kernel, plain); each reported time is the mean of its
    two turns."""
    cfg, d = kernel_inputs(N, torch.float32, device)
    plain_out = rmt_call(rb.rmt_block_plain, cfg, d)
    args, kw = momentum_args(cfg, d, plain_out, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain_out, args, kw["dt"])
    dx, dy = cfg.grid.dx, cfg.grid.dy
    bc = make_lid_bc(1.0)
    pairs = {
        "rmt_block": (lambda: rmt_call(rb.rmt_block_fused, cfg, d),
                      lambda: rmt_call(rb.rmt_block_plain, cfg, d)),
        "momentum_rk4": (lambda: mk.momentum_rk4_fused(*args, bc, **kw),
                         lambda: momentum_core(*args, bc, **kw)),
        "advext_block": (lambda: advext_call(rb.advext_block_fused, cfg, d),
                         lambda: advext_call(rb.advext_block_plain, cfg, d)),
        "extrapolate_fused": (
            lambda: extrap_call(ef.extrapolate_reference_map_fused, cfg, d),
            lambda: extrap_call(extrapolate_reference_map, cfg, d)),
        "rc_rhs": (lambda: ps.rc_rhs_fused(*rc, dx, dy),
                   lambda: ps.rc_rhs_plain(*rc, dx, dy)),
        "grad_correct": (lambda: ps.grad_correct_fused(*gc, dx, dy, bc),
                         lambda: ps.grad_correct_plain(*gc, dx, dy, bc)),
        "velocity_rhs": (lambda: mr.velocity_rhs_blended_fused(*rhs),
                         lambda: velocity_rhs_blended(*rhs)),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        p1 = time_ms(plain, reps)
        k1 = time_ms(kernel, reps)
        k2 = time_ms(kernel, reps)
        p2 = time_ms(plain, reps)
        times[name] = (0.5 * (k1 + k2), 0.5 * (p1 + p2))
        print(f"[timing] N={N} float32 {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")
    return times


def reset_counts():
    rb.launches = rb.advext_launches = mk.launches = ef.launches = 0
    ps.rc_rhs_launches = ps.grad_correct_launches = mr.launches = 0


def counts():
    return {"rmt_block": rb.launches, "momentum_rk4": mk.launches,
            "advext_block": rb.advext_launches,
            "extrapolate_fused": ef.launches,
            "rc_rhs": ps.rc_rhs_launches,
            "grad_correct": ps.grad_correct_launches,
            "velocity_rhs": mr.launches}


def expected_launches(**launches):
    """The launch counts of a run: the named ones, 0 for the rest."""
    return {name: launches.get(name, 0) for name in KERNELS}


def step_without_sync(step, state, t_end):
    """One step under PyTorch's sync debug mode, which raises on a call
    that waits for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return step(state, t_end)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_flagship(N, device, warmup, steps, **overrides):
    """make_init_state, warm-up steps, one step that must not synchronise
    with the host, then timed steps with the launch counts reset just
    before. Returns (cfg, state, aux, launches, seconds, sum of dts, t
    before the timed steps)."""
    cfg = flagship(N, **overrides)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (FLAGSHIP_DISC,), dtype=torch.float32,
                     device=device)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), dtype=torch.float32,
                            device=device)
    t_end = 8.0
    for _ in range(warmup):
        state, aux = step(state, t_end)
    state, aux = step_without_sync(step, state, t_end)
    t0 = state.t.double()
    dt_sum = torch.zeros((), dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    reset_counts()
    wall = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, t_end)
        dt_sum += aux["dt"].double()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    return cfg, state, aux, counts(), wall, dt_sum, t0


def check_state(state, aux, what):
    """Finite, not diverged, min J over the solid in (0.5, 2)."""
    for name in ("u", "v", "p", "X1", "X2"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{what}: state.{name} is not finite")
    if bool(diverged(state)):
        raise AssertionError(f"{what}: the run diverged")
    min_J = float(aux["J"][aux["phis"] <= 0.0].min())
    if not 0.5 < min_J < 2.0:
        raise AssertionError(f"{what}: min J over the solid is {min_J}")
    return min_J


def check_run(what, state, aux, launches, expect, dt_sum, t0):
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, expected {expect}")
    min_J = check_state(state, aux, what)
    advanced = float(state.t.double() - t0)
    if not abs(advanced - float(dt_sum)) <= 1e-4 * max(advanced, 1e-6):
        raise AssertionError(
            f"{what}: t advanced by {advanced}, the dts sum to "
            f"{float(dt_sum)}")
    return min_J, advanced


def run_rebase(N, device, chunk=50, post_steps=20):
    """The rebasing runner at full width: one pre-rebase step under sync
    debug, one chunk, a rebase forced on the solid, post-rebase steps."""
    cfg = flagship(N, map_rebase_minj=0.5)
    g = cfg.grid
    bc = make_lid_bc(1.0)
    kw = dict(dtype=torch.float32, device=device)
    runner = make_rebase_runner(cfg, bc, (FLAGSHIP_DISC,), chunk, **kw)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)
    t_end = 8.0
    state, _ = step_without_sync(runner.pre_step, state, t_end)
    state, _ = runner(state, t_end)
    if runner.post:
        raise AssertionError("the pre-rebase chunk triggered a rebase")
    min_J_pre = float(runner.min_J(state)[0])

    phi = FLAGSHIP_DISC(state.X1[0], state.X2[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    reinitialize_phi_fsm(phi, g.dx, g.dy)
    torch.cuda.synchronize()
    fsm_s = time.perf_counter() - t

    phis0_before = state.phis0.clone()
    reset_counts()
    t = time.perf_counter()
    state = runner.rebase(state, [True])
    torch.cuda.synchronize()
    rebase_s = time.perf_counter() - t
    rebase_counts = counts()
    if rebase_counts["extrapolate_fused"] != 1 or not runner.post:
        raise AssertionError(f"the forced rebase launched {rebase_counts}")
    if torch.equal(state.phis0, phis0_before):
        raise AssertionError("the rebase left phis0 as it was")
    J = solid_cauchy_stress(state.X1[0], state.X2[0], g.dx, g.dy, cfg.mu_s,
                            cfg.kappa, state.phis0[0])[3]
    inner = state.phis0[0] < -3.0 * g.dx
    J_err = float((J[inner] - 1.0).abs().max())
    if not J_err <= 1e-4:
        raise AssertionError(f"J after the rebase is {J_err} off 1")

    reset_counts()
    fired = []
    t = time.perf_counter()
    for _ in range(post_steps):
        state, aux = runner.post_step(state, t_end)
        fired.append(aux["rebased"])
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t
    post_counts = counts()
    if bool(torch.stack(fired).any()) or post_counts["extrapolate_fused"]:
        raise AssertionError(f"a post-rebase step rebased: {post_counts}")
    if post_counts["advext_block"] != post_steps:
        raise AssertionError(f"post-rebase launches {post_counts}")
    min_J_post = check_state(state, aux, "post-rebase")
    return dict(min_J_pre=min_J_pre, fsm_s=fsm_s, rebase_s=rebase_s,
                J_err=J_err, min_J_post=min_J_post, post_s=post_s,
                launches=rebase_counts["extrapolate_fused"])


def compare_paths(N, device, steps=3, **overrides):
    """A few float64 steps through the kernels and through the plain
    versions from the same state; returns the max-abs differences and the
    kernel path's launches."""
    cfg = flagship(N, **overrides)
    bc = make_lid_bc(1.0)
    kw = dict(dtype=torch.float64, device=device)
    s_k = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    a, b = rng.standard_normal(2)
    s_k.u = torch.tensor(0.3 * a * np.sin(np.pi * X) * np.sin(np.pi * Y), **kw)
    s_k.v = torch.tensor(0.3 * b * np.sin(2 * np.pi * X) * np.sin(np.pi * Y),
                         **kw)
    s_p = s_k
    step_k = make_step(cfg, bc, (FLAGSHIP_DISC,), **kw)
    step_p = make_step(cfg, bc, (FLAGSHIP_DISC,), **kw, **PLAIN_IMPLS)
    reset_counts()
    for _ in range(steps):
        s_k, _ = step_k(s_k, 8.0)
        s_p, _ = step_p(s_p, 8.0)
    torch.cuda.synchronize()
    errs = {k: float((getattr(s_k, k) - getattr(s_p, k)).abs().max())
            for k in ("u", "v", "p", "X1", "X2", "phis0")
            if getattr(s_k, k).numel()}
    if not all(e <= 1e-10 for e in errs.values()):
        raise AssertionError(f"kernel path vs plain path {overrides}: {errs}")
    return errs, {k: n for k, n in counts().items() if n}


def main() -> int:
    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    card = nvidia_smi_line()
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc[-1]}' card '{card}'")

    # 2. build
    t = time.perf_counter()
    _build.load_all(SOURCES)
    print(f"[build] {len(SOURCES)} CUDA sources built side by side for "
          f"sm_90a in {time.perf_counter() - t:.1f} s into "
          f"{_build.build_dir()}")
    for name in SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    # 3. kernel vs plain on the card
    errs = {}
    for N, dtype, disc in ((256, torch.float64, FLAGSHIP_DISC),
                           (256, torch.float32, FLAGSHIP_DISC),
                           (256, torch.float64, EDGE_DISC),
                           (256, torch.float32, EDGE_DISC),
                           (1024, torch.float32, FLAGSHIP_DISC)):
        for name, e in compare_kernels(N, dtype, device, disc).items():
            errs[name] = max(errs.get(name, 0.0), e)
    times = time_kernels(1024, device)

    # 4. the flagship slice (fused tier)
    steps = 500
    _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
        1024, device, warmup=50, steps=steps)
    min_J, advanced = check_run(
        "flagship", state, aux, launches,
        expected_launches(rmt_block=steps, momentum_rk4=steps), dt_sum, t0)
    flagship_rate = steps / wall
    print(f"[slice] flagship N=1024 float32: {steps} steps in {wall:.3f} s = "
          f"{flagship_rate:.1f} steps/s, {1e3 * wall / steps:.3f} ms/step "
          f"(host clock, synchronised) on '{card}'; launches {launches}; "
          f"t advanced {advanced:.6f}; min J over the solid {min_J:.4f}")
    main_launches = dict(launches)

    # 4b. the projection's stencil kernels; 4c. and the one-RHS kernel
    steps = 200
    for tag, overrides, per_step, reported in (
            ("proj", dict(projection_method="pallas"),
             dict(rmt_block=1, momentum_rk4=1, rc_rhs=1, grad_correct=1),
             ("rc_rhs", "grad_correct")),
            ("rhs", BOTH_SWITCHES,
             dict(rmt_block=1, velocity_rhs=4, rc_rhs=1, grad_correct=1),
             ("velocity_rhs",))):
        _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
            1024, device, warmup=20, steps=steps, **overrides)
        expected = expected_launches(**{k: n * steps
                                        for k, n in per_step.items()})
        min_J, advanced = check_run(f"flagship {overrides}", state, aux,
                                    launches, expected, dt_sum, t0)
        print(f"[{tag}] flagship {overrides} N=1024 float32: {steps} steps "
              f"in {wall:.3f} s = {steps / wall:.1f} steps/s, "
              f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
              f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
              f"launches {launches}; t advanced {advanced:.6f}; min J over "
              f"the solid {min_J:.4f}")
        for name in reported:
            main_launches[name] = launches[name]

    # 5. the split tier at full width
    steps = 200
    cfg, state, aux, launches, wall, dt_sum, t0 = run_flagship(
        1024, device, warmup=20, steps=steps, phi_area_fix=True,
        reinit_method="pde")
    min_J, advanced = check_run(
        "split tier", state, aux, launches,
        expected_launches(momentum_rk4=steps, advext_block=steps), dt_sum, t0)
    g = cfg.grid
    X, Y = g.coords(dtype=torch.float32, device=device)
    target = float(smoothed_solid_area(FLAGSHIP_DISC(X, Y), g.dx, g.dy,
                                       cfg.w_t))
    area = float(smoothed_solid_area(aux["phis"][0], g.dx, g.dy, cfg.w_t))
    if not abs(area - target) <= 1e-4 * target:
        raise AssertionError(f"area {area} drifted from {target}")
    print(f"[split] flagship + area fix + PDE reinit N=1024 float32: "
          f"{steps} steps in {wall:.3f} s = {steps / wall:.1f} steps/s, "
          f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised) on "
          f"'{card}'; launches {launches}; t advanced {advanced:.6f}; "
          f"min J {min_J:.4f}; solid area {area:.7g} vs target {target:.7g}")
    main_launches["advext_block"] = launches["advext_block"]

    # 6. rebasing at full width
    rebase = run_rebase(1024, device)
    print(f"[rebase] flagship map_rebase_minj=0.5 N=1024 float32: 51 "
          f"pre-rebase steps (min J {rebase['min_J_pre']:.4f}); fast-sweeping "
          f"redistance {rebase['fsm_s']:.3f} s, whole forced rebase "
          f"{rebase['rebase_s']:.3f} s (host clock) on '{card}'; |J - 1| "
          f"inside {rebase['J_err']:.2e}; 20 post-rebase steps in "
          f"{rebase['post_s']:.3f} s ({1e3 * rebase['post_s'] / 20:.3f} "
          f"ms/step), none rebased, min J {rebase['min_J_post']:.4f}")
    main_launches["extrapolate_fused"] = rebase["launches"]

    # 7. kernel path vs plain path
    for what, overrides in (
            ("flagship", {}),
            ("area fix + PDE reinit",
             dict(phi_area_fix=True, reinit_method="pde")),
            ("rebase every step", dict(map_rebase_minj=10.0)),
            ("flagship + both opt-in switches", BOTH_SWITCHES),
            ("area fix + PDE reinit + projection stencils",
             dict(phi_area_fix=True, reinit_method="pde",
                  projection_method="pallas"))):
        path_errs, path_launches = compare_paths(128, device, **overrides)
        print(f"[paths] N=128 float64 {what}, 3 steps kernel path vs plain "
              f"path: " + ", ".join(f"{k} {e:.2e}"
                                    for k, e in path_errs.items())
              + f"; kernel path launches {path_launches}")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": main_launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, tpu) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
