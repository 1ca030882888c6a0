#!/usr/bin/env python3
"""Smoke run of pyrmt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases, one line each:

  1. probe: torch and CUDA versions, nvcc, the card's name and power limit;
  2. build both CUDA kernels from pyrmt_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the same tensors on
     the card: float64 at N=256 (max-abs <= 1e-11), float32 at N=256 and at
     the flagship's N=1024 (bounds below), and the times of both at N=1024;
  4. the flagship soft disc in the lid-driven cavity at N=1024 float32:
     make_init_state, 50 warm-up steps, 500 timed steps of make_step with
     both kernels' launch counts checked, then 3 steps at N=128 float64
     through the kernel path and through the plain path.

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
    make_step,
)
from pyrmt_tpu_torch.kernels import _build  # noqa: E402
from pyrmt_tpu_torch.kernels import momentum_rk4 as mk  # noqa: E402
from pyrmt_tpu_torch.kernels import rmt_block as rb  # noqa: E402
from pyrmt_tpu_torch.physics import compute_timestep, momentum_core  # noqa: E402

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
# dt, hence 1e-5 there.
TOL_F32_RMT = 1e-4
TOL_F32_MOMENTUM = 1e-5

FLAGSHIP_DISC = Disc(0.6, 0.5, 0.2)
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


def kernel_inputs(N, dtype, device, seed=0):
    """Seeded smooth inputs around the flagship disc: a velocity of a few
    random Fourier modes scaled to a sub-cell displacement, the flagship's
    initial map plus a smooth sub-cell perturbation, a smooth pressure."""
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
    state = make_init_state(cfg, (FLAGSHIP_DISC,), dtype=dtype, device=device)
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
    return cfg, dict(u=t(u), v=t(v), p=t(p), X1s=X1s, X2s=X2s, dt=dt,
                     params=params)


def rmt_call(fn, cfg, d):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["dt"],
              phi_inits=(FLAGSHIP_DISC,), dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t, params=d["params"])


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


def compare_kernels(N, dtype, device):
    """Each kernel against its plain version on the same tensors. Returns
    {kernel: max-abs over its outputs}; raises past the tolerance."""
    f64 = dtype == torch.float64
    cfg, d = kernel_inputs(N, dtype, device)
    plain = rmt_call(rb.rmt_block_plain, cfg, d)
    kern = rmt_call(rb.rmt_block_fused, cfg, d)
    torch.cuda.synchronize()
    worst = {"rmt_block": 0.0, "momentum_rk4": 0.0}
    tag = f"N={N} {str(dtype)[6:]}"
    for name, a, b in zip(OUT_NAMES, kern, plain):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"plain rmt_block {name} is not finite")
        err, scale = max_errs(a, b)
        check_close(f"{tag} rmt_block {name}", err, scale, f64, TOL_F32_RMT)
        worst["rmt_block"] = max(worst["rmt_block"], err)
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
    bc = make_lid_bc(1.0)
    pairs = {
        "rmt_block": (lambda: rmt_call(rb.rmt_block_fused, cfg, d),
                      lambda: rmt_call(rb.rmt_block_plain, cfg, d)),
        "momentum_rk4": (lambda: mk.momentum_rk4_fused(*args, bc, **kw),
                         lambda: momentum_core(*args, bc, **kw)),
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


def run_flagship(N, device, warmup, steps):
    """make_init_state, warm-up steps, one step that must not synchronise
    with the host, then timed steps with the launch counts reset just
    before. Returns (state, aux, launches, seconds,
    sum of dts, t before the timed steps)."""
    cfg = flagship(N)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (FLAGSHIP_DISC,), dtype=torch.float32,
                     device=device)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), dtype=torch.float32,
                            device=device)
    t_end = 8.0
    for _ in range(warmup):
        state, aux = step(state, t_end)
    torch.cuda.synchronize()
    # a step must not wait for the card: PyTorch's sync debug mode raises
    # on a synchronizing call
    torch.cuda.set_sync_debug_mode("error")
    state, aux = step(state, t_end)
    torch.cuda.set_sync_debug_mode("default")
    t0 = state.t.double()
    dt_sum = torch.zeros((), dtype=torch.float64, device=device)
    rb.launches = 0
    mk.launches = 0
    wall = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, t_end)
        dt_sum += aux["dt"].double()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    launches = {"rmt_block": rb.launches, "momentum_rk4": mk.launches}
    return state, aux, launches, wall, dt_sum, t0


def check_flagship(state, aux, launches, steps, dt_sum, t0):
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name} launched {n} times in {steps} steps")
    for name in ("u", "v", "p", "X1", "X2"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"state.{name} is not finite")
    if bool(diverged(state)):
        raise AssertionError("the flagship run diverged")
    solid = aux["phis"] <= 0.0
    min_J = float(aux["J"][solid].min())
    if not 0.5 < min_J < 2.0:
        raise AssertionError(f"min J over the solid is {min_J}")
    advanced = float(state.t.double() - t0)
    if not abs(advanced - float(dt_sum)) <= 1e-4 * max(advanced, 1e-6):
        raise AssertionError(
            f"t advanced by {advanced}, the dts sum to {float(dt_sum)}")
    return min_J, advanced


def compare_paths(N, device, steps=3):
    """A few float64 steps through the kernels and through the plain
    versions from the same state; returns the max-abs difference."""
    cfg = flagship(N)
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
    step_p = make_step(cfg, bc, (FLAGSHIP_DISC,), **kw,
                       rmt_block_impl=rb.rmt_block_plain,
                       momentum_rk4_impl=momentum_core)
    for _ in range(steps):
        s_k, _ = step_k(s_k, 8.0)
        s_p, _ = step_p(s_p, 8.0)
    torch.cuda.synchronize()
    errs = {k: float((getattr(s_k, k) - getattr(s_p, k)).abs().max())
            for k in ("u", "v", "p", "X1", "X2")}
    if not all(e <= 1e-10 for e in errs.values()):
        raise AssertionError(f"kernel path vs plain path: {errs}")
    return errs


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
    for name in ("rmt_block", "momentum_rk4"):
        _build.load(name)
    print(f"[build] both kernels built for sm_90a in "
          f"{time.perf_counter() - t:.1f} s into {_build.build_dir()}")
    for name in ("rmt_block", "momentum_rk4"):
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    # 3. kernel vs plain on the card
    compare_kernels(256, torch.float64, device)
    compare_kernels(256, torch.float32, device)
    errs = compare_kernels(1024, torch.float32, device)
    times = time_kernels(1024, device)

    # 4. the flagship slice
    steps = 500
    state, aux, launches, wall, dt_sum, t0 = run_flagship(
        1024, device, warmup=50, steps=steps)
    min_J, advanced = check_flagship(state, aux, launches, steps, dt_sum, t0)
    print(f"[slice] flagship N=1024 float32: {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.1f} steps/s, {1e3 * wall / steps:.3f} ms/step "
          f"(host clock, synchronised) on '{card}'; launches {launches}; "
          f"t advanced {advanced:.6f}; min J over the solid {min_J:.4f}")
    path_errs = compare_paths(128, device)
    print(f"[slice] N=128 float64, 3 steps kernel path vs plain path: "
          + ", ".join(f"{k} {e:.2e}" for k, e in path_errs.items()))

    source = {"rmt_block": ("pyrmt_tpu_torch/csrc/rmt_block.cu",
                            "pyrmt_tpu/kernels/rmt_block.py:825"),
              "momentum_rk4": ("pyrmt_tpu_torch/csrc/momentum_rk4.cu",
                               "pyrmt_tpu/kernels/momentum_rk4.py:453")}
    kernels = [{"name": name, "route": "cuda", "source": source[name][0],
                "replaces": source[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in source]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
