"""Profiling of the port (counterpart of ``pyrmt_tpu/profiling.py``).

  * ``trace(log_dir)``: a ``torch.profiler`` session around the steps run
    inside it, written to ``log_dir/trace.json`` as a Chrome trace (the
    card's kernels with the host's calls where CUDA is at hand);
  * ``stage_breakdown(N, dtype, iters)``: each stage of the flagship's
    pipeline timed alone (the reference's table: momentum, projection,
    advection, extrapolation) beside the whole step;
  * ``ablation_breakdown(N, dtype, steps)``: the whole flagship step with
    one switch changed, each row's difference from the first that
    switch's cost end to end.

On the card each time comes from CUDA events around the timed calls after
a warm-up; on the CPU from the host clock. The flagship is
``__graft_entry__._flagship``'s: the soft disc (R = 0.2 at (0.6, 0.5),
mu_s = 0.1, eta_s = 0.01) in the lid-driven cavity (mu_f = 0.01).

    python -m pyrmt_tpu_torch.profiling [N] [--ablate] [--cpu]
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import time

import torch

from pyrmt_tpu_torch.bcs import make_lid_bc
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.sim import RMTConfig, make_init_state, make_step

FLAGSHIP_DISC = Disc(0.6, 0.5, 0.2)
# the least chunk ablation_breakdown times: 50-step chunks read ~2.4x
# slow (VERDICT weak #7)
MIN_ABLATION_STEPS = 500


@contextlib.contextmanager
def trace(log_dir):
    """Profile the code run inside (the CPU's calls, and the card's
    kernels where CUDA is at hand); yields the ``torch.profiler.profile``
    (its ``key_averages()`` the table) and writes ``log_dir/trace.json``,
    a Chrome trace, on leaving."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flagship_config(N):
    """The flagship's configuration at N."""
    return RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                     rho_s=1.0, mu_f=0.01, rho_f=1.0, num_layers=3, CFL=0.2,
                     dt_min_cap=1e-3)


def _clock(device):
    """(start, stop): ``stop()`` the milliseconds since ``start()``, from
    CUDA events on the card, else the host clock."""
    if torch.device(device).type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def start():
            events[0].record()

        def stop():
            events[1].record()
            events[1].synchronize()
            return events[0].elapsed_time(events[1])

        return start, stop
    t = [0.0]

    def start():
        t[0] = time.perf_counter()

    def stop():
        return 1e3 * (time.perf_counter() - t[0])

    return start, stop


def time_chain(fn, carry, iters, device, warmup=1):
    """Milliseconds a call of ``fn: carry -> carry``, ``iters`` calls
    chained through the carry (each call reads the last one's result, as
    JAX's scanned timing chains them) after ``warmup`` calls."""
    for _ in range(warmup):
        carry = fn(carry)
    start, stop = _clock(device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    start()
    for _ in range(iters):
        carry = fn(carry)
    return stop() / iters


def stage_breakdown(N=128, dtype=torch.float32, iters=20, device="cuda",
                    verbose=True):
    """Each stage of the flagship's pipeline at N, timed alone (ms a call,
    ``iters`` chained calls after a warm-up): ``momentum_rk4`` (the stress
    and blends from the maps, then the RK4 kernel on the card),
    ``projection`` (the Neumann projection), ``advection_gather`` (the
    semi-Lagrangian RK4 backtrace with gathers, JAX's sl_local=False
    path), ``advection_local`` (the gather-free backtrace of the fused
    tiers, as plain ops), ``extrapolation_xla`` (the plain extrapolation)
    and ``extrapolation_pallas`` (``extrapolate_fused``: the kernel on the
    card, its plain twin on the CPU), and ``full_step``. Returns {stage:
    ms}."""
    from pyrmt_tpu_torch.kernels.extrapolate_fused import (
        extrapolate_reference_map_fused,
    )
    from pyrmt_tpu_torch.ops.advect import (
        advect_semilagrangian_rk4_local,
        advect_semilagrangian_rk4_multi,
    )
    from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
    from pyrmt_tpu_torch.ops.poisson import (
        precompute_dct_matrices,
        precompute_poisson_eigenvalues,
    )
    from pyrmt_tpu_torch.ops.projection import pressure_projection
    from pyrmt_tpu_torch.physics import momentum_step_rk4

    kw = dict(dtype=dtype, device=device)
    cfg = flagship_config(N)
    g = cfg.grid
    dx, dy = g.dx, g.dy
    bc = make_lid_bc(1.0)
    X, Y = g.coords(**kw)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)
    phi = FLAGSHIP_DISC(X, Y)
    eig = precompute_poisson_eigenvalues(N, N, dx, dy, **kw)
    mats = precompute_dct_matrices(N, N, **kw)
    dt = torch.tensor(1e-3, **kw)
    X1, X2 = state.X1[0], state.X2[0]
    qs = torch.cat([state.X1, state.X2])

    def mom(c):
        out = momentum_step_rk4(c[0], c[1], state.p, X1, X2, bc, cfg.mu_s,
                                cfg.kappa, cfg.eta_s, dx, dy, dt, cfg.rho_s,
                                cfg.rho_f, phi, cfg.mu_f, cfg.w_t)
        return out[:2]

    rho = torch.ones_like(X)

    def proj(c):
        return pressure_projection(c[0], c[1], dx, dy, dt, rho, bc, c[2],
                                   eig, dct_mats=mats)

    step = make_step(cfg, bc, (FLAGSHIP_DISC,), **kw)
    stages = {
        "momentum_rk4": (mom, (state.u, state.v)),
        "projection": (proj, (state.u, state.v, state.p)),
        "advection_gather": (lambda q: advect_semilagrangian_rk4_multi(
            q, state.u, state.v, X, Y, dt, dx, dy), qs),
        "advection_local": (lambda q: advect_semilagrangian_rk4_local(
            q, state.u, state.v, dt, dx, dy), qs),
        "extrapolation_xla": (lambda c: extrapolate_reference_map(
            c[0], c[1], phi, dx, dy, cfg.num_layers), (X1, X2)),
        "extrapolation_pallas": (lambda c: extrapolate_reference_map_fused(
            c[0], c[1], phi, dx, dy, cfg.num_layers), (X1, X2)),
        "full_step": (lambda s: step(s, 1e9)[0], state),
    }
    results = {}
    for name, (fn, carry) in stages.items():
        n = max(iters // 10, 2) if name == "advection_gather" else iters
        results[name] = time_chain(fn, carry, n, device)
    if verbose:
        print(f"[stage_breakdown] N={N} dtype={dtype}")
        for k, ms in results.items():
            print(f"  {k:20s} {ms:8.3f} ms")
    return results


def _ablations():
    """(row, config overrides, make_step keywords): the switches that
    change the port's path. JAX's ``tile_skip=False`` row is the solid
    block's kernel with its skip off; JAX's ``rmt_method='xla'`` (no fused
    solid block) is the plain twin of the solid block here, the port's
    ``rmt_method`` being accepted and ignored."""
    from pyrmt_tpu_torch.kernels.rmt_block import (
        rmt_block_fused,
        rmt_block_plain,
    )

    return (
        ("all defaults", {}, {}),
        ("tile_skip=False (no solid-free skip)", {},
         dict(rmt_block_impl=functools.partial(rmt_block_fused,
                                               tile_skip=False))),
        ("rmt_block plain twin (JAX's rmt_method=xla)", {},
         dict(rmt_block_impl=rmt_block_plain)),
        ("momentum_method=xla", dict(momentum_method="xla"), {}),
        ("sl_local=False (gather advection)", dict(sl_local=False), {}),
        ("projection_method=pallas", dict(projection_method="pallas"), {}),
    )


def ablation_breakdown(N=1024, dtype=torch.float32, steps=500, warmup=20,
                       device="cuda", verbose=True, on_row=None):
    """Each feature's cost end to end: the whole flagship step timed over
    one chunk of ``steps`` steps (at least ``MIN_ABLATION_STEPS``: chunks
    of 50 steps read about 2.4x slow, VERDICT weak #7) after ``warmup``
    steps, with one switch changed a row. The rows are JAX's whose switch
    changes the port's path (all defaults; ``tile_skip=False``, the solid
    block's kernel with no solid-free skip; ``rmt_method='xla'``, here the
    solid block's plain twin; ``momentum_method='xla'``;
    ``sl_local=False``) and JAX's ``projection_method='pallas'`` (the
    projection's stencil kernels). Left out: the switches the port takes
    and ignores (``extrap_method``, ``dct_method``, ``kernel_slab_halo``,
    ``dct_precision``). ``on_row(row)``, where given, is called after each
    row's timed chunk (a caller reads and resets the kernels' launch
    counters there). Returns {row: ms a step}."""
    if steps < MIN_ABLATION_STEPS:
        raise ValueError(f"ablation_breakdown times chunks of at least "
                         f"{MIN_ABLATION_STEPS} steps, not {steps}")
    kw = dict(dtype=dtype, device=device)
    cfg0 = flagship_config(N)
    bc = make_lid_bc(1.0)
    results = {}
    for name, over, impls in _ablations():
        cfg = dataclasses.replace(cfg0, **over)
        step = make_step(cfg, bc, (FLAGSHIP_DISC,), **kw, **impls)
        state = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)

        def chunk(s, n):
            for _ in range(n):
                s, _ = step(s, 1e9)
            return s

        state = chunk(state, warmup)
        results[name] = time_chain(lambda s: chunk(s, steps), state, 1,
                                   device, warmup=0) / steps
        if verbose:
            print(f"  {name:45s} {results[name]:8.3f} ms/step")
        if on_row is not None:
            on_row(name)
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos = [a for a in argv if not a.startswith("--")]
    N = int(pos[0]) if pos else 128
    device = "cpu" if "--cpu" in argv else "cuda"
    if "--ablate" in argv:
        print(f"[ablation_breakdown] N={N}")
        ablation_breakdown(N=N, device=device)
    else:
        stage_breakdown(N=N, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
