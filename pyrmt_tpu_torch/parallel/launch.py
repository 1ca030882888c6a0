"""Spawn a world of ranks on one machine and run a function in each.

    case = dict(cfg=cfg, velocity_bc=bc, phi_inits=shapes, steps=3,
                dtype=torch.float64, device="cpu")
    results = run_world(4, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                        dict(cases=[case]))   # results[0]: rank 0's list

Each rank is a fresh interpreter (``python -m pyrmt_tpu_torch.parallel.
launch``), so a rank imports the port alone: the caller may have imported
anything (the tests import jax), the ranks do not. A rank sets
``torch.set_num_threads(1)``, joins the process group through a ``file://``
rendezvous in a temporary directory with the backend the caller chose
(nothing swaps it: gloo on CPU tensors, or on the CUDA tensors of ranks
that share one card, which cannot host an NCCL world of more than one
rank; NCCL for one rank per card), on CUDA takes card ``rank % count``,
calls the target with the keyword arguments and sends its result back
pickled. ``run_world`` returns the ranks' results in rank order; a rank
that fails or outlasts ``timeout`` raises, and every rank process is
stopped before it returns.

``run_sharded`` is a rank body: a sharded run of the step from a whole
initial state, gathered back. ``run_sharded_grads`` is one too: the
gradients of a sharded run's loss (``sharded_grad_case``).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_world(nprocs: int, target: str, kwargs=None, backend="gloo",
              timeout=600.0):
    """Run ``target`` ('module:function') in each of ``nprocs`` ranks of a
    new ``backend`` world; returns the results in rank order."""
    with tempfile.TemporaryDirectory(prefix="pyrmt_world_") as tmp:
        work = Path(tmp)
        (work / "job.pkl").write_bytes(pickle.dumps((target, kwargs or {})))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs, logs = [], []
        try:
            for rank in range(nprocs):
                log = open(work / f"rank{rank}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pyrmt_tpu_torch.parallel.launch",
                     str(work), str(rank), str(nprocs), backend],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            failed = None
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    failed = f"timed out after {timeout} s"
                    break
                if any(p.poll() not in (None, 0) for p in procs):
                    failed = "a rank failed"
                    break
                time.sleep(0.05)
            if failed is None and any(p.returncode for p in procs):
                failed = "a rank failed"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed is not None:
            tails = []
            for rank, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {rank} (exit {procs[rank].returncode})"
                             f":\n{log.read()[-4000:]}")
            for log in logs:
                log.close()
            raise RuntimeError(f"run_world({target}): {failed}\n"
                               + "\n".join(tails))
        for log in logs:
            log.close()
        return [pickle.loads((work / f"result{rank}.pkl").read_bytes())
                for rank in range(nprocs)]


def _rank_main(work: str, rank: int, world: int, backend: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    work = Path(work)
    target, kwargs = pickle.loads((work / "job.pkl").read_bytes())
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(**kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (work / f"result{rank}.pkl").write_bytes(pickle.dumps(result))


def run_sharded(cases):
    """A rank body: for each case (a dict of ``sharded_case``'s keywords),
    a sharded run gathered back, on a mesh of the world's ranks or of its
    first ones (``mesh_shape``); returns the list of their results on rank
    0, None on the others."""
    import torch.distributed as dist

    out = [sharded_case(**case) for case in cases]
    return out if dist.get_rank() == 0 else None


def sharded_case(cfg, velocity_bc, phi_inits, steps, dtype, device="cuda",
                 mesh_shape=None, rmt_method=None, state0=None, t_end=1.0,
                 warmup=0):
    """``steps`` steps of ``make_sharded_step`` on this world's mesh (near
    square, or ``mesh_shape``, of the world's first ranks where it holds
    fewer: the others return None at once) from ``make_init_state`` or
    from ``state0``
    (a whole state as numpy arrays, ``io.state_to_numpy``'s), after
    ``warmup`` steps that are not timed; returns
    the gathered final state as numpy arrays, the step's paths, each
    rank's wall milliseconds a step (the host clock, synchronised), each
    rank's launches of each kernel over the timed steps, and each timed
    step's aux['cg_iters'] (variable density) and aux['rebased'] (map
    rebasing) as rank 0 read them (None without)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pyrmt_tpu_torch.parallel.sharding import (
        gather_state,
        make_mesh,
        make_sharded_step,
    )
    from pyrmt_tpu_torch.io import state_from_numpy
    from pyrmt_tpu_torch.sim import make_init_state

    mesh = make_mesh(shape=mesh_shape)
    if mesh is None:  # a mesh of fewer ranks than the world's
        return None
    kw = dict(dtype=dtype, device=device)
    step, shard = make_sharded_step(cfg, velocity_bc, phi_inits, mesh,
                                    rmt_method=rmt_method, **kw)
    if state0 is None:
        state = make_init_state(cfg, phi_inits, **kw)
    else:
        state = state_from_numpy(state0, **kw)
    state = shard(state)
    t = torch.as_tensor(t_end, dtype=dtype, device=device)
    for _ in range(warmup):
        state, _ = step(state, t)
    counters = _counters()
    _read_counts(counters, reset=True)
    sync = torch.cuda.synchronize if state.u.is_cuda else (lambda: None)
    sync()
    auxes = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, t)
        auxes.append({k: aux[k] for k in ("cg_iters", "rebased")
                      if k in aux})
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / max(steps, 1)
    launches = _read_counts(counters)
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, (ms, launches), group=mesh.group)
    whole = gather_state(state, mesh)
    phis = (mesh.gather(aux["phis"]) if aux["phis"].numel() else
            aux["phis"].new_zeros((0,) + tuple(whole.u.shape)))
    arrays = {k: getattr(whole, k).detach().cpu().numpy()
              for k in ("u", "v", "p", "X1", "X2", "t", "step", "phis0")}
    arrays["phis"] = phis.detach().cpu().numpy()

    def per_step(key, read):
        return ([read(a[key]) for a in auxes] if auxes and key in auxes[0]
                else None)

    return dict(state=arrays, paths=dict(step.paths),
                ms_per_step=[r[0] for r in per_rank],
                launches=[r[1] for r in per_rank], mesh=mesh.shape,
                dt=float(aux["dt"]), finite=bool(np.isfinite(
                    arrays["u"]).all()),
                cg_iters=per_step("cg_iters", int),
                rebased=per_step("rebased", lambda r: r.tolist()))


# the launch counters of the kernels on the sharded paths
COUNTERS = {"rmt_block": ("launches", "offset_launches", "advext_launches",
                           "advext_offset_launches", "no_skip_launches",
                           "advext_no_skip_launches"),
            "momentum_rk4": ("launches", "offset_launches"),
            "extrapolate_fused": ("launches", "offset_launches")}


def _counters():
    """{name: (kernel module, its launch counters)} of ``COUNTERS``."""
    import importlib

    return {m: (importlib.import_module(f"pyrmt_tpu_torch.kernels.{m}"), ns)
            for m, ns in COUNTERS.items()}


def _read_counts(counters, reset=False):
    """{'module.counter': launches} of ``_counters()``'s counters, each
    set to 0 after it is read with ``reset``."""
    out = {}
    for m, (mod, names) in counters.items():
        for n in names:
            out[f"{m}.{n}"] = getattr(mod, n)
            if reset:
                setattr(mod, n, 0)
    return out


def run_sharded_grads(cases):
    """A rank body: ``sharded_grad_case`` for each case; the list of
    their results on rank 0, None on the others."""
    import torch.distributed as dist

    out = [sharded_grad_case(**case) for case in cases]
    return out if dist.get_rank() == 0 else None


def block_energy(state):
    """sum(u^2 + v^2) + sum(p^2) of a state (a rank's block: its share of
    the global loss)."""
    import torch

    return (torch.sum(state.u ** 2 + state.v ** 2)
            + torch.sum(state.p ** 2))


def sharded_grad_case(cfg, velocity_bc, phi_inits, steps, dtype,
                      device="cuda", mesh_shape=None, rmt_method=None,
                      state0=None, t_end=1.0, traced_params=(),
                      loss="blocks", rollout=False):
    """The gradients of a sharded run under the loss contract
    (``parallel.sharding``'s note): the state's velocity times a factor
    ``scale`` (1), then ``steps`` steps of ``make_sharded_step`` with the
    scalars ``traced_params`` traced at cfg's values, through
    ``sim.make_rollout`` with ``rollout``. The global loss is
    ``block_energy`` of the final state, as the sum of the ranks' block
    losses (``loss='blocks'``) or on the gathered state divided by the
    mesh's size on each rank (``loss='gathered'``).

    Returns the global loss, d/d(scale) and d/d(each traced scalar) (each
    rank's leaf holds the whole gradient: the largest difference between
    the ranks' is returned too), the paths, and each rank's forward and
    backward milliseconds (the host clock, synchronised), kernel launches
    and peak device memory (CUDA: ``max_memory_allocated``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from pyrmt_tpu_torch.io import state_from_numpy
    from pyrmt_tpu_torch.parallel.sharding import (
        gather_state,
        make_mesh,
        make_sharded_step,
    )
    from pyrmt_tpu_torch.sim import make_init_state, make_rollout

    mesh = make_mesh(shape=mesh_shape)
    if mesh is None:
        return None
    kw = dict(dtype=dtype, device=device)
    traced = tuple(traced_params)
    step, shard = make_sharded_step(cfg, velocity_bc, phi_inits, mesh,
                                    rmt_method=rmt_method,
                                    traced_params=traced or None, **kw)
    state = (make_init_state(cfg, phi_inits, **kw) if state0 is None
             else state_from_numpy(state0, **kw))
    state = shard(state)
    leaves = {"scale": torch.ones((), **kw)}
    leaves.update({k: torch.tensor(getattr(cfg, k), **kw) for k in traced})
    for x in leaves.values():
        x.requires_grad_(True)
    t = torch.as_tensor(t_end, **kw)
    extra = ({k: leaves[k] for k in traced},) if traced else ()
    cuda = state.u.is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = _counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _read_counts(counters, reset=True)
    sync()
    t0 = time.perf_counter()
    scale = mesh.replicate(leaves["scale"])
    s = dataclasses.replace(state, u=state.u * scale, v=state.v * scale)
    if rollout:
        s = make_rollout(step, steps)(s, t, *extra)
    else:
        for _ in range(steps):
            s = step(s, t, *extra)[0]
    if loss == "blocks":
        value = block_energy(s)
    else:
        value = block_energy(gather_state(s, mesh)) / mesh.size
    sync()
    t1 = time.perf_counter()
    fwd = _read_counts(counters, reset=True)
    value.backward()
    sync()
    t2 = time.perf_counter()
    bwd = _read_counts(counters)
    grads = {k: x.grad.item() for k, x in leaves.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, (value.item(), grads, 1e3 * (t1 - t0)
                                      / steps, 1e3 * (t2 - t1) / steps,
                                      fwd, bwd, peak), group=mesh.group)
    spread = max(abs(r[1][k] - grads[k]) for r in per_rank for k in grads)
    return dict(loss=sum(r[0] for r in per_rank), grads=grads,
                grad_spread=spread, paths=dict(step.paths), mesh=mesh.shape,
                fwd_ms=[r[2] for r in per_rank],
                bwd_ms=[r[3] for r in per_rank],
                fwd_launches=[r[4] for r in per_rank],
                bwd_launches=[r[5] for r in per_rank],
                peak_bytes=[r[6] for r in per_rank])


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
