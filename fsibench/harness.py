"""One run of one cell: set-up, the measured window, the reading of the
metrics and the comparison that decides ``correct``.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration file (``configs``' ``file``), the
kind of configuration that file names (``fsibench/kinds/<kind>.py``: the
program's set-up, the inputs from the seed and the comparison with the
reference), its traffic (``fsibench/traffic/<traffic>.json``), its limits
(``fsibench/workloads/<cell>.json``) and each metric's reader
(``fsibench/metrics/<metric>.py``, ``read(run) -> float or None``).

The window drives the port's own entry: the step of
``pyrmt_tpu_torch.make_step`` from ``make_init_state``, in chunks of the
configuration's ``chunk_steps``, each ending in one host read of the
chunk's stats (t, max |u|, least J, diverged), as the validation drivers
run it (``validation.common.advance``). A CUDA event is recorded on the
stream after every step; nothing else synchronises.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from fsibench import compare

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "fsibench"


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name, man=None):
    """(the workload entry, its configuration, traffic and limits): the
    configuration from the file that its ``configs`` entry names, the
    traffic from ``fsibench/traffic/<traffic>.json``, the limits from
    ``fsibench/workloads/<cell>.json``."""
    man = man or manifest()
    work = [w for w in man["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in man["configs"] if c["name"] == w["config"]][0]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    return w, config, traffic, limits


def metrics_of(man, name, trace):
    """The metric entries a run of cell ``name`` reports: the end-to-end
    ones without the trace, the per-layer ones with it; an entry with
    ``workloads`` only in the cells it lists."""
    entries = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def reader(metric):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"fsibench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(config):
    """The module of the configuration's ``kind``
    (``fsibench/kinds/<kind>.py``): its ``Case(config, N, seed, dtype,
    device)`` builds the program and holds it to the reference."""
    name = config["kind"]
    spec = importlib.util.spec_from_file_location(
        f"fsibench_kind_{name}", HERE / "kinds" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the program -----------------------------------------------------------


def chunk_stats(state, aux):
    """One chunk's stats as the drivers log them: t, max |u|, the least J
    inside the solid, diverged (1.0) and whether the last step advanced."""
    umax = torch.sqrt(torch.amax(state.u ** 2 + state.v ** 2))
    minJ = torch.amin(torch.where(aux["phis"] <= 0.0, aux["J"],
                                  torch.full_like(aux["J"], math.inf)))
    finite = (torch.isfinite(state.u).all() & torch.isfinite(state.v).all()
              & torch.isfinite(state.p).all()
              & torch.isfinite(state.X1).all())
    bad = (~finite) | (umax > 1.0e3)
    return torch.stack([state.t.double(), umax.double(), minJ.double(),
                        bad.double(), (aux["dt"] > 0.0).double()])


class Clock:
    """A stamp after each step: CUDA events on the card (the stream's own
    clock, no synchronisation), the host clock on a CPU run."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def window(step, state, t_end, chunk, seconds, max_chunks, clock):
    """Chunks of ``chunk`` steps until ``seconds`` have passed on the host
    clock at a chunk's end (or ``max_chunks`` chunks). Returns (the last
    state, its aux, steps, wall seconds, the chunks' stats)."""
    t0 = time.perf_counter()
    clock.mark()
    steps, rows = 0, []
    while True:
        for _ in range(chunk):
            state, aux = step(state, t_end)
            clock.mark()
        steps += chunk
        rows.append(chunk_stats(state, aux).tolist())
        wall = time.perf_counter() - t0
        if wall >= seconds or len(rows) >= max_chunks:
            return state, aux, steps, wall, rows


def run_cell(name, seed, seconds, trace, device, t_start, N=None,
             dtype=None, breaker=None, max_chunks=10**9, control=False,
             physics=None):
    """One run of the cell; returns the result line's object, its last key
    ``checks``: {number: [its value, its limit]}.

    ``t_start`` is the process's start on the host clock. ``N``, ``dtype``
    and ``physics`` (keys of the configuration's ``physics``) replace the
    traffic's grid size, the configuration's type and physics,
    ``breaker(step)`` wraps the step and ``max_chunks`` caps the window,
    for the benchmark's own tests and the calibration
    (``fsibench/calibrate.py``); a run of the benchmark takes none of
    them. ``control`` adds ``control_checks``: the control's numbers in
    the program's place, and ``numbers``: both sides' readings."""
    man = manifest()
    work, config, traffic, limits = cell(name, man)
    if physics:
        config = dict(config, physics=dict(config["physics"], **physics))
    N = N or traffic["N"]
    dtype = dtype or getattr(torch, config["dtype"])
    cuda = device.type == "cuda"

    # set-up: the configuration, the initial state, a few steps
    case = kind(config).Case(config, N, seed, dtype, device)
    step, state = case.program()
    if breaker is not None:
        step = breaker(step)
    t_end = traffic["t_end"]
    # warm-up: the window's own shapes, warmup_steps steps and a stats
    # read; the first step's fields kept for the comparison
    state, aux = step(state, t_end)
    first = case.first(state, aux)
    state, _, _, _, _ = window(step, state, t_end,
                               config["warmup_steps"] - 1, 0.0, 1,
                               Clock(device))
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    clock = Clock(device)
    chunk = config["chunk_steps"]
    if trace:
        from fsibench import trace as tr

        setup_s = time.perf_counter() - t_start
        with tr.profiled(device) as rec:
            state, aux, steps, wall, rows = window(
                step, state, t_end, chunk, 0.0, 1, clock)
    else:
        setup_s = time.perf_counter() - t_start
        rec = None
        state, aux, steps, wall, rows = window(
            step, state, t_end, chunk, seconds, max_chunks, clock)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    step_ms = clock.step_ms()

    # the run's data, for the metric readers
    run = dict(name=name, config=config, traffic=traffic, N=N,
               itemsize=torch.finfo(dtype).bits // 8,
               steps=steps, wall_s=wall, step_ms=step_ms,
               peak_bytes=window_peak, setup_s=setup_s,
               device_events=None if rec is None else rec["device"],
               work=case.work)
    metrics = {}
    for m in metrics_of(man, name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(chunk for r in rows if r[3] != 0.0 or r[4] != 1.0)

    # the comparison, once the window has closed and its peak is read:
    # the kind's steps that follow the window, then the program freed
    followed = case.follow(step, state, t_end)
    del step, state, aux
    if cuda:
        torch.cuda.empty_cache()
    nums = case.numbers(first, followed)
    correct, checks = compare.judge(nums, limits["limits"])
    correct = correct and failed == 0
    checks["failed_steps"] = [failed, 0]

    result = {"correct": bool(correct), "attempted": steps,
              "failed": failed, "metrics": metrics}
    result["device"] = device_block(device, max(setup_peak, window_peak)
                                    if cuda else 0)
    if trace and rec["device"] is not None:
        from fsibench import trace as tr

        result["device"]["busy_s"] = tr.busy_us(rec["device"]) * 1e-6
        result["device"]["window_s"] = wall
        result["breakdown"] = tr.breakdown(rec["device"], rec["host"])
    if control:
        c_nums = case.control_numbers(followed)
        result["control_checks"] = compare.judge(c_nums,
                                                 limits["limits"])[1]
        result["numbers"] = {"program": nums, "control": c_nums}
    result["checks"] = checks
    return result


def device_block(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
