"""launches_per_step: the device's kernels, copies and sets per step of
the traced chunk, counted from the profiler's device events (the
program's Python launch counters count a CUDA graph's capture, not its
replays)."""


def read(run):
    ev = run["device_events"]
    return len(ev) / run["steps"] if ev else None
