"""device_idle_share: 1 - device busy / wall over the traced chunk: the
union of the device events' intervals (kernels, copies, sets) against the
chunk's host-clock seconds (chip_smoke.py's profile_line arithmetic)."""
from fsibench import trace


def read(run):
    ev = run["device_events"]
    if not ev or run["wall_s"] <= 0:
        return None
    return 1.0 - trace.busy_us(ev) * 1e-6 / run["wall_s"]
