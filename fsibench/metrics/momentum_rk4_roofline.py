"""momentum_rk4_roofline: the RK4 momentum update's share of its
roofline, in %: the least time of one call at the cell's N
(fsibench/work.py: 9 fields read, 10 with the external force, and 2
written once at 3.35 TB/s; bytes bound it, 220.4 us at N=4096 without the
force) over the profiler's mean device time of the rk4_kernel events."""
from fsibench import trace, work


def read(run):
    ev = run["device_events"]
    us = trace.kernel_us(ev, "rk4_kernel") if ev else []
    if not us:
        return None
    bound, _ = work.bound_us(run["work"]["momentum_rk4"], run["N"],
                             run["itemsize"])
    return 100.0 * bound * len(us) / sum(us)
