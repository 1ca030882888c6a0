"""rmt_block_roofline: the solid block's share of its roofline, in %: the
least time of one call at the cell's N (fsibench/work.py: 4 fields read
and 12 written once at 3.35 TB/s; bytes bound it, 320.5 us at N=4096) over
the profiler's mean device time of the rmt_tile_kernel events."""
from fsibench import trace, work


def read(run):
    ev = run["device_events"]
    us = trace.kernel_us(ev, "rmt_tile_kernel") if ev else []
    if not us:
        return None
    bound, _ = work.bound_us(run["work"]["rmt_block"], run["N"],
                             run["itemsize"])
    return 100.0 * bound * len(us) / sum(us)
