"""The yardstick of the kernels' roofline shares: the work of one call and
the card's published peaks.

A frozen copy of ``chip_smoke.py``'s ``WORK``, ``HBM_BYTES_PER_S``,
``F32_OPS_PER_S`` and ``bound_us`` (the rows the benchmark's cells run):
each input field read once and each output field written once at 3.35
TB/s, or the operations at 67 TFLOP/s (the H100 SXM's HBM rate and its
float32 peak off the tensor cores), whichever takes longer. Beside the
copy: the float64 peak off the tensor cores, 34 TFLOP/s, for a float64
call's operations.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

WORK = {  # name: (fields read, fields written, operations per cell)
    "rmt_block": (4, 12, 200),
    "momentum_rk4": (9, 2, 400),
}


def bound_us(name, N, itemsize=4):
    """(the least device time of one call on an N x N grid in
    microseconds, what bounds it: 'bytes' or 'operations')."""
    read, written, ops = WORK[name]
    cells = N * N
    t_bytes = 1e6 * (read + written) * cells * itemsize / HBM_BYTES_PER_S
    peak = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_ops = 1e6 * ops * cells / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
