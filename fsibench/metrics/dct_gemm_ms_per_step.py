"""dct_gemm_ms_per_step: device ms per step of the cuBLAS matrix-product
kernels, which are the projection's DCT-I solve (4 products a solve) or,
with variable density, the CG's DCT preconditioner. A time and not a
roofline share: counting the dense DCT's 8 N^3 operations as the work
would make a faster solve of the same transform read above its peak."""
from fsibench import trace


def read(run):
    ev = run["device_events"]
    if not ev:
        return None
    us = [e.time_range.elapsed_us() for e in ev if trace.is_gemm(e.name)]
    return sum(us) * 1e-3 / run["steps"] if us else None
