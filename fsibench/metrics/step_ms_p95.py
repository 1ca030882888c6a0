"""step_ms_p95: the 95th percentile over every step of the window, each
step the time between the CUDA events recorded after it and after the step
before (the first: after the event before the window), so a chunk's host
read and any stall count in the step that waits for it."""
import numpy as np


def read(run):
    ms = run["step_ms"]
    return float(np.percentile(ms, 95)) if ms else None
