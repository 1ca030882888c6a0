"""The frozen bounds give PERF.md's bound column: rmt_block 20.0 / 320.5
us and momentum_rk4 13.8 / 220.4 us at N=1024 / 4096 in float32; in
float64 twice the bytes, which still bound both."""
import pytest

from fsibench import work


@pytest.mark.parametrize("name, N, itemsize, us", [
    ("rmt_block", 1024, 4, 20.0), ("rmt_block", 4096, 4, 320.5),
    ("momentum_rk4", 1024, 4, 13.8), ("momentum_rk4", 4096, 4, 220.4),
    ("rmt_block", 4096, 8, 641.0), ("momentum_rk4", 4096, 8, 440.7)])
def test_bound_us_gives_the_bound_column(name, N, itemsize, us):
    bound, by = work.bound_us(name, N, itemsize)
    assert round(bound, 1) == us and by == "bytes"
