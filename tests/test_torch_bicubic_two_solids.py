"""The fused tier's bicubic sample with two solids and the two-solid clamp
4 (the configuration the JAX package runs in tests/test_pallas.py),
band-guarded: ``rmt_block_plain`` against the JAX kernel
``rmt_block_fused(..., interpret=True)`` at N=32 (one tile: the
interpret-mode kernel takes ~3x as long per solid), float64, 1e-13 (J
1e-12). A file of its own, so that it runs beside tests/test_torch_bicubic.py.
"""
import numpy as np
import pytest

from test_torch_bicubic import NAMES, block_runs_of, check_block


@pytest.fixture(scope="module")
def two_solid_runs():
    return block_runs_of("two solids")


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_plain_bicubic_two_solid_block_matches_pallas_interpret(
        two_solid_runs, i):
    check_block(two_solid_runs, i)


def test_both_solids_move_and_differ_from_bilinear(two_solid_runs):
    ref, out, bil = two_solid_runs
    assert out[0].shape[0] == 2
    for s in range(2):
        assert np.abs(out[0][s] - bil[0][s]).max() > 1e-8
