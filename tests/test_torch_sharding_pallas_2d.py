"""The port's sharded step against ``pyrmt_tpu``'s sharded step on its
shard_map Pallas path (``make_sharded_step(..., rmt_method='pallas',
interpret=True)``) and its single-device step on the (2, 2) mesh, an
off-centre disc so that the blocks' tile skips take both branches, as
tests/test_sharding.py:107-150 runs it: 2 steps, u, v and p to 1e-10, X1
and X2 to 1e-11. The helpers and the (4, 1) mesh:
tests/test_torch_sharding_pallas.py.
"""
import pytest

from test_torch_sharding_pallas import check_against, check_paths, pallas_runs


@pytest.fixture(scope="module")
def runs():
    return pallas_runs((2, 2), (0.35, 0.6, 0.2))


@pytest.mark.parametrize("against", ["jax sharded pallas", "jax single"])
def test_sharded_2x2_matches_jax(runs, against):
    check_against(runs, (2, 2), against)


def test_sharded_2x2_kernel_paths(runs):
    check_paths(runs[2], (2, 2))
