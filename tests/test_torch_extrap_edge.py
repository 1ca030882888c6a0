"""The plain extrapolation against the Pallas kernel in interpret mode on
the edge disc of tests/test_extrap.py: a disc clipped by the domain edge,
4 layers, halo == tile (16 rows). See tests/test_torch_split.py."""
import numpy as np
import torch

from test_torch_split import extrapolation_case

torch.set_num_threads(1)


def test_edge_extrapolation_matches_pallas_interpret():
    out, ref = extrapolation_case((0.08, 0.90, 0.15), 4, 16)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)
