"""The split tier's two kernel blocks, as plain PyTorch versions, against
the JAX package's Pallas kernels run in interpret mode on the CPU.

- ``advext_block_plain`` against ``advext_block_fused(..., interpret=True)``
  at N=64 (the recipe of tests/test_pallas.py: the flagship disc, a
  Taylor-Green velocity) with a pre-advection phi that is not the analytic
  rebuild: float64, 1e-13. A stack of two solids is two one-solid blocks.
- ``extrapolate_reference_map`` against
  ``extrapolate_reference_map_fused(..., interpret=True)`` on the interior
  and the edge disc of tests/test_extrap.py, 1 and 3 layers: 1e-12. The
  edge disc at 4 layers (halo == tile) is in
  tests/test_torch_extrap_edge.py, so that the two files run side by
  side.

The CUDA kernels are held to these plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu_torch.kernels.extrapolate_fused as ef
import pyrmt_tpu_torch.kernels.rmt_block as rb
from pyrmt_tpu.kernels.extrapolate_fused import (
    extrapolate_reference_map_fused as j_extrap_fused,
)
from pyrmt_tpu.kernels.rmt_block import advext_block_fused as j_advext
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map

torch.set_num_threads(1)

N = 64
DX = 1.0 / (N - 1)


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def advext_case(S, seed=0):
    """Map stacks seeded with the identity inside S discs and extrapolated
    3 cells, a Taylor-Green velocity, and pre-advection level sets shifted
    and wobbled off the analytic discs, so mask and known cells differ from
    the map's own rebuild."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    centres = [(0.6, 0.5, 0.2), (0.25, 0.3, 0.12)][:S]
    X1s, X2s, phis = [], [], []
    for cx, cy, R in centres:
        phi = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2) - R
        m = (phi <= 0.0).astype(np.float64)
        x1, x2 = extrapolate_reference_map(tt(X * m), tt(Y * m), tt(phi), DX,
                                           DX, 3)
        X1s.append(x1.numpy())
        X2s.append(x2.numpy())
        a = rng.uniform(-0.4, 0.4)
        phis.append(phi + a * DX + 0.3 * DX * np.sin(4 * np.pi * X)
                    * np.cos(2 * np.pi * Y))
    u = 0.3 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    return u, v, np.stack(X1s), np.stack(X2s), np.stack(phis), 1e-3


def test_advext_plain_matches_pallas_interpret():
    u, v, X1s, X2s, phis, dt = advext_case(1)
    ref = j_advext(*(jnp.asarray(a) for a in (u, v, X1s, X2s, phis)),
                   jnp.asarray(dt), dx=DX, dy=DX, num_layers=3,
                   interpret=True)
    out = rb.advext_block_plain(*(tt(a) for a in (u, v, X1s, X2s, phis,
                                                   dt)),
                                dx=DX, dy=DX, num_layers=3)
    for o, r in zip(out, ref):
        assert o.shape == (1, N, N)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-13)
    # the block moved the map and grew it past the solid
    assert float((out[0] - tt(X1s)).abs().max()) > 0.0
    assert int((out[0][0] != 0).sum()) > int((tt(phis[0]) <= 0).sum())


def test_advext_stack_is_per_solid():
    u, v, X1s, X2s, phis, dt = (tt(a) for a in advext_case(2))
    kw = dict(dx=DX, dy=DX, num_layers=3)
    both = rb.advext_block_plain(u, v, X1s, X2s, phis, dt, **kw)
    for i in range(2):
        one = rb.advext_block_plain(u, v, X1s[i:i + 1], X2s[i:i + 1],
                                    phis[i:i + 1], dt, **kw)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])


def extrapolation_case(disc, layers, tile):
    """(plain, Pallas-interpret) extrapolations of the identity map inside
    ``disc`` = (x0, y0, R)."""
    cx, cy, R = disc
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    phi = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2) - R
    m = (phi < 0).astype(np.float64)
    ref = j_extrap_fused(jnp.asarray(X * m), jnp.asarray(Y * m),
                         jnp.asarray(phi), DX, DX, layers, tile=tile,
                         interpret=True)
    out = extrapolate_reference_map(tt(X * m), tt(Y * m), tt(phi), DX, DX,
                                    layers)
    return [o.numpy() for o in out], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("disc, tile", [((0.55, 0.45, 0.22), 32),
                                        ((0.08, 0.90, 0.15), 16)],
                         ids=["interior", "edge"])
def test_extrapolation_matches_pallas_interpret(disc, tile, layers):
    out, ref = extrapolation_case(disc, layers, tile)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors both wrappers run their plain versions and launch
    nothing."""
    args = [tt(a) for a in advext_case(1)]
    kw = dict(dx=DX, dy=DX, num_layers=3)
    before = (rb.advext_launches, ef.launches)
    for a, b in zip(rb.advext_block_fused(*args, **kw),
                    rb.advext_block_plain(*args, **kw)):
        assert torch.equal(a, b)
    X1, X2, phi = args[2][0], args[3][0], args[4][0]
    for a, b in zip(ef.extrapolate_reference_map_fused(X1, X2, phi, DX, DX, 3),
                    extrapolate_reference_map(X1, X2, phi, DX, DX, 3)):
        assert torch.equal(a, b)
    assert (rb.advext_launches, ef.launches) == before


def test_extrapolation_kernel_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA card has no kernel and no
    plain fallback: the wrapper raises, and launches nothing."""
    X1 = torch.zeros((8, 8), dtype=torch.float64, device="meta")
    before = ef.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ef.extrapolate_reference_map_fused(X1, X1, X1, DX, DX, 3)
    assert ef.launches == before
