"""Narrow-band extrapolation of the reference map into the fluid
(counterpart of ``pyrmt_tpu.ops.extrapolate.extrapolate_reference_map``).

Each sweep grows (X1, X2) by one layer from the known cells: a frontier cell
(unknown, interior, with a known 3x3 neighbour) receives the constant term of
a Gaussian-weighted least-squares plane fit over the known cells of its 9x9
window, fitted in cell-offset coordinates. The sweeps are layer-synchronous
(all frontier cells fit against the previous layer only): docs/DESIGN.md
deviation #1, kept on purpose. Window taps outside the domain read zero.
With the sharding offsets the fields are a shard's slab (``ops.slab``).
"""
from __future__ import annotations

import numpy as np
import torch

from pyrmt_tpu_torch.ops.fd import _shift_x, _shift_y, solve3x3_sym
from pyrmt_tpu_torch.ops.slab import has_offsets, on_slab

_WIN = 4  # window half-width: 9x9 window


def _kernels_1d(dx, dy):
    """Separable 1D factors of the 9x9 normal-equation kernels, as host
    float64 arrays: the Gaussian weight factorises as wx(di) * wy(dj), and
    every moment kernel is an outer product of 1D factors."""
    offs = np.arange(-_WIN, _WIN + 1, dtype=np.float64)
    r_sq = (4.0 * np.sqrt(dx**2 + dy**2)) ** 2
    wx = np.exp(-((offs * dx) ** 2) / r_sq)
    wy = np.exp(-((offs * dy) ** 2) / r_sq)
    ones = np.ones_like(offs)
    fx = {"1": ones, "wx": wx, "wxd": wx * offs, "wxd2": wx * offs * offs}
    fy = {"1": ones, "wy": wy, "wyd": wy * offs, "wyd2": wy * offs * offs}
    return fx, fy


def _shift_zero(f, k, dim):
    """f shifted by ``k`` along ``dim`` (output[i] = f[i + k]) with zero
    fill."""
    if k == 0:
        return f
    n = f.shape[dim]
    z = torch.zeros_like(f.narrow(dim, 0, abs(k)))
    if k > 0:
        return torch.cat([f.narrow(dim, k, n - k), z], dim=dim)
    return torch.cat([z, f.narrow(dim, 0, n + k)], dim=dim)


def _corr1d_multi(f, taps_list, dim):
    """Correlate ``f`` with several 9-tap kernels along ``dim``, summing
    the taps in ascending offset order and skipping zero taps."""
    accs = [None] * len(taps_list)
    for k in range(-_WIN, _WIN + 1):
        s = _shift_zero(f, k, dim)
        for m, taps in enumerate(taps_list):
            w = float(taps[k + _WIN])
            if w == 0.0:
                continue
            term = s * w if w != 1.0 else s
            accs[m] = term if accs[m] is None else accs[m] + term
    return accs


def _normal_equations_separable(kf, kX1, kX2, fx, fy):
    """The 13 normal-equation correlations as an x pass then a y pass."""
    k_1, k_wx, k_wxd, k_wxd2 = _corr1d_multi(
        kf, [fx["1"], fx["wx"], fx["wxd"], fx["wxd2"]], 1)
    x1_wx, x1_wxd = _corr1d_multi(kX1, [fx["wx"], fx["wxd"]], 1)
    x2_wx, x2_wxd = _corr1d_multi(kX2, [fx["wx"], fx["wxd"]], 1)

    count = _corr1d_multi(k_1, [fy["1"]], 0)[0]
    s00, s02, s22 = _corr1d_multi(k_wx, [fy["wy"], fy["wyd"], fy["wyd2"]], 0)
    s01, s12 = _corr1d_multi(k_wxd, [fy["wy"], fy["wyd"]], 0)
    s11 = _corr1d_multi(k_wxd2, [fy["wy"]], 0)[0]
    b1_0, b1_2 = _corr1d_multi(x1_wx, [fy["wy"], fy["wyd"]], 0)
    b1_1 = _corr1d_multi(x1_wxd, [fy["wy"]], 0)[0]
    b2_0, b2_2 = _corr1d_multi(x2_wx, [fy["wy"], fy["wyd"]], 0)
    b2_1 = _corr1d_multi(x2_wxd, [fy["wy"]], 0)[0]
    return (count, s00, s01, s02, s11, s12, s22,
            b1_0, b1_1, b1_2, b2_0, b2_1, b2_2)


def _interior_mask(Ny, Nx, device):
    jj = torch.arange(Ny, device=device)[:, None]
    ii = torch.arange(Nx, device=device)[None, :]
    return (jj > 0) & (jj < Ny - 1) & (ii > 0) & (ii < Nx - 1)


def _frontier_mask(known, interior, dtype):
    """Unknown interior cells with a known 3x3 neighbour."""
    kf = known.to(dtype)
    row_max = torch.maximum(torch.maximum(_shift_x(kf, -1), kf),
                            _shift_x(kf, 1))
    neigh = torch.maximum(torch.maximum(_shift_y(row_max, -1), row_max),
                          _shift_y(row_max, 1))
    return (~known) & (neigh > 0.0) & interior


def _dense_layer(X1e, X2e, known, frontier, fx, fy):
    """One layer-synchronous sweep over the whole grid."""
    kf = known.to(X1e.dtype)
    (count, a00, a01, a02, a11, a12, a22,
     b1_0, b1_1, b1_2, b2_0, b2_1, b2_2) = _normal_equations_separable(
        kf, kf * X1e, kf * X2e, fx, fy)
    # offset-coordinate fit: the plane's value at the cell is the constant
    # coefficient; det threshold in offset units
    c1_0, _, _, _, ok = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b1_0, b1_1, b1_2, det_eps=1e-10)
    c2_0, _, _, _, _ = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b2_0, b2_1, b2_2, det_eps=1e-10)
    accept = frontier & (count >= 3.0) & ok
    return (torch.where(accept, c1_0, X1e), torch.where(accept, c2_0, X2e),
            known | accept)


def extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers, *,
                              row_offset=None, Ny_total=None,
                              col_offset=None, Nx_total=None):
    """Extrapolate (X1, X2) from the solid (phi < 0) ``max_layers`` cells
    into the fluid. Returns (X1_ext, X2_ext).

    ``row_offset``, ``Ny_total``, ``col_offset``, ``Nx_total`` (the JAX
    kernels' sharding operands) make the fields one shard's slab
    (``ops.slab.on_slab``): the interior predicate and the window's zero
    taps are the domain's, and the results are 0 within 4 ``max_layers``
    cells of a cut (each sweep reads a 9x9 window: 4 cells) and outside
    the domain, as the CUDA kernel leaves them."""
    if has_offsets(row_offset, Ny_total, col_offset, Nx_total):
        return on_slab(extrapolate_reference_map, (X1, X2, phi),
                       dict(dx=dx, dy=dy, max_layers=max_layers),
                       row_offset=row_offset, Ny_total=Ny_total,
                       col_offset=col_offset, Nx_total=Nx_total,
                       stale=4 * max_layers)
    Ny, Nx = X1.shape
    fx, fy = _kernels_1d(dx, dy)
    interior = _interior_mask(Ny, Nx, X1.device)
    known = phi < 0.0
    X1e, X2e = X1, X2
    for _ in range(max_layers):
        frontier = _frontier_mask(known, interior, X1.dtype)
        X1e, X2e, known = _dense_layer(X1e, X2e, known, frontier, fx, fy)
    return X1e, X2e
