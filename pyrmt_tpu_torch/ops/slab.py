"""A shard's slab of a larger grid, for the plain versions of the kernels
that take the sharding offsets (counterpart of the ``row_offset`` /
``Ny_total`` / ``col_offset`` / ``Nx_total`` operands of the JAX package's
``rmt_block_fused``, ``advext_block_fused`` and ``momentum_rk4_pallas``).

A slab is a (..., Ny, Nx) tensor whose element (0, 0) is cell
(row_offset, col_offset) of a domain of Ny_total x Nx_total cells. The
offsets may be negative: an edge shard's slab carries a zero halo beyond
the domain's edge, as the domain decomposition exchanges it
(``parallel.sharding``). Those rows and columns are never data. The slab's
valid cells end either at the domain's edge or at a cut, beyond which lie a
neighbour's cells that the slab does not hold.

``on_slab`` runs a plain function of whole fields on a slab: it crops the
zero halo beyond the domain, gives each cut one zero ghost cell, runs the
function (whose array edges are then the domain's edges where the slab
touches them, the ghosts elsewhere), strips the ghosts and pads the zeros
back. Results within a function's reach of a cut depend on cells the slab
does not hold; ``stale`` sets that many cells from each cut to 0, as the
CUDA kernels leave them. The ghost keeps the depth of that region the
kernels': a function that applies a BC or a one-sided closure at its array
edge does so at the ghost, which holds no data anyway.

Where a gradient flows the ghost is the linear extrapolation of the last
two cells in place of 0. No kept result reads it, so the values are the
same; but the backward of a discarded result at a zero ghost can be 0
times an infinite derivative (a division by a zero density), a NaN that
the stencils' sums then carry into kept cells.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def slab_axis(n, offset, total):
    """(lo, hi, g0, cut_lo, cut_hi) of a slab axis of ``n`` cells whose
    cell 0 is global cell ``offset`` of ``total``: its valid cells [lo, hi),
    the global index g0 of cell lo, and whether each end is a cut (not the
    domain's edge). ``offset`` None: the whole axis."""
    if offset is None:
        return 0, n, 0, False, False
    total = n if total is None else total
    lo, hi = max(0, -offset), min(n, total - offset)
    if hi - lo < 1:
        raise ValueError(f"a slab of {n} cells at global offset {offset} "
                         f"holds no cell of a domain of {total}")
    g0 = offset + lo
    return lo, hi, g0, g0 > 0, g0 + hi - lo < total


def has_offsets(row_offset, Ny_total, col_offset, Nx_total):
    return any(x is not None for x in (row_offset, Ny_total, col_offset,
                                       Nx_total))


def _extend(a, ghosts):
    """``a`` with ``ghosts`` = (left, right, top, bottom) cells (0 or 1)
    each the linear extrapolation of the two cells before it (the one cell
    repeated where an axis holds one), the columns first."""
    for dim, (lo, hi) in ((-1, ghosts[:2]), (-2, ghosts[2:])):
        n = a.shape[dim]
        parts = [a]
        if lo:
            e = a.narrow(dim, 0, 1)
            parts.insert(0, 2.0 * e - a.narrow(dim, 1, 1) if n > 1 else e)
        if hi:
            e = a.narrow(dim, n - 1, 1)
            parts.append(2.0 * e - a.narrow(dim, n - 2, 1) if n > 1 else e)
        a = torch.cat(parts, dim=dim)
    return a


def on_slab(fn, args, kwargs, *, row_offset=None, Ny_total=None,
            col_offset=None, Nx_total=None, stale=0, origin=False):
    """``fn(*args, **kwargs)`` on the valid cells of the slab ``args[0]``
    (the module note): every tensor argument whose last two dimensions are
    the slab's is cropped and given its ghosts; every such tensor result
    comes back at the slab's shape, ``stale`` cells from each cut and every
    cell outside the domain 0. ``origin``: ``fn`` also takes
    ``origin=(row, col, Ny_total, Nx_total)``, the global cell of its
    arrays' element (0, 0) and the domain's extents."""
    shape = tuple(args[0].shape[-2:])
    Ny, Nx = shape
    smooth = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in (*args, *kwargs.values()))
    ylo, yhi, gy, cy0, cy1 = slab_axis(Ny, row_offset, Ny_total)
    xlo, xhi, gx, cx0, cx1 = slab_axis(Nx, col_offset, Nx_total)
    ghosts = (int(cx0), int(cx1), int(cy0), int(cy1))

    def crop(a):
        if not (isinstance(a, torch.Tensor) and a.dim() >= 2
                and tuple(a.shape[-2:]) == shape):
            return a
        a = a[..., ylo:yhi, xlo:xhi]
        if smooth and a.is_floating_point():
            return _extend(a, ghosts)
        return F.pad(a, ghosts)

    if origin:
        kwargs = dict(kwargs, origin=(
            gy - ghosts[2], gx - ghosts[0],
            Ny if Ny_total is None else Ny_total,
            Nx if Nx_total is None else Nx_total))
    out = fn(*(crop(a) for a in args),
             **{k: crop(a) for k, a in kwargs.items()})
    # the kept cells of the cropped arrays: the ghosts and the stale cells
    # off, then the zeros around them back to the slab's shape
    ky0 = ghosts[2] + (stale if cy0 else 0)
    ky1 = ghosts[2] + (yhi - ylo) - (stale if cy1 else 0)
    kx0 = ghosts[0] + (stale if cx0 else 0)
    kx1 = ghosts[0] + (xhi - xlo) - (stale if cx1 else 0)
    pad = (xlo + kx0 - ghosts[0], Nx - (xlo + kx1 - ghosts[0]),
           ylo + ky0 - ghosts[2], Ny - (ylo + ky1 - ghosts[2]))
    cropped = (yhi - ylo + ghosts[2] + ghosts[3],
               xhi - xlo + ghosts[0] + ghosts[1])

    def restore(o):
        if not (isinstance(o, torch.Tensor) and o.dim() >= 2
                and tuple(o.shape[-2:]) == cropped):
            return o
        return F.pad(o[..., ky0:ky1, kx0:kx1], pad)

    if isinstance(out, (tuple, list)):
        return type(out)(restore(o) for o in out)
    return restore(out)
