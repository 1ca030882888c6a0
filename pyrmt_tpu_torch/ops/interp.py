"""Bilinear and bicubic (Catmull-Rom) sampling (counterpart of
``pyrmt_tpu.ops.interp``): the general gathers at physical points and the
gather-free samplings at sub-cell displacements. The bicubic samples are
clamped to the min/max of their 4x4 stencil, and a ``cubic_mask`` (the
reference map's band guard) takes the bilinear sample where it is False.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.ops.fd import _shift_x, _shift_y


def _prepare_queries(xq, yq, dx, dy, Nx, Ny):
    """Grid coordinates of the queries, clamped into the domain (before any
    integer conversion), and the mask of finite queries."""
    x = xq / dx
    y = yq / dy
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.clamp(torch.where(finite, x, 0.0), 0.0, Nx - 1.0)
    y = torch.clamp(torch.where(finite, y, 0.0), 0.0, Ny - 1.0)
    return x, y, finite


def _check_extents(u, Nx, Ny):
    """JAX's ``Nx, Ny`` arguments: the port reads the extents from ``u``,
    and raises where given ones disagree."""
    if (Nx is not None and Nx != u.shape[-1]) or (
            Ny is not None and Ny != u.shape[-2]):
        raise ValueError(f"Nx, Ny = {Nx}, {Ny} disagree with the field's "
                         f"shape {tuple(u.shape)}")


def bilinear_interpolate(u, xq, yq, dx, dy, Nx=None, Ny=None):
    """Bilinear interpolation of ``u`` (Ny, Nx) at the physical points
    (xq, yq); a non-finite query gives NaN. ``Nx`` and ``Ny`` are the JAX
    signature's, checked against ``u.shape``."""
    _check_extents(u, Nx, Ny)
    return gather_bilinear_multi(u[None], xq, yq, dx, dy)[0]


def gather_bilinear_multi(us, xq, yq, dx, dy):
    """Bilinear interpolation of a stack ``us`` (K, Ny, Nx) at the same
    query points, with the indices and weights computed once."""
    K, Ny, Nx = us.shape
    x, y, finite = _prepare_queries(xq, yq, dx, dy, Nx, Ny)

    ix = torch.clamp(torch.floor(x).to(torch.int64), 0, Nx - 2)
    iy = torch.clamp(torch.floor(y).to(torch.int64), 0, Ny - 2)
    fx = (x - ix).to(us.dtype)
    fy = (y - iy).to(us.dtype)

    v00 = us[:, iy, ix]
    v10 = us[:, iy, ix + 1]
    v01 = us[:, iy + 1, ix]
    v11 = us[:, iy + 1, ix + 1]

    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy
    out = w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11
    return torch.where(finite, out, float("nan"))


def _cell_indices(shape, origin, like):
    """The global (row, column) indices of a (Ny, Nx) array as ``like``'s
    dtype, (Ny, 1) and (1, Nx), and the domain's extents: the array itself,
    or with ``origin`` = (row, col, Ny_total, Nx_total) a slab whose
    element (0, 0) is cell (row, col) of a Ny_total x Nx_total domain."""
    Ny, Nx = shape
    j0, i0, Nyt, Nxt = (0, 0, Ny, Nx) if origin is None else origin
    kw = dict(dtype=like.dtype, device=like.device)
    return (torch.arange(j0, j0 + Ny, **kw)[:, None],
            torch.arange(i0, i0 + Nx, **kw)[None, :], Nyt, Nxt)


def gather_bilinear_local(us, sx, sy, origin=None):
    """Bilinear sampling of a stack ``us`` (K, Ny, Nx) at per-cell displaced
    points (i + sx[j, i], j + sy[j, i]) with |sx|, |sy| < 1.

    The 4 corners are among the 9 edge-clamped shifts of the field and are
    selected per cell by the signs of the displacement AT THE OUTPUT CELL.
    Displacements are clipped into (-1, 1) and queries clamped into the
    domain; non-finite displacements give NaN. ``origin`` (row, col,
    Ny_total, Nx_total) makes ``us`` a slab of a larger domain (a shard's,
    ``ops.slab``): the indices and the clamps are then the domain's, as the
    CUDA kernel's, so a slab's samples round as the whole field's; at the
    slab's own edges the shifts replicate the edge.
    """
    K, Ny, Nx = us.shape
    jj, ii, Ny, Nx = _cell_indices((Ny, Nx), origin, sx)

    finite = torch.isfinite(sx) & torch.isfinite(sy)
    zero = torch.zeros((), dtype=sx.dtype, device=sx.device)
    sx = torch.where(finite, sx, zero)
    sy = torch.where(finite, sy, zero)
    eps = 1e-6
    sx = torch.clamp(sx, -1.0 + eps, 1.0 - eps)
    sy = torch.clamp(sy, -1.0 + eps, 1.0 - eps)
    x = torch.clamp(ii + sx, 0.0, Nx - 1.0)
    y = torch.clamp(jj + sy, 0.0, Ny - 1.0)
    sx = x - ii
    sy = y - jj

    neg_x = sx < 0.0
    neg_y = sy < 0.0
    fx = torch.where(neg_x, sx + 1.0, sx).to(us.dtype)
    fy = torch.where(neg_y, sy + 1.0, sy).to(us.dtype)
    # i = Nx-1 with s >= 0 must use the cell to the left with weight 1,
    # which reproduces the clamped gather exactly
    one = torch.ones((), dtype=us.dtype, device=us.device)
    at_right = (ii >= Nx - 1.0) & ~neg_x
    neg_x = neg_x | at_right
    fx = torch.where(at_right, one, fx)
    at_top = (jj >= Ny - 1.0) & ~neg_y
    neg_y = neg_y | at_top
    fy = torch.where(at_top, one, fy)

    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy

    vals = []
    for k in range(K):
        f = us[k]
        f_xm1 = _shift_x(f, -1)
        f_xp1 = _shift_x(f, 1)
        f_ym1 = _shift_y(f, -1)
        f_yp1 = _shift_y(f, 1)
        f_xm1_ym1 = _shift_y(f_xm1, -1)
        f_xp1_ym1 = _shift_y(f_xp1, -1)
        f_xm1_yp1 = _shift_y(f_xm1, 1)
        f_xp1_yp1 = _shift_y(f_xp1, 1)
        v00 = torch.where(neg_x, torch.where(neg_y, f_xm1_ym1, f_xm1),
                          torch.where(neg_y, f_ym1, f))
        v10 = torch.where(neg_x, torch.where(neg_y, f_ym1, f),
                          torch.where(neg_y, f_xp1_ym1, f_xp1))
        v01 = torch.where(neg_x, torch.where(neg_y, f_xm1, f_xm1_yp1),
                          torch.where(neg_y, f, f_yp1))
        v11 = torch.where(neg_x, torch.where(neg_y, f, f_yp1),
                          torch.where(neg_y, f_xp1, f_xp1_yp1))
        vals.append(w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11)

    out = torch.stack(vals)
    return torch.where(finite[None], out, torch.full_like(out, float("nan")))


# The bicubic stencil's shifts: output[j, i] = f[j, i + k] (f[j + k, i]),
# the index clipped into the grid, which reproduces the gathers' per-index
# clipping for any overflow. fd's shifts already replicate the edge.
_shift_x_pad = _shift_x
_shift_y_pad = _shift_y


def cubic_convolution(v0, v1, v2, v3, t):
    """Catmull-Rom cubic along one axis, with the terms in the JAX
    package's order (the CUDA sampler rounds the same way)."""
    a0 = -0.5 * v0 + 1.5 * v1 - 1.5 * v2 + 0.5 * v3
    a1 = v0 - 2.5 * v1 + 2.0 * v2 - 0.5 * v3
    a2 = -0.5 * v0 + 0.5 * v2
    return ((a0 * t + a1) * t + a2) * t + v1


def gather_bicubic_local(us, sx, sy, cubic_mask=None, origin=None):
    """Bicubic sampling of a stack ``us`` (K, Ny, Nx) at per-cell displaced
    points (i + sx[j, i], j + sy[j, i]) with |sx|, |sy| < 1.

    The 4x4 stencil is among the 25 edge-clamped shifts of the field by up
    to +-2, all taken before the per-cell select by the signs of the
    displacement AT THE OUTPUT CELL (shifting a selected array would read a
    neighbour's signs). The sample is clamped to its stencil's min/max;
    where ``cubic_mask`` (bool, broadcastable to the output) is False the
    bilinear sample at the clipped displacement is taken instead.
    Displacements are clipped as in ``gather_bilinear_local``; non-finite
    displacements give NaN. ``origin`` as in ``gather_bilinear_local``.
    """
    K, Ny, Nx = us.shape
    jj, ii, Ny, Nx = _cell_indices((Ny, Nx), origin, sx)

    finite = torch.isfinite(sx) & torch.isfinite(sy)
    zero = torch.zeros((), dtype=sx.dtype, device=sx.device)
    sx = torch.where(finite, sx, zero)
    sy = torch.where(finite, sy, zero)
    eps = 1e-6
    sx = torch.clamp(sx, -1.0 + eps, 1.0 - eps)
    sy = torch.clamp(sy, -1.0 + eps, 1.0 - eps)
    x = torch.clamp(ii + sx, 0.0, Nx - 1.0)
    y = torch.clamp(jj + sy, 0.0, Ny - 1.0)
    sx = x - ii
    sy = y - jj

    # floor(i + s): the stencil's base is i - 1 for s < 0, else i
    neg_x = sx < 0.0
    neg_y = sy < 0.0
    fx = torch.where(neg_x, sx + 1.0, sx).to(us.dtype)
    fy = torch.where(neg_y, sy + 1.0, sy).to(us.dtype)

    vals = []
    for k in range(K):
        f = us[k]
        sh = {}

        def shifted(ky, kx, f=f, sh=sh):
            if (ky, kx) not in sh:
                sh[(ky, kx)] = _shift_x_pad(_shift_y_pad(f, ky), kx)
            return sh[(ky, kx)]

        local_min = local_max = None
        rows = []
        for m in range(4):
            cols = []
            for n in range(4):
                v = torch.where(
                    neg_y,
                    torch.where(neg_x, shifted(m - 2, n - 2),
                                shifted(m - 2, n - 1)),
                    torch.where(neg_x, shifted(m - 1, n - 2),
                                shifted(m - 1, n - 1)))
                cols.append(v)
                local_min = (v if local_min is None
                             else torch.minimum(local_min, v))
                local_max = (v if local_max is None
                             else torch.maximum(local_max, v))
            rows.append(cubic_convolution(*cols, fx))
        out = cubic_convolution(*rows, fy)
        vals.append(torch.clamp(out, local_min, local_max))

    out = torch.stack(vals)
    if cubic_mask is not None:
        out = torch.where(cubic_mask, out,
                          gather_bilinear_local(us, sx, sy, origin))
    return torch.where(finite[None], out, torch.full_like(out, float("nan")))


def _bicubic_stencil(us, xq, yq, dx, dy):
    """The clamped bicubic sample of the stack ``us`` at physical points,
    and the mask of finite queries: the 4x4 stencil's global indices each
    clipped into the grid."""
    K, Ny, Nx = us.shape
    x, y, finite = _prepare_queries(xq, yq, dx, dy, Nx, Ny)
    ix = torch.floor(x).to(torch.int64)
    iy = torch.floor(y).to(torch.int64)
    fx = (x - ix).to(us.dtype)
    fy = (y - iy).to(us.dtype)

    rows = []
    shape = (K,) + tuple(x.shape)
    local_min = torch.full(shape, float("inf"), dtype=us.dtype,
                           device=us.device)
    local_max = torch.full(shape, float("-inf"), dtype=us.dtype,
                           device=us.device)
    for m in range(4):
        yg = torch.clamp(iy - 1 + m, 0, Ny - 1)
        cols = []
        for n in range(4):
            xg = torch.clamp(ix - 1 + n, 0, Nx - 1)
            v = us[:, yg, xg]
            cols.append(v)
            local_min = torch.minimum(local_min, v)
            local_max = torch.maximum(local_max, v)
        rows.append(cubic_convolution(*cols, fx))
    out = cubic_convolution(*rows, fy)
    return torch.clamp(out, local_min, local_max), finite


def gather_bicubic_multi(us, xq, yq, dx, dy, cubic_mask=None):
    """Bicubic interpolation of a stack ``us`` (K, Ny, Nx) at the same
    physical query points, with each field's sample clamped to its 4x4
    stencil's min/max. Where ``cubic_mask`` is False the bilinear sample is
    taken instead; a non-finite query gives NaN."""
    out, finite = _bicubic_stencil(us, xq, yq, dx, dy)
    if cubic_mask is not None:
        out = torch.where(cubic_mask, out,
                          gather_bilinear_multi(us, xq, yq, dx, dy))
    return torch.where(finite, out, float("nan"))


def bicubic_interpolate(u, xq, yq, dx, dy, Nx=None, Ny=None):
    """Bicubic interpolation of ``u`` (Ny, Nx) at the physical points
    (xq, yq), clamped to the stencil's min/max; a non-finite query gives
    NaN. ``Nx`` and ``Ny`` as in ``bilinear_interpolate``."""
    _check_extents(u, Nx, Ny)
    out, finite = _bicubic_stencil(u[None], xq, yq, dx, dy)
    return torch.where(finite, out[0], float("nan"))
