"""Finite-difference stencils (counterpart of ``pyrmt_tpu.ops.fd``).

Whole-array expressions built from slices and concatenation, with the same
one-sided boundary closures and the same order of floating-point operations
as the JAX package, so the two agree to roundoff. The ``*_periodic``
stencils of the doubly-periodic box wrap on the overlap grid instead of
closing one-sidedly.
"""
from __future__ import annotations

import torch


def grad_central_x_2nd(f, dx):
    """d/dx: 2nd-order central interior, 2nd-order one-sided boundary
    columns."""
    inv = 1.0 / (2.0 * dx)
    interior = (f[:, 2:] - f[:, :-2]) * inv
    left = (-3.0 * f[:, 0:1] + 4.0 * f[:, 1:2] - f[:, 2:3]) * inv
    right = (3.0 * f[:, -1:] - 4.0 * f[:, -2:-1] + f[:, -3:-2]) * inv
    return torch.cat([left, interior, right], dim=1)


def grad_central_y_2nd(f, dy):
    """d/dy: 2nd-order central interior, 2nd-order one-sided boundary rows."""
    inv = 1.0 / (2.0 * dy)
    interior = (f[2:, :] - f[:-2, :]) * inv
    bottom = (-3.0 * f[0:1, :] + 4.0 * f[1:2, :] - f[2:3, :]) * inv
    top = (3.0 * f[-1:, :] - 4.0 * f[-2:-1, :] + f[-3:-2, :]) * inv
    return torch.cat([bottom, interior, top], dim=0)


def grad_central_x_4th(f, dx):
    """d/dx: 4th-order central interior, the 2nd-order central stencil in
    the second and last-but-one columns, 2nd-order one-sided boundary
    columns."""
    inv12 = 1.0 / (12.0 * dx)
    inv2 = 1.0 / (2.0 * dx)
    interior = (-f[:, 4:] + 8.0 * f[:, 3:-1] - 8.0 * f[:, 1:-3]
                + f[:, 0:-4]) * inv12
    c1 = (f[:, 2:3] - f[:, 0:1]) * inv2
    cm2 = (f[:, -1:] - f[:, -3:-2]) * inv2
    left = (-3.0 * f[:, 0:1] + 4.0 * f[:, 1:2] - f[:, 2:3]) * inv2
    right = (3.0 * f[:, -1:] - 4.0 * f[:, -2:-1] + f[:, -3:-2]) * inv2
    return torch.cat([left, c1, interior, cm2, right], dim=1)


def grad_central_y_4th(f, dy):
    """d/dy: ``grad_central_x_4th`` down the rows."""
    inv12 = 1.0 / (12.0 * dy)
    inv2 = 1.0 / (2.0 * dy)
    interior = (-f[4:, :] + 8.0 * f[3:-1, :] - 8.0 * f[1:-3, :]
                + f[0:-4, :]) * inv12
    r1 = (f[2:3, :] - f[0:1, :]) * inv2
    rm2 = (f[-1:, :] - f[-3:-2, :]) * inv2
    bottom = (-3.0 * f[0:1, :] + 4.0 * f[1:2, :] - f[2:3, :]) * inv2
    top = (3.0 * f[-1:, :] - 4.0 * f[-2:-1, :] + f[-3:-2, :]) * inv2
    return torch.cat([bottom, r1, interior, rm2, top], dim=0)


def lap_2nd(f, dx, dy):
    """The 2nd-order Laplacian, with 2nd-order one-sided closures on the
    boundary rows and columns."""
    cx = 1.0 / dx**2
    cy = 1.0 / dy**2
    dxx_i = (f[:, 2:] - 2.0 * f[:, 1:-1] + f[:, 0:-2]) * cx
    dxx_l = (2.0 * f[:, 0:1] - 5.0 * f[:, 1:2] + 4.0 * f[:, 2:3]
             - f[:, 3:4]) * cx
    dxx_r = (2.0 * f[:, -1:] - 5.0 * f[:, -2:-1] + 4.0 * f[:, -3:-2]
             - f[:, -4:-3]) * cx
    dxx = torch.cat([dxx_l, dxx_i, dxx_r], dim=1)
    dyy_i = (f[2:, :] - 2.0 * f[1:-1, :] + f[0:-2, :]) * cy
    dyy_b = (2.0 * f[0:1, :] - 5.0 * f[1:2, :] + 4.0 * f[2:3, :]
             - f[3:4, :]) * cy
    dyy_t = (2.0 * f[-1:, :] - 5.0 * f[-2:-1, :] + 4.0 * f[-3:-2, :]
             - f[-4:-3, :]) * cy
    dyy = torch.cat([dyy_b, dyy_i, dyy_t], dim=0)
    return dxx + dyy


def _shift_x(f, k):
    """f shifted so output[..., j, i] = f[..., j, i + k]; out-of-range
    columns hold edge values. ``f`` is (Ny, Nx) or a stack (..., Ny, Nx)."""
    if k == 0:
        return f
    lead = f.shape[:-1]
    if k > 0:
        return torch.cat([f[..., k:], f[..., -1:].expand(*lead, k)], dim=-1)
    return torch.cat([f[..., :1].expand(*lead, -k), f[..., :k]], dim=-1)


def _shift_y(f, k):
    """f shifted so output[..., j, i] = f[..., j + k, i]; edge-padded."""
    if k == 0:
        return f
    lead, nx = f.shape[:-2], f.shape[-1]
    if k > 0:
        return torch.cat([f[..., k:, :], f[..., -1:, :].expand(*lead, k, nx)],
                         dim=-2)
    return torch.cat([f[..., :1, :].expand(*lead, -k, nx), f[..., :k, :]],
                     dim=-2)


def diff_upwind_3rd(f, u, h, axis):
    """3rd-order upwind-biased derivative, 1st-order upwind boundary
    fallback. ``axis=1`` is d/dx, ``axis=0`` is d/dy. The first index always
    takes the forward difference, the last the backward one, indices 1 and
    N-2 the 1st-order upwind one by sign(u)."""
    sx = _shift_x if axis == 1 else _shift_y
    fp1, fp2 = sx(f, 1), sx(f, 2)
    fm1, fm2 = sx(f, -1), sx(f, -2)

    inv_h = 1.0 / h
    backward = (f - fm1) * inv_h
    forward = (fp1 - f) * inv_h
    first = torch.where(u > 0, backward, forward)

    inv_6h = 1.0 / (6.0 * h)
    pos = (2.0 * fp1 + 3.0 * f - 6.0 * fm1 + fm2) * inv_6h
    neg = (-fp2 + 6.0 * fp1 - 3.0 * f - 2.0 * fm1) * inv_6h
    third = torch.where(u > 0, pos, neg)

    n = f.shape[axis]
    idx = torch.arange(n, device=f.device)
    idx = idx[None, :] if axis == 1 else idx[:, None]
    boundary = (idx < 2) | (idx > n - 3)
    out = torch.where(boundary, first, third)
    out = torch.where(idx == 0, forward, out)
    return torch.where(idx == n - 1, backward, out)


def wrap_pad_x(f, k):
    """``k`` periodic ghost columns each side on the overlap grid, where
    column N-1 duplicates column 0 (the layout of the periodic solver,
    ops/poisson.py ``tile_overlap``): the left ghosts are columns
    N-1-k..N-2 and the right ghosts columns 1..k."""
    return torch.cat([f[:, -1 - k:-1], f, f[:, 1:1 + k]], dim=1)


def wrap_pad_y(f, k):
    return torch.cat([f[-1 - k:-1, :], f, f[1:1 + k, :]], dim=0)


def grad_central_x_2nd_periodic(f, dx):
    """2nd-order central d/dx with the overlap-grid wrap and no one-sided
    closures: columns 0 and N-1 read the same neighbours."""
    p = wrap_pad_x(f, 1)
    return (p[:, 2:] - p[:, :-2]) * (1.0 / (2.0 * dx))


def grad_central_y_2nd_periodic(f, dy):
    p = wrap_pad_y(f, 1)
    return (p[2:, :] - p[:-2, :]) * (1.0 / (2.0 * dy))


def diff_upwind_3rd_periodic(f, u, h, axis):
    """The interior formula of ``diff_upwind_3rd`` everywhere, with wrapped
    shifts and no boundary fallbacks."""
    if axis == 1:
        p = wrap_pad_x(f, 2)
        sh = lambda k: p[:, 2 + k: 2 + k + f.shape[1]]  # noqa: E731
    else:
        p = wrap_pad_y(f, 2)
        sh = lambda k: p[2 + k: 2 + k + f.shape[0], :]  # noqa: E731
    fp1, fp2, fm1, fm2 = sh(1), sh(2), sh(-1), sh(-2)
    inv_6h = 1.0 / (6.0 * h)
    pos = (2.0 * fp1 + 3.0 * f - 6.0 * fm1 + fm2) * inv_6h
    neg = (-fp2 + 6.0 * fp1 - 3.0 * f - 2.0 * fm1) * inv_6h
    return torch.where(u > 0, pos, neg)


def solve3x3_sym(a00, a01, a02, a11, a12, a22, b0, b1, b2, det_eps=1e-10):
    """Per-cell Cramer solve of a symmetric 3x3 system. Returns
    (x, y, z, det, ok); ``ok`` marks |det| > det_eps, the solution is zero
    elsewhere."""
    det = (
        a00 * (a11 * a22 - a12 * a12)
        - a01 * (a01 * a22 - a12 * a02)
        + a02 * (a01 * a12 - a11 * a02)
    )
    ok = torch.abs(det) > det_eps
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))

    x = (
        b0 * (a11 * a22 - a12 * a12)
        - a01 * (b1 * a22 - a12 * b2)
        + a02 * (b1 * a12 - a11 * b2)
    ) * inv_det
    y = (
        a00 * (b1 * a22 - a12 * b2)
        - b0 * (a01 * a22 - a12 * a02)
        + a02 * (a01 * b2 - b1 * a02)
    ) * inv_det
    z = (
        a00 * (a11 * b2 - b1 * a12)
        - a01 * (a01 * b2 - b1 * a02)
        + b0 * (a01 * a12 - a11 * a02)
    ) * inv_det

    zero = torch.zeros_like(x)
    return (
        torch.where(ok, x, zero),
        torch.where(ok, y, zero),
        torch.where(ok, z, zero),
        det,
        ok,
    )
