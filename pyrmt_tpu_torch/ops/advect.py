"""Reference-map advection schemes (counterpart of
``pyrmt_tpu.ops.advect``).

  * 'semilagrangian': an RK4 backtrace of the departure points, shared by
    a whole stack of fields, then a bilinear or bicubic sample there; the
    gather-free variant (``advect_semilagrangian_rk4_local``) for a
    backtrace that stays inside the 3x3 neighbourhood (CFL < 1), the
    general gather (``advect_semilagrangian_rk4_multi``) for any other;
  * 'weno5': Jiang-Shu WENO5 upwind reconstruction with SSP-RK3, active
    where phi <= w_cut on the interior two cells in from the edge;
  * 'central2': second-order central differences with SSP-RK3, active
    where phi <= w_cut one cell in from the edge;
  * the dispatcher ``advect_reference_map_multi`` with the JAX package's
    scheme names and error.

WENO5 and central2 are whole-array expressions of edge-clamped shifts and
selects, so a stack of fields (..., Ny, Nx) with one phi per field (or one
for all) gives each field the numbers it gets alone. The near-edge
fallbacks are the JAX package's, and so is its fix of the right-biased
minus face (docs/DESIGN.md, deviation #2). The index masks are
``torch.arange`` on the operand's device: no step waits for the card.
Each SSP-RK3 stage reads 3 cells (WENO5) or 1 (central2) around a cell,
so a shard's block padded by three times that (``RK3_REACH``) gets the
whole field's values: the slab ends at the domain's edge
(``ops.slab.on_slab``), where its index is the domain's, and the
fallbacks and margins at a cut fall in the halo that is cut off.

The gather path's block (``advect_semilagrangian_rk4_multi`` with
``at``): the fields whole, the nodes a block of them.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.ops.fd import _shift_x, _shift_y
from pyrmt_tpu_torch.ops.interp import (
    gather_bicubic_local,
    gather_bicubic_multi,
    gather_bilinear_local,
    gather_bilinear_multi,
)

SCHEMES = ("semilagrangian", "central2", "weno5")
# How far the three SSP-RK3 stages of a scheme read around a cell: 3 x 3
# cells for WENO5, 3 x 1 for central2 (the halo of a shard's slab)
RK3_REACH = {"weno5": 9, "central2": 3}


def _check_interp(interp):
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(
            "Unknown semi-Lagrangian interpolant %r (expected 'bilinear' or "
            "'bicubic')" % (interp,))


def check_scheme(scheme):
    """Raise the JAX dispatcher's ValueError for an unknown scheme."""
    if scheme not in SCHEMES:
        raise ValueError(
            "Unknown advection scheme %r (expected 'semilagrangian', "
            "'central2' or 'weno5')" % (scheme,))


# ── Semi-Lagrangian RK4 ──────────────────────────────────────────────────


def backtrace_rk4(a, b, X, Y, dt, dx, dy, at=None):
    """RK4 departure points of the grid nodes (X, Y) for the velocity
    (a, b) over ``dt``: the stage velocities are bilinear samples of
    (a, b) at the intermediate points (the first stage's are (a, b)
    themselves). ``at`` = (rows, cols): (X, Y) are those nodes of the grid
    of (a, b) (a rank's block), whose first stage is (a, b) there.
    Returns (X_back, Y_back)."""
    ab = torch.stack([a, b])
    k1x, k1y = (a, b) if at is None else (a[at], b[at])
    k2x, k2y = gather_bilinear_multi(ab, X - 0.5 * dt * k1x,
                                     Y - 0.5 * dt * k1y, dx, dy)
    k3x, k3y = gather_bilinear_multi(ab, X - 0.5 * dt * k2x,
                                     Y - 0.5 * dt * k2y, dx, dy)
    k4x, k4y = gather_bilinear_multi(ab, X - dt * k3x, Y - dt * k3y, dx, dy)
    X_back = X - (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    Y_back = Y - (dt / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y)
    return X_back, Y_back


def advect_semilagrangian_rk4_multi(qs, a, b, X, Y, dt, dx, dy,
                                    interp="bilinear", cubic_mask=None,
                                    at=None):
    """Advect the stack ``qs`` (K, Ny, Nx) with one shared RK4 backtrace
    (``backtrace_rk4``) and a gather at the departure points, however far
    they lie: bilinear, or with ``interp='bicubic'`` Catmull-Rom clamped to
    its stencil, bilinear where ``cubic_mask`` is False (the band guard).
    A non-finite departure point gives NaN; the others are clamped into
    the domain. ``at`` = (rows, cols): the fields are the whole grid's and
    (X, Y), ``cubic_mask`` and the result those nodes' (a rank's block of
    a domain decomposition), each node's value the whole grid's."""
    _check_interp(interp)
    X_back, Y_back = backtrace_rk4(a, b, X, Y, dt, dx, dy, at)
    if interp == "bicubic":
        return gather_bicubic_multi(qs, X_back, Y_back, dx, dy,
                                    cubic_mask=cubic_mask)
    return gather_bilinear_multi(qs, X_back, Y_back, dx, dy)


def advect_semilagrangian_rk4(q, a, b, X, Y, dt, dx, dy):
    """One field (Ny, Nx): ``advect_semilagrangian_rk4_multi`` with the
    bilinear gather."""
    return advect_semilagrangian_rk4_multi(q[None], a, b, X, Y, dt, dx,
                                           dy)[0]


def advect_semilagrangian_rk4_local(qs, a, b, dt, dx, dy, interp="bilinear",
                                    cubic_mask=None, origin=None):
    """Advect the stack ``qs`` (K, Ny, Nx) by the velocity (a, b) over
    ``dt`` with one shared RK4 backtrace.

    ``interp`` selects the final sample of ``qs``: 'bilinear' or 'bicubic'
    (with ``cubic_mask``, the band guard of ``gather_bicubic_local``); the
    three stage samples of (a, b) stay bilinear. Valid while the backtrace
    stays inside the 3x3 neighbourhood, which the adaptive timestep
    guarantees for CFL < 1: every stage velocity is a convex combination of
    grid values. ``dt`` may be a float or a 0-d tensor. ``origin`` makes
    the fields a slab of a larger domain (``interp.gather_bilinear_local``).
    """
    _check_interp(interp)
    ab = torch.stack([a, b])
    inv_dx = 1.0 / dx
    inv_dy = 1.0 / dy

    k1x, k1y = a, b
    k2x, k2y = gather_bilinear_local(
        ab, -0.5 * dt * k1x * inv_dx, -0.5 * dt * k1y * inv_dy, origin)
    k3x, k3y = gather_bilinear_local(
        ab, -0.5 * dt * k2x * inv_dx, -0.5 * dt * k2y * inv_dy, origin)
    k4x, k4y = gather_bilinear_local(
        ab, -dt * k3x * inv_dx, -dt * k3y * inv_dy, origin)

    # dt * (-1/6), not -(dt / 6): the CUDA kernel rounds the same way
    sx = dt * (-1.0 / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x) * inv_dx
    sy = dt * (-1.0 / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y) * inv_dy
    if interp == "bicubic":
        return gather_bicubic_local(qs, sx, sy, cubic_mask=cubic_mask,
                                    origin=origin)
    return gather_bilinear_local(qs, sx, sy, origin)


# ── WENO5 reconstruction ─────────────────────────────────────────────────


def _weno5_left(vm2, vm1, v0, vp1, vp2):
    """Left-biased WENO5 value at i+1/2."""
    eps = 1.0e-6
    r0 = (2.0 * vm2 - 7.0 * vm1 + 11.0 * v0) / 6.0
    r1 = (-vm1 + 5.0 * v0 + 2.0 * vp1) / 6.0
    r2 = (2.0 * v0 + 5.0 * vp1 - vp2) / 6.0
    b0 = (13.0 / 12.0) * (vm2 - 2.0 * vm1 + v0) ** 2 \
        + 0.25 * (vm2 - 4.0 * vm1 + 3.0 * v0) ** 2
    b1 = (13.0 / 12.0) * (vm1 - 2.0 * v0 + vp1) ** 2 + 0.25 * (vm1 - vp1) ** 2
    b2 = (13.0 / 12.0) * (v0 - 2.0 * vp1 + vp2) ** 2 \
        + 0.25 * (3.0 * v0 - 4.0 * vp1 + vp2) ** 2
    a0 = 0.1 / (eps + b0) ** 2
    a1 = 0.6 / (eps + b1) ** 2
    a2 = 0.3 / (eps + b2) ** 2
    s = a0 + a1 + a2
    return (a0 * r0 + a1 * r1 + a2 * r2) / s


def _weno5_right(vm1, v0, vp1, vp2, vp3):
    """Right-biased WENO5 value at i+1/2."""
    eps = 1.0e-6
    r0 = (2.0 * vp3 - 7.0 * vp2 + 11.0 * vp1) / 6.0
    r1 = (-vp2 + 5.0 * vp1 + 2.0 * v0) / 6.0
    r2 = (2.0 * vp1 + 5.0 * v0 - vm1) / 6.0
    b0 = (13.0 / 12.0) * (vp3 - 2.0 * vp2 + vp1) ** 2 \
        + 0.25 * (3.0 * vp1 - 4.0 * vp2 + vp3) ** 2
    b1 = (13.0 / 12.0) * (vp2 - 2.0 * vp1 + v0) ** 2 + 0.25 * (vp2 - v0) ** 2
    b2 = (13.0 / 12.0) * (vp1 - 2.0 * v0 + vm1) ** 2 \
        + 0.25 * (vp1 - 4.0 * v0 + 3.0 * vm1) ** 2
    a0 = 0.1 / (eps + b0) ** 2
    a1 = 0.6 / (eps + b1) ** 2
    a2 = 0.3 / (eps + b2) ** 2
    s = a0 + a1 + a2
    return (a0 * r0 + a1 * r1 + a2 * r2) / s


def _weno5_deriv_1d(q, vel, h, shift):
    """Upwind WENO5 d(q)/dxi along the axis of ``shift`` (``_shift_x`` or
    ``_shift_y``): the face values at i +- 1/2 chosen by sign(vel), with
    the near-edge fallbacks of pyRMT (the left-biased plus face where
    i + 3 >= N, the unshifted left-biased minus face where i < 3) and the
    right-biased minus face on {i-2 .. i+2} (pyRMT passes the unshifted
    plus-face stencil there, which zeroes d(q)/dxi under a negative
    wind)."""
    qm3, qm2, qm1 = shift(q, -3), shift(q, -2), shift(q, -1)
    qp1, qp2, qp3 = shift(q, 1), shift(q, 2), shift(q, 3)

    along_x = shift is _shift_x
    n = q.shape[-1] if along_x else q.shape[-2]
    idx = torch.arange(n, device=q.device)
    idx = idx[None, :] if along_x else idx[:, None]

    plus_left = _weno5_left(qm2, qm1, q, qp1, qp2)
    plus_right = _weno5_right(qm1, q, qp1, qp2, qp3)
    plus_right = torch.where(idx + 3 >= n, plus_left, plus_right)
    q_plus = torch.where(vel >= 0.0, plus_left, plus_right)

    minus_left = _weno5_left(qm3, qm2, qm1, q, qp1)
    minus_left = torch.where(idx < 3, plus_left, minus_left)
    minus_right = _weno5_right(qm2, qm1, q, qp1, qp2)
    q_minus = torch.where(vel >= 0.0, minus_left, minus_right)
    return (q_plus - q_minus) / h


def _interior(q, phi, w_cut, margin):
    """Where the banded RHS is active: phi <= w_cut, ``margin`` cells or
    more from every edge."""
    Ny, Nx = q.shape[-2:]
    jj = torch.arange(Ny, device=q.device)[:, None]
    ii = torch.arange(Nx, device=q.device)[None, :]
    return ((phi <= w_cut) & (jj >= margin) & (jj <= Ny - 1 - margin)
            & (ii >= margin) & (ii <= Nx - 1 - margin))


def weno5_rhs(q, a, b, dx, dy, phi, w_cut):
    """-(a dq/dx + b dq/dy) with the WENO5 derivatives, where phi <= w_cut
    on the interior two cells in from the edge, 0 elsewhere. ``q`` is
    (Ny, Nx) or a stack (K, Ny, Nx); ``phi`` broadcasts against it."""
    dqdx = _weno5_deriv_1d(q, a, dx, _shift_x)
    dqdy = _weno5_deriv_1d(q, b, dy, _shift_y)
    rhs = -(a * dqdx + b * dqdy)
    return torch.where(_interior(q, phi, w_cut, 2), rhs, 0.0)


def advect_weno5_rk3(q, a, b, dx, dy, dt, phi, w_cut=0.0):
    """WENO5 with the three-stage SSP-RK3 (Shu-Osher)."""
    q1 = q + dt * weno5_rhs(q, a, b, dx, dy, phi, w_cut)
    q2 = 0.75 * q + 0.25 * (q1 + dt * weno5_rhs(q1, a, b, dx, dy, phi,
                                                 w_cut))
    return (1.0 / 3.0) * q + (2.0 / 3.0) * (
        q2 + dt * weno5_rhs(q2, a, b, dx, dy, phi, w_cut))


# ── 2nd-order central + SSP-RK3 ──────────────────────────────────────────


def central2_rhs(q, a, b, dx, dy, phi, w_cut):
    """-(a dq/dx + b dq/dy) with second-order central differences, where
    phi <= w_cut one cell in from the edge, 0 elsewhere."""
    dqdx = (_shift_x(q, 1) - _shift_x(q, -1)) * (0.5 / dx)
    dqdy = (_shift_y(q, 1) - _shift_y(q, -1)) * (0.5 / dy)
    rhs = -(a * dqdx + b * dqdy)
    return torch.where(_interior(q, phi, w_cut, 1), rhs, 0.0)


def advect_central2_rk3(q, a, b, dx, dy, dt, phi, w_cut=0.0):
    """Central-2 with the three-stage SSP-RK3."""
    q1 = q + dt * central2_rhs(q, a, b, dx, dy, phi, w_cut)
    q2 = 0.75 * q + 0.25 * (q1 + dt * central2_rhs(q1, a, b, dx, dy, phi,
                                                    w_cut))
    return (1.0 / 3.0) * q + (2.0 / 3.0) * (
        q2 + dt * central2_rhs(q2, a, b, dx, dy, phi, w_cut))


# ── Dispatcher ───────────────────────────────────────────────────────────


def advect_reference_map_multi(qs, a, b, X, Y, dt, dx, dy, phi,
                               scheme="semilagrangian", w_cut=0.0,
                               sl_interp="bilinear", sl_cubic_mask=None,
                               sl_at=None):
    """Advect the stack ``qs`` (K, Ny, Nx) with ``scheme``.
    'semilagrangian' samples with ``sl_interp`` (bicubic under the band
    guard ``sl_cubic_mask``) at the nodes ``sl_at`` of
    ``advect_semilagrangian_rk4_multi`` and ignores ``phi``; 'central2' and
    'weno5' band with ``phi`` and ``w_cut``, ``phi`` (Ny, Nx) for every
    field or (K, Ny, Nx), one per field, and evaluate the whole stack at
    once."""
    check_scheme(scheme)
    if scheme == "semilagrangian":
        return advect_semilagrangian_rk4_multi(qs, a, b, X, Y, dt, dx, dy,
                                               interp=sl_interp,
                                               cubic_mask=sl_cubic_mask,
                                               at=sl_at)
    rk3 = advect_central2_rk3 if scheme == "central2" else advect_weno5_rk3
    return rk3(qs, a, b, dx, dy, dt, phi, w_cut)


def advect_reference_map(q, a, b, X, Y, dt, dx, dy, phi,
                         scheme="semilagrangian", w_cut=0.0):
    """One field (Ny, Nx): ``advect_reference_map_multi``."""
    return advect_reference_map_multi(q[None], a, b, X, Y, dt, dx, dy, phi,
                                      scheme, w_cut)[0]
