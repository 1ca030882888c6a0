"""Gather-free semi-Lagrangian RK4 advection (counterpart of
``pyrmt_tpu.ops.advect.advect_semilagrangian_rk4_local``).

The other schemes (WENO5, central2, the general gather path) wait for
ROADMAP modules item 14.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.ops.interp import (
    gather_bicubic_local,
    gather_bilinear_local,
)


def advect_semilagrangian_rk4_local(qs, a, b, dt, dx, dy, interp="bilinear",
                                    cubic_mask=None):
    """Advect the stack ``qs`` (K, Ny, Nx) by the velocity (a, b) over
    ``dt`` with one shared RK4 backtrace.

    ``interp`` selects the final sample of ``qs``: 'bilinear' or 'bicubic'
    (with ``cubic_mask``, the band guard of ``gather_bicubic_local``); the
    three stage samples of (a, b) stay bilinear. Valid while the backtrace
    stays inside the 3x3 neighbourhood, which the adaptive timestep
    guarantees for CFL < 1: every stage velocity is a convex combination of
    grid values. ``dt`` may be a float or a 0-d tensor.
    """
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(
            "Unknown semi-Lagrangian interpolant %r (expected 'bilinear' or "
            "'bicubic')" % (interp,))
    ab = torch.stack([a, b])
    inv_dx = 1.0 / dx
    inv_dy = 1.0 / dy

    k1x, k1y = a, b
    k2x, k2y = gather_bilinear_local(
        ab, -0.5 * dt * k1x * inv_dx, -0.5 * dt * k1y * inv_dy)
    k3x, k3y = gather_bilinear_local(
        ab, -0.5 * dt * k2x * inv_dx, -0.5 * dt * k2y * inv_dy)
    k4x, k4y = gather_bilinear_local(
        ab, -dt * k3x * inv_dx, -dt * k3y * inv_dy)

    # dt * (-1/6), not -(dt / 6): the CUDA kernel rounds the same way
    sx = dt * (-1.0 / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x) * inv_dx
    sy = dt * (-1.0 / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y) * inv_dy
    if interp == "bicubic":
        return gather_bicubic_local(qs, sx, sy, cubic_mask=cubic_mask)
    return gather_bilinear_local(qs, sx, sy)
