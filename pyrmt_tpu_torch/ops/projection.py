"""Pressure projection (counterpart of
``pyrmt_tpu.ops.projection.pressure_projection``, incremental Neumann
branch with constant density).

The divergence uses Rhie-Chow face velocities, the velocity is corrected
with the gradient of the pressure CORRECTION only, and the pressure
accumulates p = p_prev + dp, de-meaned. The periodic and variable-density
branches wait for ROADMAP modules items 12 and 13.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.ops.poisson import (
    compute_divergence_rc,
    compute_pressure_gradient,
    solve_poisson_dct,
)


def pressure_projection(a_star, b_star, dx, dy, dt, rho, velocity_bc, p_prev,
                        eigenvalues, dct_mats):
    """Project (a*, b*) onto a discretely divergence-free field.
    Returns (a, b, p)."""
    divU = compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy)
    rhs_2d = rho * divU / dt
    p_correction = solve_poisson_dct(rhs_2d, eigenvalues, dct_mats)
    dpdx, dpdy = compute_pressure_gradient(p_correction, dx, dy)
    a = a_star - (dt / rho) * dpdx
    b = b_star - (dt / rho) * dpdy
    a, b = velocity_bc(a, b)
    p = p_prev + p_correction
    return a, b, p - torch.mean(p)
