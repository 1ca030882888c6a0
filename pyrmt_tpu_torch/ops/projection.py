"""Pressure projection (counterpart of
``pyrmt_tpu.ops.projection.pressure_projection``, incremental Neumann
branch with constant density).

The divergence uses Rhie-Chow face velocities, the velocity is corrected
with the gradient of the pressure CORRECTION only, and the pressure
accumulates p = p_prev + dp, de-meaned. The two stencil chains around the
DCT solve are a pair of functions: the plain ops (the JAX package's XLA
branch) or the fused kernels (its ``stencil_bc_spec`` branch,
``projection_method='pallas'``), both in kernels/projection_stencils.py.
The periodic and variable-density branches wait for ROADMAP modules items
12 and 13.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_plain,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.ops.poisson import solve_poisson_dct


def pressure_projection(a_star, b_star, dx, dy, dt, rho, velocity_bc, p_prev,
                        eigenvalues, dct_mats,
                        stencils=(rc_rhs_plain, grad_correct_plain)):
    """Project (a*, b*) onto a discretely divergence-free field.
    ``stencils`` is the (rc_rhs, grad_correct) pair of
    kernels/projection_stencils.py: the plain versions, or
    ``(rc_rhs_fused, grad_correct_fused)`` for the stencil kernels.
    Returns (a, b, p)."""
    rc_rhs, grad_correct = stencils
    d_scalar = dt / torch.mean(rho)
    rhs_2d = rc_rhs(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy)
    p_correction = solve_poisson_dct(rhs_2d, eigenvalues, dct_mats)
    a, b = grad_correct(p_correction, a_star, b_star, rho, dt, dx, dy,
                        velocity_bc)
    p = p_prev + p_correction
    return a, b, p - torch.mean(p)
