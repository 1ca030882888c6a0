"""Pressure projection (counterpart of
``pyrmt_tpu.ops.projection.pressure_projection``, its incremental Neumann
and periodic branches with constant density).

Neumann walls: the divergence uses Rhie-Chow face velocities, the velocity
is corrected with the gradient of the pressure CORRECTION only, and the
pressure accumulates p = p_prev + dp, de-meaned. The two stencil chains
around the DCT solve are a pair of functions: the plain ops (the JAX
package's XLA branch) or the fused kernels (its ``stencil_bc_spec`` branch,
``projection_method='pallas'``), both in kernels/projection_stencils.py.

The doubly-periodic box: the wide central divergence, the FFT solve and
the wide central gradient on the reduced sub-grid, as plain ops on every
path (the JAX package's stencil kernels are Neumann-only, so it routes a
periodic projection through XLA under ``projection_method='pallas'`` too).
The variable-density branch waits for ROADMAP modules item 12.
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_plain,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.ops.poisson import (
    compute_divergence_periodic,
    compute_pressure_gradient_periodic,
    solve_poisson_dct,
    solve_poisson_fft,
)


def pressure_projection(a_star, b_star, dx, dy, dt, rho, velocity_bc, p_prev,
                        eigenvalues, dct_mats,
                        stencils=(rc_rhs_plain, grad_correct_plain),
                        bc_type="neumann"):
    """Project (a*, b*) onto a discretely divergence-free field.

    ``bc_type='neumann'``: ``eigenvalues`` and ``dct_mats`` are the DCT
    solve's; ``stencils`` is the (rc_rhs, grad_correct) pair of
    kernels/projection_stencils.py, the plain versions or
    ``(rc_rhs_fused, grad_correct_fused)`` for the stencil kernels.
    ``bc_type='periodic'``: ``eigenvalues`` is the (eig, null) pair of
    ``precompute_poisson_eigenvalues_periodic``; ``dct_mats`` and
    ``stencils`` are not read; the density enters the solve as its mean.
    Returns (a, b, p)."""
    if bc_type == "periodic":
        divU = compute_divergence_periodic(a_star, b_star, dx, dy)
        rhs_2d = torch.mean(rho) * divU / dt
        p_correction = solve_poisson_fft(rhs_2d, eigenvalues)
        dpdx, dpdy = compute_pressure_gradient_periodic(p_correction, dx, dy)
        a, b = velocity_bc(a_star - (dt / rho) * dpdx,
                           b_star - (dt / rho) * dpdy)
        p = p_prev + p_correction
        return a, b, p - torch.mean(p)
    if bc_type != "neumann":
        raise ValueError(f"unknown bc_type {bc_type!r}")
    rc_rhs, grad_correct = stencils
    d_scalar = dt / torch.mean(rho)
    rhs_2d = rc_rhs(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy)
    p_correction = solve_poisson_dct(rhs_2d, eigenvalues, dct_mats)
    a, b = grad_correct(p_correction, a_star, b_star, rho, dt, dx, dy,
                        velocity_bc)
    p = p_prev + p_correction
    return a, b, p - torch.mean(p)
