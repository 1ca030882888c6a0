"""Pressure projection (counterpart of
``pyrmt_tpu.ops.projection.pressure_projection``, its incremental Neumann
and periodic branches).

Neumann walls: the divergence uses Rhie-Chow face velocities, the velocity
is corrected with the gradient of the pressure CORRECTION only, and the
pressure accumulates p = p_prev + dp, de-meaned. With constant density the
two stencil chains around the DCT solve are a pair of functions: the plain
ops (the JAX package's XLA branch) or the fused kernels (its
``stencil_bc_spec`` branch, ``projection_method='pallas'``), both in
kernels/projection_stencils.py. With ``variable_rho`` the correction is the
DCT-preconditioned CG solve of grad.((1/rho) grad dp) = div / dt, and with
the balanced-force CSF's face forces (``st_faces``) they enter the
Rhie-Chow faces; both run as plain ops, as in the JAX package, whose
stencil kernels have neither.

The doubly-periodic box: the wide central divergence, the FFT solve and
the wide central gradient on the reduced sub-grid, as plain ops on every
path (the JAX package's stencil kernels are Neumann-only, so it routes a
periodic projection through XLA under ``projection_method='pallas'`` too).
"""
from __future__ import annotations

import torch

from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_plain,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.ops.poisson import (
    compute_divergence_periodic,
    compute_divergence_rc,
    compute_pressure_gradient_periodic,
    solve_poisson_dct,
    solve_poisson_fft,
    solve_variable_poisson_cg_counted,
)


def pressure_projection(a_star, b_star, dx, dy, dt, rho, velocity_bc, p_prev,
                        eigenvalues, dct_mats,
                        stencils=(rc_rhs_plain, grad_correct_plain),
                        bc_type="neumann", variable_rho=False, cg_tol=1e-6,
                        cg_maxiter=200, cg_info=False, st_faces=None):
    """Project (a*, b*) onto a discretely divergence-free field.

    ``bc_type='neumann'``: ``eigenvalues`` and ``dct_mats`` are the DCT
    solve's; ``stencils`` is the (rc_rhs, grad_correct) pair of
    kernels/projection_stencils.py, the plain versions or
    ``(rc_rhs_fused, grad_correct_fused)`` for the stencil kernels, run
    with constant density and no face forces. ``variable_rho`` solves for
    the correction with the CG (tolerance ``cg_tol``, at most
    ``cg_maxiter`` iterations); ``st_faces`` are the balanced-force CSF's
    (Fx_face, Fy_face, fx_cell, fy_cell). ``bc_type='periodic'``:
    ``eigenvalues`` is the (eig, null) pair of
    ``precompute_poisson_eigenvalues_periodic``; ``dct_mats`` and
    ``stencils`` are not read; the density enters the solve as its mean.
    Returns (a, b, p), or (a, b, p, (cg_iters, cg_relres)) with
    ``cg_info`` (which needs ``variable_rho``)."""
    if cg_info and not variable_rho:
        raise ValueError("cg_info=True requires variable_rho=True")
    if st_faces is not None and bc_type != "neumann":
        raise ValueError(
            "balanced-force st_faces requires the incremental Neumann "
            "(Rhie-Chow) projection")
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
    cg_stats = None
    if variable_rho:
        divU = compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy,
                                     variable_rho=True, st_faces=st_faces)
        p_correction, iters, relres = solve_variable_poisson_cg_counted(
            divU / dt, 1.0 / rho, eigenvalues, dx, dy, tol=cg_tol,
            maxiter=cg_maxiter, dct_mats=dct_mats)
        cg_stats = (iters, relres)
        grad_correct = grad_correct_plain
    elif st_faces is not None:
        divU = compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy,
                                     st_faces=st_faces)
        p_correction = solve_poisson_dct(rho * divU / dt, eigenvalues,
                                         dct_mats)
        grad_correct = grad_correct_plain
    else:
        rc_rhs, grad_correct = stencils
        d_scalar = dt / torch.mean(rho)
        rhs_2d = rc_rhs(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy)
        p_correction = solve_poisson_dct(rhs_2d, eigenvalues, dct_mats)
    a, b = grad_correct(p_correction, a_star, b_star, rho, dt, dx, dy,
                        velocity_bc)
    p = p_prev + p_correction
    p = p - torch.mean(p)
    return (a, b, p, cg_stats) if cg_info else (a, b, p)
