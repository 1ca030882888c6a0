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
    faces_from_cells,
    solve_poisson_dct,
    solve_poisson_fft,
    solve_variable_poisson_cg_counted,
)


def pressure_projection(a_star, b_star, dx, dy, dt, rho, velocity_bc, p_prev,
                        eigenvalues, dct_mats,
                        stencils=(rc_rhs_plain, grad_correct_plain),
                        bc_type="neumann", variable_rho=False, cg_tol=1e-6,
                        cg_maxiter=200, cg_info=False, st_faces=None,
                        mesh=None):
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
    ``cg_info`` (which needs ``variable_rho``).

    With a ``mesh`` (``parallel.sharding``) the fields are this rank's
    block of the grid, ``eigenvalues`` and ``dct_mats`` its block and rows
    (``solve_poisson_dct``); on the periodic box ``eigenvalues`` is the
    whole reduced grid's pair (``solve_poisson_fft``). The Neumann
    stencils run on slabs with a halo (``Mesh.stencil``), the periodic
    ones on wrap-padded slabs, the DCT, CG and FFT solves are distributed,
    the means are the whole grid's, and the periodic BC's overlap copy
    crosses ranks (``Mesh.overlap_copy``: the sharded periodic box takes
    ``bcs.periodic_bc``). The balanced CSF's face forces then come as a
    rank's block of the four fields of ``ops.poisson.faces_to_cells``
    (each cell's east and north face), and enter the Rhie-Chow faces on
    the same halo slabs as the velocity and the pressure."""
    if cg_info and not variable_rho:
        raise ValueError("cg_info=True requires variable_rho=True")
    if st_faces is not None and bc_type != "neumann":
        raise ValueError(
            "balanced-force st_faces requires the incremental Neumann "
            "(Rhie-Chow) projection")
    if bc_type == "periodic":
        divU = compute_divergence_periodic(a_star, b_star, dx, dy, mesh=mesh)
        rhs_2d = _mean(rho, mesh) * divU / dt
        p_correction = solve_poisson_fft(rhs_2d, eigenvalues, mesh=mesh)
        dpdx, dpdy = compute_pressure_gradient_periodic(p_correction, dx, dy,
                                                        mesh=mesh)
        a, b = a_star - (dt / rho) * dpdx, b_star - (dt / rho) * dpdy
        a, b = (velocity_bc(a, b) if mesh is None
                else mesh.overlap_copy([a, b]))
        p = p_prev + p_correction
        return a, b, p - _mean(p, mesh)
    if bc_type != "neumann":
        raise ValueError(f"unknown bc_type {bc_type!r}")
    cg_stats = None
    grad_correct = grad_correct_plain
    if variable_rho or st_faces is not None:
        # the plain Rhie-Chow chain with the face terms, the face forces
        # passed as fields so that a rank's slab holds its halo of them
        faces = () if st_faces is None else tuple(st_faces)
        d_scalar = (None if variable_rho or mesh is None
                    else dt / _mean(rho, mesh))

        def divergence(a, b, pp, r, *f):
            if f and mesh is not None:
                f = faces_from_cells(f)
            return compute_divergence_rc(a, b, pp, dt, r, dx, dy,
                                         variable_rho=variable_rho,
                                         st_faces=f or None,
                                         d_scalar=d_scalar)

        divU = _stencil(divergence, mesh)(a_star, b_star, p_prev, rho,
                                          *faces)
        if variable_rho:
            p_correction, iters, relres = solve_variable_poisson_cg_counted(
                divU / dt, 1.0 / rho, eigenvalues, dx, dy, tol=cg_tol,
                maxiter=cg_maxiter, dct_mats=dct_mats, mesh=mesh)
            cg_stats = (iters, relres)
        else:
            p_correction = solve_poisson_dct(rho * divU / dt, eigenvalues,
                                             dct_mats, mesh=mesh)
    else:
        rc_rhs, grad_correct = stencils
        d_scalar = dt / _mean(rho, mesh)
        rhs_2d = _stencil(rc_rhs, mesh)(a_star, b_star, p_prev, rho, dt,
                                        d_scalar, dx, dy)
        p_correction = solve_poisson_dct(rhs_2d, eigenvalues, dct_mats,
                                         mesh=mesh)
    a, b = _stencil(grad_correct, mesh)(p_correction, a_star, b_star, rho,
                                        dt, dx, dy, velocity_bc)
    p = p_prev + p_correction
    p = p - _mean(p, mesh)
    return (a, b, p, cg_stats) if cg_info else (a, b, p)


def _stencil(fn, mesh):
    """fn, or with a mesh fn on this rank's halo slabs (``Mesh.stencil``)."""
    return fn if mesh is None else mesh.stencil(fn)


def _mean(f, mesh):
    """The mean of f over the grid: of a rank's block with a mesh."""
    return torch.mean(f) if mesh is None else mesh.mean(f)
