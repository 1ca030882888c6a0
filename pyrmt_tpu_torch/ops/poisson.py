"""Poisson solves and the divergence/gradient companions of the projection
(counterpart of the constant-density part of ``pyrmt_tpu.ops.poisson``).

Neumann walls: the DCT-I runs as dense matrix products
``C_y @ rhs @ C_x^T``, the same transform as the JAX package's
rFFT-of-the-even-extension path. The even/odd fold of the JAX matmul path
is a TPU layout device and is not carried over. The products run in full
precision: the step module turns TF32 off.

The doubly-periodic box: an FFT solve on the reduced (Ny-1, Nx-1) sub-grid
of the overlap grid (``torch.fft`` per axis, cuFFT on the card; the JAX
package runs it as XLA's FFT, outside any Pallas kernel).

Variable density under Neumann walls: the matrix-free operator
grad.((1/rho) grad p) (``apply_variable_poisson``), symmetrised by the
trapezoidal boundary weights and solved by conjugate gradients
preconditioned with the DCT solve (``solve_variable_poisson_cg_counted``).
The loop's stopping test is the one host read of the step: the port runs
``CG_READ_EVERY`` iterations between reads, each masked by a flag on the
device, so the solve stops at the iteration the JAX package's
``lax.while_loop`` stops at.
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pyrmt_tpu_torch.kernels._autograd import needs_grad

# the cell-centred gradients of the JAX module are the fd stencils
from pyrmt_tpu_torch.ops.fd import grad_central_x_2nd as _grad_x_cc
from pyrmt_tpu_torch.ops.fd import grad_central_y_2nd as _grad_y_cc


def dct1_matrix(N, dtype=torch.float32, device="cuda"):
    """Dense unnormalised DCT-I matrix: C[k, n] = w_n cos(pi k n / (N-1)),
    w_0 = w_{N-1} = 1, else 2 (scipy ``dctn(type=1)`` convention)."""
    k = np.arange(N)[:, None]
    n = np.arange(N)[None, :]
    w = np.full(N, 2.0)
    w[0] = w[-1] = 1.0
    C = np.cos(np.pi * k * n / (N - 1)) * w[None, :]
    return torch.as_tensor(C, dtype=dtype, device=device)


def precompute_dct_matrices(Nx, Ny, dtype=torch.float32, device="cuda"):
    """(C_x, C_y) for ``solve_poisson_dct``."""
    return dct1_matrix(Nx, dtype, device), dct1_matrix(Ny, dtype, device)


def precompute_poisson_eigenvalues(Nx, Ny, dx, dy, dtype=torch.float64,
                                   device="cuda"):
    """Eigenvalues of the ghost-mirror Neumann Laplacian under DCT-I,
    lambda = -2(1 - cos(pi k/(N-1)))/h^2; the (0, 0) mode is pinned to 1
    (the mean is removed separately)."""
    lam_x = -2.0 * (1.0 - np.cos(np.pi * np.arange(Nx) / (Nx - 1))) / dx**2
    lam_y = -2.0 * (1.0 - np.cos(np.pi * np.arange(Ny) / (Ny - 1))) / dy**2
    eig = lam_x[None, :] + lam_y[:, None]
    eig[0, 0] = 1.0
    return torch.as_tensor(eig, dtype=dtype, device=device)


def solve_poisson_dct(rhs_2d, eigenvalues, dct_mats, demean=True,
                      mesh=None):
    """Direct Neumann solve: forward DCT-I, divide by the eigenvalues,
    inverse DCT-I (the forward transform over 4 (Nx-1)(Ny-1)), de-mean.
    ``demean=False`` leaves the mean, as the variable-density CG's
    preconditioner needs (it zeroes the constant mode by an infinite
    eigenvalue instead, which keeps it symmetric).

    With a ``mesh`` (``parallel.sharding``) ``rhs_2d`` and ``eigenvalues``
    are this rank's block, and ``dct_mats`` this rank's rows of C_x and
    C_y ((lx, Nx), (ly, Ny)): each product C_y @ f @ C_x^T is this rank's
    rows of C_y times the column strip of f gathered over the ranks that
    share its columns, then the row strip of that gathered over the ranks
    that share its rows, times its rows of C_x transposed; the mean is
    the whole grid's. On CUDA tensors the products go through cuBLASLt
    (``_block_products``)."""
    Cx, Cy = dct_mats
    Ny, Nx = Cy.shape[1], Cx.shape[1]
    if mesh is None:
        rhs_hat = Cy @ rhs_2d @ Cx.T
        p_hat = rhs_hat / eigenvalues
        p = (Cy @ p_hat @ Cx.T) / (4.0 * (Nx - 1) * (Ny - 1))
        return p - torch.mean(p) if demean else p

    def transform(f):
        return mesh.gather_cols(Cy @ mesh.gather_rows(f)) @ Cx.T

    with _block_products(rhs_2d):
        p_hat = transform(rhs_2d) / eigenvalues
        p = transform(p_hat) / (4.0 * (Nx - 1) * (Ny - 1))
    return p - mesh.mean(p) if demean else p


@contextlib.contextmanager
def _block_products(like):
    """cuBLASLt for the matrix products of a rank's rows where ``like`` is
    a CUDA tensor, the preferred BLAS library restored after. On the H100
    its float32 products of a rank's rows of C_y or C_x equal the rows of
    the whole products of the single-device solve (default cuBLAS) bit for
    bit at N=2048 on the (2, 2), (4, 1), (1, 4) and (2, 4) meshes, where
    cuBLAS's differ by up to 1e-4 of their size, as much as a float32 solve
    differs from a float64 one; at N=1024 the first of them still differs
    (PERF.md section 6). Float64 products agree bit for bit under
    either."""
    if like.device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_blas_library(prev)


def compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy,
                          variable_rho=False, st_faces=None, d_scalar=None):
    """Rhie-Chow face-velocity divergence, zero on the boundary ring: face
    velocities are corrected by d times the difference of the compact face
    pressure gradient and the average of the cell-centred ones. d is dt /
    mean(rho), or with ``variable_rho`` dt times the face mean of 1/rho;
    ``d_scalar`` passes the constant d in, as the projection's stencil
    kernel takes it. ``st_faces`` = (Fx_face, Fy_face, fx_cell, fy_cell),
    the balanced-force CSF's face forces and their cell means
    (``physics.balanced_csf_forces``), enter the face velocities as the
    pressure gradient does, with the opposite sign."""
    dpdx_cc = _grad_x_cc(p_prev, dx)
    dpdy_cc = _grad_y_cc(p_prev, dy)

    u_face = 0.5 * (a_star[:, :-1] + a_star[:, 1:])
    face_dpdx = (p_prev[:, 1:] - p_prev[:, :-1]) / dx
    avg_dpdx = 0.5 * (dpdx_cc[:, :-1] + dpdx_cc[:, 1:])

    v_face = 0.5 * (b_star[:-1, :] + b_star[1:, :])
    face_dpdy = (p_prev[1:, :] - p_prev[:-1, :]) / dy
    avg_dpdy = 0.5 * (dpdy_cc[:-1, :] + dpdy_cc[1:, :])

    if variable_rho:
        inv_rho = 1.0 / rho
        d_f_x = dt * 0.5 * (inv_rho[:, :-1] + inv_rho[:, 1:])
        d_f_y = dt * 0.5 * (inv_rho[:-1, :] + inv_rho[1:, :])
    else:
        d_f_x = d_f_y = dt / torch.mean(rho) if d_scalar is None else d_scalar

    if st_faces is not None:
        Fx_face, Fy_face, fx_cell, fy_cell = st_faces
        face_dpdx = face_dpdx - Fx_face
        avg_dpdx = avg_dpdx - 0.5 * (fx_cell[:, :-1] + fx_cell[:, 1:])
        face_dpdy = face_dpdy - Fy_face
        avg_dpdy = avg_dpdy - 0.5 * (fy_cell[:-1, :] + fy_cell[1:, :])

    u_face_rc = u_face - d_f_x * (face_dpdx - avg_dpdx)
    v_face_rc = v_face - d_f_y * (face_dpdy - avg_dpdy)

    div_i = (u_face_rc[1:-1, 1:] - u_face_rc[1:-1, :-1]) / dx + (
        v_face_rc[1:, 1:-1] - v_face_rc[:-1, 1:-1]) / dy
    return F.pad(div_i, (1, 1, 1, 1))


def faces_to_cells(st_faces):
    """The balanced CSF's ``st_faces`` (Fx_face (Ny, Nx - 1), Fy_face
    (Ny - 1, Nx), fx_cell, fy_cell) as four (Ny, Nx) fields, the layout of
    a rank's block in a domain decomposition: each cell's east and north
    face (x, y growing with the column and the row), 0 in the last column
    and row, where the face lies beyond the domain."""
    Fx, Fy, fx_cell, fy_cell = st_faces
    return F.pad(Fx, (0, 1)), F.pad(Fy, (0, 0, 0, 1)), fx_cell, fy_cell


def faces_from_cells(fields):
    """``faces_to_cells``'s inverse: the faces of the whole fields (or of a
    slab, ``ops.slab.on_slab``), the last column and row dropped."""
    Fx, Fy, fx_cell, fy_cell = fields
    return Fx[:, :-1], Fy[:-1, :], fx_cell, fy_cell


def compute_pressure_gradient(p, dx, dy):
    """Central interior and one-sided boundary pressure gradient; the
    tangential component is zero on the boundary rows and columns, as in the
    reference."""
    Ny, Nx = p.shape
    jj = torch.arange(Ny, device=p.device)[:, None]
    ii = torch.arange(Nx, device=p.device)[None, :]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)

    row_interior = (jj > 0) & (jj < Ny - 1)
    col_boundary = (ii == 0) | (ii == Nx - 1)
    dpdx = torch.where(col_boundary | row_interior, _grad_x_cc(p, dx), zero)

    col_interior = (ii > 0) & (ii < Nx - 1)
    row_boundary = (jj == 0) | (jj == Ny - 1)
    dpdy = torch.where(row_boundary | col_interior, _grad_y_cc(p, dy), zero)
    return dpdx, dpdy


# The doubly-periodic (FFT) solver on the reduced sub-grid


def precompute_poisson_eigenvalues_periodic(Nx, Ny, dx, dy,
                                            dtype=torch.float64,
                                            device="cuda"):
    """The Fourier symbol of the wide central div(grad), -sin(2 pi k/m)^2
    / h^2, on the reduced (Ny-1, Nx-1) periodic sub-grid. Returns
    (eig, null): the constant and Nyquist (checkerboard) null modes are
    pinned to 1 in eig and flagged in the bool tensor null."""
    mx, my = Nx - 1, Ny - 1
    lam_x = -((np.sin(2.0 * np.pi * np.arange(mx) / mx) / dx) ** 2)
    lam_y = -((np.sin(2.0 * np.pi * np.arange(my) / my) / dy) ** 2)
    eig = lam_x[None, :] + lam_y[:, None]
    null = np.abs(eig) < 1e-12
    eig = eig.copy()
    eig[null] = 1.0
    return (torch.as_tensor(eig, dtype=dtype, device=device),
            torch.as_tensor(null, device=device))


def tile_overlap(field_reduced, Ny, Nx):
    """Pad a reduced (Ny-1, Nx-1) periodic field to the overlap grid: the
    last column and row repeat the first."""
    top = torch.cat([field_reduced, field_reduced[:, 0:1]], dim=1)
    return torch.cat([top, top[0:1, :]], dim=0)


def solve_poisson_fft(rhs_full, eigenvalues_periodic, mesh=None):
    """Direct periodic Poisson solve on the reduced sub-grid: de-mean, an
    FFT along x then y (complex64 for float32, complex128 for float64, as
    ``jnp.fft`` makes them), divide by the symbol, zero the null modes, the
    inverse FFTs, the real part tiled to the overlap grid, de-mean.

    With a ``mesh`` (``parallel.sharding``) ``rhs_full`` is this rank's
    block of the overlap grid and ``eigenvalues_periodic`` the whole
    reduced grid's pair. The overlap row and column belong to the last
    rank along each axis, so that rank's block of the reduced grid is a
    row or a column short. Each 1D FFT runs along whole rows or whole
    columns: the row strip of the ranks that share this rank's rows
    (``Mesh.gather_cols``), or the column strip of those that share its
    columns, of which each rank keeps its own columns or rows; the
    overlap row and column come from their owners (``Mesh.overlap_copy``)
    and the means are the whole grid's."""
    eig, null = eigenvalues_periodic
    if mesh is not None:
        return _solve_poisson_fft_mesh(rhs_full, eig, null, mesh)
    Ny, Nx = rhs_full.shape
    r = rhs_full[:-1, :-1]
    r = r - torch.mean(r)
    rhat = torch.fft.fft(torch.fft.fft(r, dim=1), dim=0)
    phat = rhat / eig.to(rhat.real.dtype)
    phat = torch.where(null, 0.0, phat)
    g = torch.fft.ifft(torch.fft.ifft(phat, dim=1), dim=0)
    p = tile_overlap(g.real.to(rhs_full.dtype), Ny, Nx)
    return p - torch.mean(p)


def _reduced_block(mesh, ly, lx):
    """This rank's block of the reduced (Ny - 1, Nx - 1) grid: (its first
    row, its rows, its first column, its columns)."""
    (ry, rx), (iy, ix) = mesh.shape, mesh.coords
    return (iy * ly, ly - (iy == ry - 1), ix * lx, lx - (ix == rx - 1))


def _strip(mesh, z, rows):
    """The whole rows (``rows``) or whole columns of the reduced grid from
    the ranks' blocks ``z`` of it (real or complex): the last rank's short
    block padded to gather, the pad cut off."""
    cplx = z.is_complex()
    parts = torch.stack([z.real, z.imag]) if cplx else z
    (ry, rx), (iy, ix) = mesh.shape, mesh.coords
    if rows:
        full = z.shape[-1] + (ix == rx - 1)
        parts = mesh.gather_cols(F.pad(parts, (0, full - z.shape[-1])))
        parts = parts[..., :full * rx - 1]
    else:
        full = z.shape[-2] + (iy == ry - 1)
        parts = mesh.gather_rows(F.pad(parts,
                                       (0, 0, 0, full - z.shape[-2])))
        parts = parts[..., :full * ry - 1, :]
    return torch.complex(parts[0], parts[1]) if cplx else parts


def _solve_poisson_fft_mesh(rhs, eig, null, mesh):
    ly, lx = rhs.shape
    r0, nr, c0, nc = _reduced_block(mesh, ly, lx)
    Ny_r, Nx_r = eig.shape
    r = rhs[:nr, :nc]
    r = r - mesh.sum(torch.sum(r)) / (Ny_r * Nx_r)
    fx = torch.fft.fft(_strip(mesh, r, rows=True), dim=1)[:, c0:c0 + nc]
    rhat = torch.fft.fft(_strip(mesh, fx, rows=False), dim=0)
    cols = slice(c0, c0 + nc)
    phat = rhat / eig[:, cols].to(rhat.real.dtype)
    phat = torch.where(null[:, cols], 0.0, phat)
    gx = torch.fft.ifft(_strip(mesh, phat[r0:r0 + nr], rows=True),
                        dim=1)[:, c0:c0 + nc]
    g = torch.fft.ifft(_strip(mesh, gx, rows=False), dim=0)[r0:r0 + nr]
    p = F.pad(g.real.to(rhs.dtype), (0, lx - nc, 0, ly - nr))
    p = mesh.overlap_copy([p], tile=True)[0]
    return p - mesh.mean(p)


def compute_divergence_periodic(a_star, b_star, dx, dy, mesh=None):
    """Wide central divergence with the periodic wrap on the reduced
    sub-grid, tiled to the overlap grid. With a ``mesh`` the interior
    central differences of this rank's block padded by a 1-cell wrap halo
    (``Mesh.pad(wrap=True)``); the overlap row and column then read the
    neighbours of row and column 0, so they equal them where the fields
    are overlap-consistent (the velocity BC's copy makes them so)."""
    if mesh is not None:
        sa, sb = mesh.pad([a_star, b_star], 1, wrap=True)
        dudx = (sa[1:-1, 2:] - sa[1:-1, :-2]) / (2.0 * dx)
        dvdy = (sb[2:, 1:-1] - sb[:-2, 1:-1]) / (2.0 * dy)
        return dudx + dvdy
    Ny, Nx = a_star.shape
    au = a_star[:-1, :-1]
    bv = b_star[:-1, :-1]
    dudx = (torch.roll(au, -1, 1) - torch.roll(au, 1, 1)) / (2.0 * dx)
    dvdy = (torch.roll(bv, -1, 0) - torch.roll(bv, 1, 0)) / (2.0 * dy)
    return tile_overlap(dudx + dvdy, Ny, Nx)


def compute_pressure_gradient_periodic(p, dx, dy, mesh=None):
    """Wide central pressure gradient with the periodic wrap, tiled to the
    overlap grid; with a ``mesh`` on this rank's block, as
    ``compute_divergence_periodic``."""
    if mesh is not None:
        s = mesh.pad([p], 1, wrap=True)[0]
        return ((s[1:-1, 2:] - s[1:-1, :-2]) / (2.0 * dx),
                (s[2:, 1:-1] - s[:-2, 1:-1]) / (2.0 * dy))
    Ny, Nx = p.shape
    pr = p[:-1, :-1]
    dpdx = (torch.roll(pr, -1, 1) - torch.roll(pr, 1, 1)) / (2.0 * dx)
    dpdy = (torch.roll(pr, -1, 0) - torch.roll(pr, 1, 0)) / (2.0 * dy)
    return tile_overlap(dpdx, Ny, Nx), tile_overlap(dpdy, Ny, Nx)


# The variable-density solve: the matrix-free operator and the
# DCT-preconditioned CG

# Masked CG iterations between two host reads of the stopping test.
CG_READ_EVERY = 4
# Host reads of the CG's stopping test (one per CG_READ_EVERY iterations
# of a solve). A caller may reset it to 0.
cg_host_reads = 0


def _mirror_pad_x(f):
    return torch.cat([f[:, 1:2], f, f[:, -2:-1]], dim=1)


def _mirror_pad_y(f):
    return torch.cat([f[1:2, :], f, f[-2:-1, :]], dim=0)


def apply_variable_poisson(p, inv_rho, dx, dy):
    """Matrix-free grad.((1/rho) grad p) with face-averaged 1/rho and the
    Neumann ghost mirror p[-1] = p[1], p[N] = p[N-2]."""
    cx = 1.0 / dx**2
    cy = 1.0 / dy**2

    p_padx = _mirror_pad_x(p)
    ir_padx = _mirror_pad_x(inv_rho)
    beta_e = 0.5 * (ir_padx[:, 1:-1] + ir_padx[:, 2:])
    beta_w = 0.5 * (ir_padx[:, 0:-2] + ir_padx[:, 1:-1])
    out = cx * (beta_e * (p_padx[:, 2:] - p) - beta_w * (p - p_padx[:, :-2]))

    p_pady = _mirror_pad_y(p)
    ir_pady = _mirror_pad_y(inv_rho)
    beta_n = 0.5 * (ir_pady[1:-1, :] + ir_pady[2:, :])
    beta_s = 0.5 * (ir_pady[0:-2, :] + ir_pady[1:-1, :])
    return out + cy * (beta_n * (p_pady[2:, :] - p)
                       - beta_s * (p - p_pady[:-2, :]))


def _pin_null_mode(eigenvalues):
    """The eigenvalues with the (0, 0) one set to +inf, so the DCT solve
    zeroes the constant mode's coefficient (x / inf = 0): the exact
    pseudo-inverse in the trapezoid-weighted inner product. A select on
    the device, so the call never waits for the card."""
    Ny, Nx = eigenvalues.shape
    jj = torch.arange(Ny, device=eigenvalues.device)[:, None]
    ii = torch.arange(Nx, device=eigenvalues.device)[None, :]
    return torch.where((jj == 0) & (ii == 0),
                       torch.full_like(eigenvalues, math.inf), eigenvalues)


def _trapezoid_weights(shape, dtype, device):
    """w = wy (x) wx with half weights on the boundary rows and columns:
    the diagonal D that makes D A symmetric (negative semidefinite, null
    space the constants)."""
    Ny, Nx = shape

    def axis(n):
        i = torch.arange(n, device=device)
        return torch.where((i == 0) | (i == n - 1), 0.5, 1.0).to(dtype)

    return axis(Ny)[:, None] * axis(Nx)[None, :]


def _host_read(flag) -> bool:
    """The CG's stopping test on the host: the solve's one kind of wait
    for the card."""
    global cg_host_reads
    cg_host_reads += 1
    return bool(flag)


def _variable_poisson_cg_core(rhs, inv_rho, eigenvalues, dx, dy, tol, maxiter,
                              dct_mats, mesh=None):
    """The PCG loop (see ``solve_variable_poisson_cg_counted``). Autograd
    never records it: the public entry hides it behind the implicit
    adjoint ``_CGAdjoint``, as the JAX package hides its while loop."""
    read_every = CG_READ_EVERY
    if mesh is None:
        w = _trapezoid_weights(rhs.shape, rhs.dtype, rhs.device)
        eig_pre = _pin_null_mode(eigenvalues)
        apply = functools.partial(apply_variable_poisson, dx=dx, dy=dy)

        def total(t):
            return torch.sum(t)

        def mean(t):
            return torch.mean(t)
    else:
        # the whole grid's weights, the null mode pinned on the rank that
        # holds global (0, 0), the matvec on 1-cell halo slabs and every
        # dot product a sum over the ranks, the same on each of them
        ly, lx = rhs.shape
        (ry, rx), (iy, ix) = mesh.shape, mesh.coords
        rows, cols = mesh.block(ly * ry, lx * rx)
        w = _trapezoid_weights((ly * ry, lx * rx), rhs.dtype,
                               rhs.device)[rows, cols]
        eig_pre = (_pin_null_mode(eigenvalues) if (iy, ix) == (0, 0)
                   else eigenvalues)
        apply = mesh.stencil(functools.partial(apply_variable_poisson,
                                               dx=dx, dy=dy), halo=1)

        def total(t):
            return mesh.sum(torch.sum(t))

        mean = mesh.mean
    inv_w = 1.0 / w

    def matvec(p):
        return w * apply(p, inv_rho)

    def precond(r):
        return solve_poisson_dct(r * inv_w, eig_pre, dct_mats, demean=False,
                                 mesh=mesh)

    b = w * rhs
    b = b - mean(b)
    bnorm = torch.sqrt(total(b * b))
    atol2 = tol * bnorm

    def going(r, k):
        return (torch.sqrt(total(r * r)) > atol2) & (k < maxiter)

    r = b
    z = precond(r)
    gamma = total(r * z)
    d = z
    x = torch.zeros_like(b)
    k = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for _ in range(0, maxiter, read_every):
        for _ in range(read_every):
            go = going(r, k)
            Ad = matvec(d)
            alpha = gamma / total(d * Ad)
            x = torch.where(go, x + alpha * d, x)
            r_new = r - alpha * Ad
            z = precond(r_new)
            gamma_new = total(r_new * z)
            beta = gamma_new / gamma
            d = torch.where(go, z + beta * d, d)
            r = torch.where(go, r_new, r)
            gamma = torch.where(go, gamma_new, gamma)
            k = k + go.to(torch.int32)
        if not _host_read(going(r, k)):
            break
    relres = torch.sqrt(total(r * r)) / torch.clamp(
        bnorm, min=torch.finfo(rhs.dtype).tiny)
    return x - mean(x), k, relres


def solve_variable_poisson_cg_counted(rhs, inv_rho, eigenvalues, dx, dy,
                                      tol=1e-6, maxiter=200, dct_mats=None,
                                      mesh=None):
    """Symmetrised preconditioned CG for the variable-density Neumann
    Poisson problem grad.((1/rho) grad p) = rhs, as the JAX package solves
    it: the system left-scaled by the trapezoidal weights D, the rhs
    projected to zero weighted sum, the preconditioner the DCT solve of
    the weighted residual with the constant mode zeroed; jax.scipy's CG
    update order, stopping at ||r|| <= tol ||b|| or ``maxiter``
    iterations. Returns (p, iters, relres): p de-meaned, the iteration
    count (0-d int32) and ||r|| / ||b|| on the device.

    The loop runs ``CG_READ_EVERY`` iterations per host read of the
    stopping test; each iteration's updates are selected by the test on
    the device, so x, r and the count freeze at the iteration where the
    JAX loop stops, and the iterations past it change nothing.

    Where ``rhs`` or ``inv_rho`` requires a gradient the solve is the
    implicit adjoint ``_CGAdjoint`` (the JAX package's custom VJP): the
    loop runs without autograd, and the backward is one more CG solve;
    iters and relres carry no gradient.

    With a ``mesh`` (``parallel.sharding``) ``rhs``, ``inv_rho`` and
    ``eigenvalues`` are this rank's block and ``dct_mats`` its rows
    (``solve_poisson_dct``): the matvec runs on slabs with a 1-cell halo
    (``Mesh.stencil``: the ghost mirror at the domain's edge only), the
    weights are the whole grid's, only the rank that holds global (0, 0)
    pins the constant mode, and each dot product and norm is a sum over
    the ranks added in rank order, so every rank reads the same stopping
    test and count. A sum over the ranks need not round as one sum does.
    No gradient under a mesh (NotImplementedError)."""
    if needs_grad((rhs, inv_rho)):
        if mesh is not None:
            raise NotImplementedError(
                "the sharded CG solve has no gradient (sharded "
                "traced_params wait for ROADMAP modules item 16)")
        Cx, Cy = dct_mats
        return _CGAdjoint.apply(rhs, inv_rho, eigenvalues, Cx, Cy, dx, dy,
                                tol, maxiter)
    return _variable_poisson_cg_core(rhs, inv_rho, eigenvalues, dx, dy, tol,
                                     maxiter, dct_mats, mesh)


class _CGAdjoint(torch.autograd.Function):
    """The implicit-function adjoint of the CG solve (JAX:
    ``pyrmt_tpu/ops/poisson.py::_variable_poisson_cg_bwd``). With S = D A
    symmetric and p = S^+ P D rhs (P the de-meaning), the cotangent g of p
    gives lambda from S lambda = P g, solved by the same PCG (the system
    is self-adjoint); then d rhs = D lambda and d inv_rho = -(d/d inv_rho
    [D A(inv_rho) p])^T lambda, one vector-Jacobian product of the
    matrix-free operator. The forward saves the solution, not the
    iterates: autograd never unrolls the loop, whose gradient would store
    every iterate and differ from this one by O(tol). The eigenvalues and
    the DCT matrices do not enter the converged solution and get none."""

    @staticmethod
    def forward(ctx, rhs, inv_rho, eigenvalues, Cx, Cy, dx, dy, tol,
                maxiter):
        p, iters, relres = _variable_poisson_cg_core(
            rhs, inv_rho, eigenvalues, dx, dy, tol, maxiter, (Cx, Cy))
        ctx.save_for_backward(p, inv_rho, eigenvalues, Cx, Cy)
        ctx.consts = (dx, dy, tol, maxiter)
        ctx.mark_non_differentiable(iters, relres)
        return p, iters, relres

    @staticmethod
    def backward(ctx, ct_p, _ct_iters, _ct_relres):
        p, inv_rho, eigenvalues, Cx, Cy = ctx.saved_tensors
        dx, dy, tol, maxiter = ctx.consts
        g = ct_p - torch.mean(ct_p)
        w = _trapezoid_weights(p.shape, p.dtype, p.device)
        # the core solves S lam = w (g / w) - mean = g
        lam = _variable_poisson_cg_core(g / w, inv_rho, eigenvalues, dx, dy,
                                        tol, maxiter, (Cx, Cy))[0]
        grad_rhs = w * lam if ctx.needs_input_grad[0] else None
        grad_inv_rho = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                ir = inv_rho.detach().requires_grad_(True)
                grad_inv_rho = -torch.autograd.grad(
                    w * apply_variable_poisson(p, ir, dx, dy), ir, lam)[0]
        return grad_rhs, grad_inv_rho, None, None, None, None, None, None, None


def solve_variable_poisson_cg(rhs, inv_rho, eigenvalues, dx, dy, tol=1e-6,
                              maxiter=200, dct_mats=None):
    """``solve_variable_poisson_cg_counted``'s p alone."""
    return solve_variable_poisson_cg_counted(
        rhs, inv_rho, eigenvalues, dx, dy, tol=tol, maxiter=maxiter,
        dct_mats=dct_mats)[0]
