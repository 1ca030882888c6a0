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

import math

import numpy as np
import torch
import torch.nn.functional as F

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


def solve_poisson_dct(rhs_2d, eigenvalues, dct_mats, demean=True):
    """Direct Neumann solve: forward DCT-I, divide by the eigenvalues,
    inverse DCT-I (the forward transform over 4 (Nx-1)(Ny-1)), de-mean.
    ``demean=False`` leaves the mean, as the variable-density CG's
    preconditioner needs (it zeroes the constant mode by an infinite
    eigenvalue instead, which keeps it symmetric)."""
    Cx, Cy = dct_mats
    Ny, Nx = rhs_2d.shape
    rhs_hat = Cy @ rhs_2d @ Cx.T
    p_hat = rhs_hat / eigenvalues
    p = (Cy @ p_hat @ Cx.T) / (4.0 * (Nx - 1) * (Ny - 1))
    return p - torch.mean(p) if demean else p


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


def solve_poisson_fft(rhs_full, eigenvalues_periodic):
    """Direct periodic Poisson solve on the reduced sub-grid: de-mean, an
    FFT along x then y (complex64 for float32, complex128 for float64, as
    ``jnp.fft`` makes them), divide by the symbol, zero the null modes, the
    inverse FFTs, the real part tiled to the overlap grid, de-mean."""
    eig, null = eigenvalues_periodic
    Ny, Nx = rhs_full.shape
    r = rhs_full[:-1, :-1]
    r = r - torch.mean(r)
    rhat = torch.fft.fft(torch.fft.fft(r, dim=1), dim=0)
    phat = rhat / eig.to(rhat.real.dtype)
    phat = torch.where(null, 0.0, phat)
    g = torch.fft.ifft(torch.fft.ifft(phat, dim=1), dim=0)
    p = tile_overlap(g.real.to(rhs_full.dtype), Ny, Nx)
    return p - torch.mean(p)


def compute_divergence_periodic(a_star, b_star, dx, dy):
    """Wide central divergence with the periodic wrap on the reduced
    sub-grid, tiled to the overlap grid."""
    Ny, Nx = a_star.shape
    au = a_star[:-1, :-1]
    bv = b_star[:-1, :-1]
    dudx = (torch.roll(au, -1, 1) - torch.roll(au, 1, 1)) / (2.0 * dx)
    dvdy = (torch.roll(bv, -1, 0) - torch.roll(bv, 1, 0)) / (2.0 * dy)
    return tile_overlap(dudx + dvdy, Ny, Nx)


def compute_pressure_gradient_periodic(p, dx, dy):
    """Wide central pressure gradient with the periodic wrap, tiled to the
    overlap grid."""
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


def solve_variable_poisson_cg_counted(rhs, inv_rho, eigenvalues, dx, dy,
                                      tol=1e-6, maxiter=200, dct_mats=None):
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
    JAX loop stops, and the iterations past it change nothing."""
    read_every = CG_READ_EVERY
    w = _trapezoid_weights(rhs.shape, rhs.dtype, rhs.device)
    inv_w = 1.0 / w
    eig_pre = _pin_null_mode(eigenvalues)

    def matvec(p):
        return w * apply_variable_poisson(p, inv_rho, dx, dy)

    def precond(r):
        return solve_poisson_dct(r * inv_w, eig_pre, dct_mats, demean=False)

    b = w * rhs
    b = b - torch.mean(b)
    bnorm = torch.sqrt(torch.sum(b * b))
    atol2 = tol * bnorm

    def going(r, k):
        return (torch.sqrt(torch.sum(r * r)) > atol2) & (k < maxiter)

    r = b
    z = precond(r)
    gamma = torch.sum(r * z)
    d = z
    x = torch.zeros_like(b)
    k = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for _ in range(0, maxiter, read_every):
        for _ in range(read_every):
            go = going(r, k)
            Ad = matvec(d)
            alpha = gamma / torch.sum(d * Ad)
            x = torch.where(go, x + alpha * d, x)
            r_new = r - alpha * Ad
            z = precond(r_new)
            gamma_new = torch.sum(r_new * z)
            beta = gamma_new / gamma
            d = torch.where(go, z + beta * d, d)
            r = torch.where(go, r_new, r)
            gamma = torch.where(go, gamma_new, gamma)
            k = k + go.to(torch.int32)
        if not _host_read(going(r, k)):
            break
    relres = torch.sqrt(torch.sum(r * r)) / torch.clamp(
        bnorm, min=torch.finfo(rhs.dtype).tiny)
    return x - torch.mean(x), k, relres


def solve_variable_poisson_cg(rhs, inv_rho, eigenvalues, dx, dy, tol=1e-6,
                              maxiter=200, dct_mats=None):
    """``solve_variable_poisson_cg_counted``'s p alone."""
    return solve_variable_poisson_cg_counted(
        rhs, inv_rho, eigenvalues, dx, dy, tol=tol, maxiter=maxiter,
        dct_mats=dct_mats)[0]
