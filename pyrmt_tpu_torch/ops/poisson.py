"""Poisson solves and the divergence/gradient companions of the projection
(counterpart of the constant-density part of ``pyrmt_tpu.ops.poisson``).

Neumann walls: the DCT-I runs as dense matrix products
``C_y @ rhs @ C_x^T``, the same transform as the JAX package's
rFFT-of-the-even-extension path. The even/odd fold of the JAX matmul path
is a TPU layout device and is not carried over. The products run in full
precision: the step module turns TF32 off.

The doubly-periodic box: an FFT solve on the reduced (Ny-1, Nx-1) sub-grid
of the overlap grid (``torch.fft`` per axis, cuFFT on the card; the JAX
package runs it as XLA's FFT, outside any Pallas kernel). The
variable-density solver waits for ROADMAP modules item 12.
"""
from __future__ import annotations

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


def solve_poisson_dct(rhs_2d, eigenvalues, dct_mats):
    """Direct Neumann solve: forward DCT-I, divide by the eigenvalues,
    inverse DCT-I (the forward transform over 4 (Nx-1)(Ny-1)), de-mean."""
    Cx, Cy = dct_mats
    Ny, Nx = rhs_2d.shape
    rhs_hat = Cy @ rhs_2d @ Cx.T
    p_hat = rhs_hat / eigenvalues
    p = (Cy @ p_hat @ Cx.T) / (4.0 * (Nx - 1) * (Ny - 1))
    return p - torch.mean(p)


def compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy,
                          d_scalar=None):
    """Rhie-Chow face-velocity divergence for constant density, zero on the
    boundary ring: face velocities are corrected by d = dt / mean(rho) times
    the difference of the compact face pressure gradient and the average of
    the cell-centred ones. ``d_scalar`` passes d in, as the projection's
    stencil kernel takes it."""
    dpdx_cc = _grad_x_cc(p_prev, dx)
    dpdy_cc = _grad_y_cc(p_prev, dy)

    u_face = 0.5 * (a_star[:, :-1] + a_star[:, 1:])
    face_dpdx = (p_prev[:, 1:] - p_prev[:, :-1]) / dx
    avg_dpdx = 0.5 * (dpdx_cc[:, :-1] + dpdx_cc[:, 1:])

    v_face = 0.5 * (b_star[:-1, :] + b_star[1:, :])
    face_dpdy = (p_prev[1:, :] - p_prev[:-1, :]) / dy
    avg_dpdy = 0.5 * (dpdy_cc[:-1, :] + dpdy_cc[1:, :])

    if d_scalar is None:
        d_scalar = dt / torch.mean(rho)
    u_face_rc = u_face - d_scalar * (face_dpdx - avg_dpdx)
    v_face_rc = v_face - d_scalar * (face_dpdy - avg_dpdy)

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
