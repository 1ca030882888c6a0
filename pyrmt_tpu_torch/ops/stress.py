"""Neo-Hookean solid stress from the reference map and the smoothed
Heaviside (counterpart of ``pyrmt_tpu.ops.stress``).

Per cell G = grad(xi), F = G^-1, b = F F^T, J = det F = 1/det G and
sigma = mu_s b + kappa (J - 1) I. Interior mode (w_cut <= 0) computes the
stress where phi <= 0 with one-sided differences next to fluid; band mode
(w_cut > 0) uses central differences over phi < w_cut. Near-singular cells
(|det G| < 1e-10) and the domain's boundary ring keep sigma = 0, J = 1.
"""
from __future__ import annotations

import math

import torch

from pyrmt_tpu_torch.ops.fd import _shift_x, _shift_y


def smoothed_heaviside(x, w_t):
    """H(phi) = 1/2 (1 + phi/w_t + sin(pi phi/w_t)/pi), 0 or 1 outside
    +-w_t."""
    inv_wt = 1.0 / w_t
    inv_pi = 1.0 / math.pi  # a product, as the CUDA kernel rounds it
    H = 0.5 * (1.0 + x * inv_wt + torch.sin(math.pi * x * inv_wt) * inv_pi)
    H = torch.where(x > w_t, torch.ones_like(H), H)
    return torch.where(x < -w_t, torch.zeros_like(H), H)


def solid_cauchy_stress(X1, X2, dx, dy, mu_s, kappa, phi, w_cut=0.0,
                        detg_clamp=0.0):
    """Returns (sxx, sxy, syy, J). ``w_cut`` and ``detg_clamp`` are Python
    floats that select the stencil variant."""
    # divisions by the spacings are multiplications by Python reciprocals:
    # PyTorch's CUDA division by a scalar multiplies by a float reciprocal,
    # and the CUDA kernel must round exactly as this plain version does
    inv_dx, inv_dy = 1.0 / dx, 1.0 / dy
    inv_2dx = 1.0 / (2.0 * dx)
    inv_2dy = 1.0 / (2.0 * dy)

    X1_xp, X1_xm = _shift_x(X1, 1), _shift_x(X1, -1)
    X2_xp, X2_xm = _shift_x(X2, 1), _shift_x(X2, -1)
    X1_yp, X1_ym = _shift_y(X1, 1), _shift_y(X1, -1)
    X2_yp, X2_ym = _shift_y(X2, 1), _shift_y(X2, -1)

    if w_cut > 0.0:
        in_band = phi < w_cut
        g11 = (X1_xp - X1_xm) * inv_2dx
        g21 = (X2_xp - X2_xm) * inv_2dx
        g12 = (X1_yp - X1_ym) * inv_2dy
        g22 = (X2_yp - X2_ym) * inv_2dy
    else:
        in_band = phi <= 0.0
        left_fluid = _shift_x(phi, -1) > 0.0
        right_fluid = _shift_x(phi, 1) > 0.0
        lo_x = left_fluid & ~right_fluid
        hi_x = right_fluid & ~left_fluid
        g11 = torch.where(lo_x, (X1_xp - X1) * inv_dx, torch.where(
            hi_x, (X1 - X1_xm) * inv_dx, (X1_xp - X1_xm) * inv_2dx))
        g21 = torch.where(lo_x, (X2_xp - X2) * inv_dx, torch.where(
            hi_x, (X2 - X2_xm) * inv_dx, (X2_xp - X2_xm) * inv_2dx))
        bot_fluid = _shift_y(phi, -1) > 0.0
        top_fluid = _shift_y(phi, 1) > 0.0
        lo_y = bot_fluid & ~top_fluid
        hi_y = top_fluid & ~bot_fluid
        g12 = torch.where(lo_y, (X1_yp - X1) * inv_dy, torch.where(
            hi_y, (X1 - X1_ym) * inv_dy, (X1_yp - X1_ym) * inv_2dy))
        g22 = torch.where(lo_y, (X2_yp - X2) * inv_dy, torch.where(
            hi_y, (X2 - X2_ym) * inv_dy, (X2_yp - X2_ym) * inv_2dy))

    detG = g11 * g22 - g12 * g21
    nonsingular = torch.abs(detG) >= 1e-10
    if detg_clamp > 0.0:
        detG = torch.clamp(detG, 1.0 / detg_clamp, detg_clamp)

    Ny, Nx = X1.shape
    jj = torch.arange(Ny, device=X1.device)[:, None]
    ii = torch.arange(Nx, device=X1.device)[None, :]
    interior = (jj > 0) & (jj < Ny - 1) & (ii > 0) & (ii < Nx - 1)
    active = in_band & nonsingular & interior

    inv_det = 1.0 / torch.where(active, detG, torch.ones_like(detG))
    f11, f12 = g22 * inv_det, -g12 * inv_det
    f21, f22 = -g21 * inv_det, g11 * inv_det
    b11 = f11 * f11 + f12 * f12
    b12 = f11 * f21 + f12 * f22
    b22 = f21 * f21 + f22 * f22
    vol_term = kappa * (inv_det - 1.0)

    zero = torch.zeros_like(X1)
    sxx = torch.where(active, mu_s * b11 + vol_term, zero)
    sxy = torch.where(active, mu_s * b12, zero)
    syy = torch.where(active, mu_s * b22 + vol_term, zero)
    J = torch.where(active, inv_det, torch.ones_like(X1))
    return sxx, sxy, syy, J
