"""Energy and divergence diagnostics (counterpart of
``pyrmt_tpu.diagnostics``).

Kinetic energy with the smoothed-Heaviside mixture density, the ln(J)-free
strain energy W = (mu/2)(I1 - 2) + (kappa/2)(J - 1)^2 from edge-padded
gradients, the viscous dissipation 2 mu_local D:D, the interior divergence,
a solid's centroid and the centreline profiles. Each is plain PyTorch on
the device of its inputs and returns a 0-d tensor or fields, so a run can
log them without a host read per step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pyrmt_tpu_torch.ops.fd import grad_central_x_2nd, grad_central_y_2nd
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside


def _mixture(phi, w_t, fluid, solid):
    """Hf fluid + sum_i (1 - H_i) solid for a stack (S, Ny, Nx) of level
    sets; (1 - H) solid + H fluid for one (Ny, Nx) (a sum rounds the same
    in either order)."""
    H = smoothed_heaviside(phi, w_t)
    if phi.ndim == 3:
        Hf = torch.sum(H, dim=0) - (phi.shape[0] - 1.0)
        return Hf * fluid + torch.sum(1.0 - H, dim=0) * solid
    return (1.0 - H) * solid + H * fluid


def compute_kinetic_energy(a, b, rho_f, rho_s, phi, w_t, dx, dy):
    """KE = integral of 0.5 rho_local |u|^2; phi is one level set or a
    stack (the n-fluid mixture density)."""
    rho_local = _mixture(phi, w_t, rho_f, rho_s)
    return torch.sum(0.5 * rho_local * (a**2 + b**2)) * dx * dy


def _edge_pad4(f):
    return F.pad(f[None, None], (4, 4, 4, 4), mode="replicate")[0, 0]


def compute_strain_energy(X1, X2, phi, mu_s, dx, dy, kappa=0.0):
    """SE over the solid (phi <= 0) from F = G^-1, G the central gradient
    of the edge-padded map."""
    pad = 4
    X1p = _edge_pad4(X1)
    X2p = _edge_pad4(X2)
    G11 = grad_central_x_2nd(X1p, dx)[pad:-pad, pad:-pad]
    G12 = grad_central_y_2nd(X1p, dy)[pad:-pad, pad:-pad]
    G21 = grad_central_x_2nd(X2p, dx)[pad:-pad, pad:-pad]
    G22 = grad_central_y_2nd(X2p, dy)[pad:-pad, pad:-pad]

    detG = G11 * G22 - G12 * G21
    good = (torch.abs(detG) > 1e-10) & (phi <= 0.0)
    safe = torch.where(good, detG, torch.ones_like(detG))
    F11 = G22 / safe
    F12 = -G12 / safe
    F21 = -G21 / safe
    F22 = G11 / safe
    I1 = F11**2 + F21**2 + F12**2 + F22**2
    J = 1.0 / safe
    se_density = torch.where(
        good, 0.5 * mu_s * (I1 - 2.0) + 0.5 * kappa * (J - 1.0) ** 2,
        torch.zeros_like(J))
    return torch.sum(se_density) * dx * dy


def compute_viscous_dissipation(a, b, mu_f, phi, w_t, dx, dy, eta_s=0.0):
    """epsilon = integral of 2 mu_local D:D, mu_local = H mu_f + (1 - H)
    eta_s (the mixture for a stack)."""
    du_dx = grad_central_x_2nd(a, dx)
    dv_dy = grad_central_y_2nd(b, dy)
    du_dy = grad_central_y_2nd(a, dy)
    dv_dx = grad_central_x_2nd(b, dx)
    D_xy = 0.5 * (du_dy + dv_dx)
    mu_local = _mixture(phi, w_t, mu_f, eta_s)
    density = 2.0 * mu_local * (du_dx**2 + dv_dy**2 + 2.0 * D_xy**2)
    return torch.sum(density) * dx * dy


def divergence_2d_interior(u, v, dx, dy, pad=3):
    """Central divergence with a ``pad``-cell margin left out (the lid's
    corner singularities). Returns (the field, zero-padded; the
    interior)."""
    div_i = (u[pad:-pad, pad + 1:-pad + 1 or None]
             - u[pad:-pad, pad - 1:-pad - 1]) / (2.0 * dx) + (
        v[pad + 1:-pad + 1 or None, pad:-pad]
        - v[pad - 1:-pad - 1, pad:-pad]) / (2.0 * dy)
    return F.pad(div_i, (pad, pad, pad, pad)), div_i


def disc_centroid(phi, X, Y):
    """Area-weighted centroid of the solid (phi <= 0): two 0-d tensors,
    NaN where there is no solid cell."""
    mask = (phi <= 0.0).to(X.dtype)
    area = torch.sum(mask)
    safe = torch.clamp(area, min=1.0)
    cx = torch.sum(X * mask) / safe
    cy = torch.sum(Y * mask) / safe
    nan = torch.full((), float("nan"), dtype=X.dtype, device=X.device)
    return torch.where(area > 0, cx, nan), torch.where(area > 0, cy, nan)


def extract_centerlines(a, b, X, Y):
    """(y, u at x = 0.5) and (x, v at y = 0.5): the middle column and row."""
    Ny, Nx = a.shape
    j_mid = Ny // 2
    i_mid = Nx // 2
    return Y[:, i_mid], a[:, i_mid], X[j_mid, :], b[j_mid, :]
