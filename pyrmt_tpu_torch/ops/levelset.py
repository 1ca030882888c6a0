"""Level-set shapes, the rebuild from the reference map, the area fix and
reinitialisation (counterpart of ``pyrmt_tpu.ops.levelset``).

In the JAX package an initial level set is any traced closure, which the
Pallas kernel bakes in. A CUDA kernel takes the shape as runtime scalars
instead, so a shape the fused-tier kernel can evaluate carries a
``kernel_spec`` tuple, the way a velocity BC does. The split tier hands the
kernel phi as a field, so any torch callable works there.

Reinitialisation methods: 'none'; 'pde' (Sussman-Smereka-Osher upwind
iteration, a Python loop of ``num_iters`` steps); 'fmm' (parallel fast
sweeping: frontier cells frozen at their interpolated front distance, then
two passes of the 4 Gauss-Seidel orderings, each traversal a loop over
anti-diagonals with one vector op per diagonal). ``apply_phi_BCs`` is the
3-cell periodic wrap of phi. Curvature waits for ROADMAP modules item 19.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def apply_phi_BCs(phi):
    """3-cell periodic wrap of phi: rows 0:3 take rows -6:-3, then rows -3:
    take rows 3:6, then the same for the columns, each copy reading the
    field as the copies before left it (the JAX package's order)."""
    phi = phi.clone()
    phi[0:3, :] = phi[-6:-3, :].clone()
    phi[-3:, :] = phi[3:6, :].clone()
    phi[:, 0:3] = phi[:, -6:-3].clone()
    phi[:, -3:] = phi[:, 3:6].clone()
    return phi


@dataclasses.dataclass(frozen=True)
class Disc:
    """Signed distance to a circle: phi = |x - (x0, y0)| - R."""

    x0: float
    y0: float
    R: float

    @property
    def kernel_spec(self):
        return ("disc", float(self.x0), float(self.y0), float(self.R))

    def __call__(self, X1, X2):
        ex = X1 - self.x0
        ey = X2 - self.y0
        return torch.sqrt(ex * ex + ey * ey) - self.R


def rebuild_phi_from_reference_map(X1, X2, phi_init_func):
    """phi = phi_init(X1, X2): the compatibility reconstruction."""
    return phi_init_func(X1, X2)


def _smoothed_H(x):
    """The cosine-smoothed Heaviside of x = phi / w_t (the area fix's form:
    divisions, as in the JAX package)."""
    H = 0.5 * (1.0 + x + torch.sin(math.pi * x) / math.pi)
    H = torch.where(x > 1.0, 1.0, H)
    return torch.where(x < -1.0, 0.0, H)


def smoothed_solid_area(phi, dx, dy, w_t):
    """Smoothed solid (phi < 0) area  A = sum(1 - H_{w_t}(phi)) dx dy, as a
    0-d tensor."""
    return torch.sum(1.0 - _smoothed_H(phi / w_t)) * (dx * dy)


def area_conserving_shift(phi, dx, dy, w_t, area_target, n_newton=2):
    """Return ``phi + c`` with the scalar ``c`` from ``n_newton`` Newton
    steps on A(phi + c) = ``area_target`` (a Python float):

        c_{k+1} = c_k + (A(c_k) - A0) / P(c_k),   P = sum H'(phi + c) dx dy

    Where the interface has vanished (P <= 1e-8) the step is 0. ``c`` stays
    on the device: the guard is a select, so the call never waits for the
    card.
    """
    c = torch.zeros((), dtype=phi.dtype, device=phi.device)
    cell = dx * dy
    p_floor = 1e-8
    for _ in range(n_newton):
        x = (phi + c) / w_t
        area = torch.sum(1.0 - _smoothed_H(x)) * cell
        dH = torch.where(torch.abs(x) < 1.0,
                         (0.5 / w_t) * (1.0 + torch.cos(math.pi * x)), 0.0)
        perim = torch.sum(dH) * cell
        ok = perim > p_floor
        c = c + torch.where(
            ok, (area - area_target) / torch.clamp(perim, min=p_floor), 0.0)
    return phi + c


def _edge_pad(phi):
    phi = torch.cat([phi[0:1, :], phi, phi[-1:, :]], dim=0)
    return torch.cat([phi[:, 0:1], phi, phi[:, -1:]], dim=1)


def reinitialize_phi_PDE(phi_in, dx, dy, num_iters, dt_reinit_factor=0.5):
    """Sussman-Smereka-Osher reinitialisation: ``num_iters`` Godunov-upwind
    pseudo-time steps with the smoothed sign of the input. The periodic
    phi BC hook of the JAX function waits for ROADMAP modules item 13."""
    sign0 = phi_in / torch.sqrt(phi_in**2 + dx**2)
    dt_reinit = dt_reinit_factor * min(dx, dy)
    mask_pos = sign0 > 0
    mask_neg = sign0 < 0

    phi = phi_in
    for _ in range(num_iters):
        pp = _edge_pad(phi)
        Dx_m = (pp[1:-1, 1:-1] - pp[1:-1, 0:-2]) / dx
        Dx_p = (pp[1:-1, 2:] - pp[1:-1, 1:-1]) / dx
        Dy_m = (pp[1:-1, 1:-1] - pp[0:-2, 1:-1]) / dy
        Dy_p = (pp[2:, 1:-1] - pp[1:-1, 1:-1]) / dy

        gx_pos = torch.maximum(torch.clamp(Dx_m, min=0.0) ** 2,
                               torch.clamp(Dx_p, max=0.0) ** 2)
        gy_pos = torch.maximum(torch.clamp(Dy_m, min=0.0) ** 2,
                               torch.clamp(Dy_p, max=0.0) ** 2)
        gx_neg = torch.maximum(torch.clamp(Dx_m, max=0.0) ** 2,
                               torch.clamp(Dx_p, min=0.0) ** 2)
        gy_neg = torch.maximum(torch.clamp(Dy_m, max=0.0) ** 2,
                               torch.clamp(Dy_p, min=0.0) ** 2)

        gx = torch.where(mask_pos, gx_pos, torch.where(mask_neg, gx_neg, 0.0))
        gy = torch.where(mask_pos, gy_pos, torch.where(mask_neg, gy_neg, 0.0))
        grad_mag = torch.sqrt(gx + gy)
        phi = phi - dt_reinit * sign0 * (grad_mag - 1.0)
    return phi


def _eikonal_update(a, b, hx, hy, big):
    """The 2D upwind eikonal update of one cell from its best upwind
    neighbour distances ``a`` (x, spacing hx) and ``b`` (y, spacing hy);
    the 1D update where the 2D root does not dominate both."""
    a = torch.minimum(a, big)
    b = torch.minimum(b, big)
    d1 = torch.minimum(a + hx, b + hy)
    ihx2 = 1.0 / (hx * hx)
    ihy2 = 1.0 / (hy * hy)
    A = ihx2 + ihy2
    B = a * ihx2 + b * ihy2
    C = a * a * ihx2 + b * b * ihy2 - 1.0
    disc = B * B - A * C
    d2 = (B + torch.sqrt(torch.clamp(disc, min=0.0))) / A
    use2 = (disc >= 0.0) & (d2 >= torch.maximum(a, b))
    return torch.where(use2, d2, d1)


def _fsm_sweep(d, frozen, dx, dy, big):
    """One Gauss-Seidel traversal in the (i asc, j asc) ordering over
    anti-diagonals: cell (i, j) on diagonal k = i + j reads its W/S
    neighbours from the updated diagonal k-1 and its E/N neighbours from
    the pre-sweep diagonal k+1, so a diagonal is one vector op and the
    traversal is Ny + Nx - 1 of them. The other orderings are this sweep on
    flipped arrays."""
    Ny, Nx = d.shape
    K = Ny + Nx - 1
    ii = torch.arange(Ny, device=d.device)
    kk = torch.arange(K, device=d.device)

    # skew to diagonal-major: D[k, i] = d[i, k - i] (big where off-grid)
    jidx = kk[:, None] - ii[None, :]
    valid = (jidx >= 0) & (jidx < Nx)
    gj = torch.clamp(jidx, 0, Nx - 1)
    D = torch.where(valid, d[ii[None, :], gj], big)
    F = torch.where(valid, frozen[ii[None, :], gj], True)

    D_next = torch.cat([D[1:], big.expand(1, Ny)], dim=0)
    big_one = big.reshape(1)
    newD = torch.empty_like(D)
    prev = big.expand(Ny)
    for k in range(K):
        cur_old, next_old = D[k], D_next[k]
        d_s = torch.cat([big_one, prev[:-1]])          # (i-1, j)
        d_n = torch.cat([next_old[1:], big_one])       # (i+1, j)
        a = torch.minimum(prev, next_old)              # W (i, j-1), E (i, j+1)
        b = torch.minimum(d_s, d_n)
        cand = _eikonal_update(a, b, dx, dy, big)
        prev = torch.where(F[k], cur_old, torch.minimum(cur_old, cand))
        newD[k] = prev

    # unskew: d[i, j] = newD[i + j, i]
    jj = torch.arange(Nx, device=d.device)
    return newD[ii[:, None] + jj[None, :], ii[:, None]]


def reinitialize_phi_fsm(phi, dx, dy, n_passes=2):
    """Parallel fast-sweeping redistancing (the 'fmm' method): frontier
    cells (a 4-neighbour sign change) are frozen at their linearly
    interpolated front distance (1/d^2 = sum over axes of 1/d_axis^2), then
    ``n_passes`` rounds of the 4 sweep orderings propagate distances; the
    input's sign is applied at the end."""
    Ny, Nx = phi.shape
    big = torch.full((), 2.0 * (Nx * dx + Ny * dy), dtype=phi.dtype,
                     device=phi.device)

    # edge-replicated neighbours: no crossing across the domain boundary
    pe = torch.cat([phi[:, 1:], phi[:, -1:]], dim=1)
    pw = torch.cat([phi[:, :1], phi[:, :-1]], dim=1)
    pn = torch.cat([phi[1:, :], phi[-1:, :]], dim=0)
    ps = torch.cat([phi[:1, :], phi[:-1, :]], dim=0)

    def theta(pnbr, h):
        cross = phi * pnbr < 0.0
        t = torch.where(cross, phi / (phi - pnbr + 1e-300), 1.0)
        return torch.where(cross, torch.abs(t) * h, big)

    tx = torch.minimum(theta(pe, dx), theta(pw, dx))
    ty = torch.minimum(theta(pn, dy), theta(ps, dy))
    has_x = tx < big
    has_y = ty < big
    inv2 = (torch.where(has_x, 1.0 / (tx * tx), 0.0)
            + torch.where(has_y, 1.0 / (ty * ty), 0.0))
    d_front = torch.where(inv2 > 0.0, 1.0 / torch.sqrt(inv2 + 1e-300), big)
    frozen = has_x | has_y | (phi == 0.0)
    d = torch.where(phi == 0.0, 0.0, torch.where(frozen, d_front, big))

    for _ in range(n_passes):
        for dims in ((), (0,), (1,), (0, 1)):
            if dims:
                d = torch.flip(_fsm_sweep(torch.flip(d, dims),
                                          torch.flip(frozen, dims),
                                          dx, dy, big), dims)
            else:
                d = _fsm_sweep(d, frozen, dx, dy, big)

    sgn = torch.where(phi > 0.0, 1.0, torch.where(phi < 0.0, -1.0, 0.0))
    return (sgn * d).to(phi.dtype)


def reinitialize_level_set(phi, dx, dy, method="none", num_iters=20,
                           dt_reinit_factor=0.2):
    """Switchable reinitialisation: 'none', 'pde' or 'fmm'."""
    if method == "none":
        return phi
    if method == "pde":
        return reinitialize_phi_PDE(phi, dx, dy, num_iters, dt_reinit_factor)
    if method == "fmm":
        return reinitialize_phi_fsm(phi, dx, dy)
    raise ValueError(
        f"Unknown reinit method {method!r} (expected 'none', 'pde' or 'fmm')")
