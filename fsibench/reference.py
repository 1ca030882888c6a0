"""The plain reference of the benchmark: one FSI step of a single soft disc
in the lid-driven cavity, as plain PyTorch, for the comparison that
decides ``correct``.

A frozen copy of the port's plain twins of the step's mathematics, cut to
what the benchmark's configurations run (one disc, the semi-Lagrangian
RK4 backtrace with the bilinear sample, the interior stress, the lid's
walls, the incremental Rhie-Chow projection with the DCT-I solve), and
copied from (at the commit that added the benchmark):

- ``pyrmt_tpu_torch/physics.py``: ``compute_timestep`` (the float path),
  ``velocity_rhs_blended``, ``momentum_core``;
- ``pyrmt_tpu_torch/ops/fd.py``: the 2nd-order gradients, the 3rd-order
  upwind derivative, the edge shifts, ``solve3x3_sym``;
- ``pyrmt_tpu_torch/ops/interp.py::gather_bilinear_local`` and
  ``ops/advect.py::advect_semilagrangian_rk4_local``;
- ``pyrmt_tpu_torch/ops/extrapolate.py``: the least-squares extrapolation;
- ``pyrmt_tpu_torch/ops/stress.py``: the neo-Hookean stress and the
  smoothed Heaviside;
- ``pyrmt_tpu_torch/kernels/rmt_block.py::rmt_block_plain`` (one solid);
- ``pyrmt_tpu_torch/ops/poisson.py`` and ``ops/projection.py``: the
  Rhie-Chow divergence, the DCT solve, the gradient correction;
- ``pyrmt_tpu_torch/bcs.py``: the lid's BC;
- ``pyrmt_tpu_torch/grid.py``: the grid coordinates;
- ``pyrmt_tpu_torch/sim.py``: the order of the step and the initial maps.

It imports nothing of the program, so a later change to the program does
not move the yardstick. Every function takes any float dtype and device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# --- grid and boundary conditions ------------------------------------------


def coords(N, dtype, device):
    """(X, Y) of the N x N node-centred unit grid, as the port's
    ``Grid.coords`` rounds them: i * (1 * (1 / (N - 1))), the endpoint 1."""
    one, stop, div = (torch.tensor(a, dtype=dtype) for a in
                      (1.0, 1.0, float(N - 1)))
    x = torch.cat([torch.arange(N - 1, dtype=dtype) * (stop * (one / div)),
                   stop.reshape(1)]).to(device)
    Y, X = torch.meshgrid(x, x, indexing="ij")
    return X, Y


def lid_bc(u, v, lid_speed=1.0):
    u, v = u.clone(), v.clone()
    for f in (u, v):
        f[:, 0] = 0.0
        f[:, -1] = 0.0
        f[0, :] = 0.0
        f[-1, :] = 0.0
    u[-1, 1:-1] = lid_speed
    return u, v


def disc_phi(X1, X2, x0, y0, R):
    ex = X1 - x0
    ey = X2 - y0
    return torch.sqrt(ex * ex + ey * ey) - R


# --- finite differences ----------------------------------------------------


def gx2(f, dx):
    inv = 1.0 / (2.0 * dx)
    interior = (f[:, 2:] - f[:, :-2]) * inv
    left = (-3.0 * f[:, 0:1] + 4.0 * f[:, 1:2] - f[:, 2:3]) * inv
    right = (3.0 * f[:, -1:] - 4.0 * f[:, -2:-1] + f[:, -3:-2]) * inv
    return torch.cat([left, interior, right], dim=1)


def gy2(f, dy):
    inv = 1.0 / (2.0 * dy)
    interior = (f[2:, :] - f[:-2, :]) * inv
    bottom = (-3.0 * f[0:1, :] + 4.0 * f[1:2, :] - f[2:3, :]) * inv
    top = (3.0 * f[-1:, :] - 4.0 * f[-2:-1, :] + f[-3:-2, :]) * inv
    return torch.cat([bottom, interior, top], dim=0)


def shift_x(f, k):
    """output[..., j, i] = f[..., j, i + k], edge-replicated."""
    if k == 0:
        return f
    lead = f.shape[:-1]
    if k > 0:
        return torch.cat([f[..., k:], f[..., -1:].expand(*lead, k)], dim=-1)
    return torch.cat([f[..., :1].expand(*lead, -k), f[..., :k]], dim=-1)


def shift_y(f, k):
    if k == 0:
        return f
    lead, nx = f.shape[:-2], f.shape[-1]
    if k > 0:
        return torch.cat([f[..., k:, :], f[..., -1:, :].expand(*lead, k, nx)],
                         dim=-2)
    return torch.cat([f[..., :1, :].expand(*lead, -k, nx), f[..., :k, :]],
                     dim=-2)


def upwind3(f, u, h, axis):
    sx = shift_x if axis == 1 else shift_y
    fp1, fp2 = sx(f, 1), sx(f, 2)
    fm1, fm2 = sx(f, -1), sx(f, -2)
    inv_h = 1.0 / h
    backward = (f - fm1) * inv_h
    forward = (fp1 - f) * inv_h
    first = torch.where(u > 0, backward, forward)
    inv_6h = 1.0 / (6.0 * h)
    pos = (2.0 * fp1 + 3.0 * f - 6.0 * fm1 + fm2) * inv_6h
    neg = (-fp2 + 6.0 * fp1 - 3.0 * f - 2.0 * fm1) * inv_6h
    third = torch.where(u > 0, pos, neg)
    n = f.shape[axis]
    idx = torch.arange(n, device=f.device)
    idx = idx[None, :] if axis == 1 else idx[:, None]
    boundary = (idx < 2) | (idx > n - 3)
    out = torch.where(boundary, first, third)
    out = torch.where(idx == 0, forward, out)
    return torch.where(idx == n - 1, backward, out)


def solve3x3_sym(a00, a01, a02, a11, a12, a22, b0, b1, b2, det_eps=1e-10):
    det = (a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a12 * a02)
           + a02 * (a01 * a12 - a11 * a02))
    ok = torch.abs(det) > det_eps
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    x = (b0 * (a11 * a22 - a12 * a12) - a01 * (b1 * a22 - a12 * b2)
         + a02 * (b1 * a12 - a11 * b2)) * inv_det
    return torch.where(ok, x, torch.zeros_like(x)), ok


# --- the solid block -------------------------------------------------------


def gather_bilinear(us, sx, sy):
    """Bilinear samples of the stack ``us`` (K, N, N) at (i + sx, j + sy),
    |sx|, |sy| < 1, the corners picked by the displacement's signs."""
    K, Ny, Nx = us.shape
    kw = dict(dtype=sx.dtype, device=sx.device)
    jj = torch.arange(Ny, **kw)[:, None]
    ii = torch.arange(Nx, **kw)[None, :]
    finite = torch.isfinite(sx) & torch.isfinite(sy)
    zero = torch.zeros((), **kw)
    sx = torch.where(finite, sx, zero)
    sy = torch.where(finite, sy, zero)
    eps = 1e-6
    sx = torch.clamp(sx, -1.0 + eps, 1.0 - eps)
    sy = torch.clamp(sy, -1.0 + eps, 1.0 - eps)
    x = torch.clamp(ii + sx, 0.0, Nx - 1.0)
    y = torch.clamp(jj + sy, 0.0, Ny - 1.0)
    sx = x - ii
    sy = y - jj
    neg_x = sx < 0.0
    neg_y = sy < 0.0
    fx = torch.where(neg_x, sx + 1.0, sx).to(us.dtype)
    fy = torch.where(neg_y, sy + 1.0, sy).to(us.dtype)
    one = torch.ones((), dtype=us.dtype, device=us.device)
    at_right = (ii >= Nx - 1.0) & ~neg_x
    neg_x = neg_x | at_right
    fx = torch.where(at_right, one, fx)
    at_top = (jj >= Ny - 1.0) & ~neg_y
    neg_y = neg_y | at_top
    fy = torch.where(at_top, one, fy)
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy
    vals = []
    for k in range(K):
        f = us[k]
        xm, xp = shift_x(f, -1), shift_x(f, 1)
        ym, yp = shift_y(f, -1), shift_y(f, 1)
        xm_ym, xp_ym = shift_y(xm, -1), shift_y(xp, -1)
        xm_yp, xp_yp = shift_y(xm, 1), shift_y(xp, 1)
        v00 = torch.where(neg_x, torch.where(neg_y, xm_ym, xm),
                          torch.where(neg_y, ym, f))
        v10 = torch.where(neg_x, torch.where(neg_y, ym, f),
                          torch.where(neg_y, xp_ym, xp))
        v01 = torch.where(neg_x, torch.where(neg_y, xm, xm_yp),
                          torch.where(neg_y, f, yp))
        v11 = torch.where(neg_x, torch.where(neg_y, f, yp),
                          torch.where(neg_y, xp, xp_yp))
        vals.append(w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11)
    out = torch.stack(vals)
    return torch.where(finite[None], out, torch.full_like(out, float("nan")))


def advect_sl_rk4(qs, a, b, dt, dx, dy):
    """The stack ``qs`` advected by (a, b) over dt: one RK4 backtrace,
    the bilinear sample."""
    ab = torch.stack([a, b])
    inv_dx, inv_dy = 1.0 / dx, 1.0 / dy
    k1x, k1y = a, b
    k2x, k2y = gather_bilinear(ab, -0.5 * dt * k1x * inv_dx,
                               -0.5 * dt * k1y * inv_dy)
    k3x, k3y = gather_bilinear(ab, -0.5 * dt * k2x * inv_dx,
                               -0.5 * dt * k2y * inv_dy)
    k4x, k4y = gather_bilinear(ab, -dt * k3x * inv_dx, -dt * k3y * inv_dy)
    sx = dt * (-1.0 / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x) * inv_dx
    sy = dt * (-1.0 / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y) * inv_dy
    return gather_bilinear(qs, sx, sy)


_WIN = 4


def _kernels_1d(dx, dy):
    offs = np.arange(-_WIN, _WIN + 1, dtype=np.float64)
    r_sq = (4.0 * np.sqrt(dx**2 + dy**2)) ** 2
    wx = np.exp(-((offs * dx) ** 2) / r_sq)
    wy = np.exp(-((offs * dy) ** 2) / r_sq)
    ones = np.ones_like(offs)
    fx = {"1": ones, "wx": wx, "wxd": wx * offs, "wxd2": wx * offs * offs}
    fy = {"1": ones, "wy": wy, "wyd": wy * offs, "wyd2": wy * offs * offs}
    return fx, fy


def _shift_zero(f, k, dim):
    if k == 0:
        return f
    n = f.shape[dim]
    z = torch.zeros_like(f.narrow(dim, 0, abs(k)))
    if k > 0:
        return torch.cat([f.narrow(dim, k, n - k), z], dim=dim)
    return torch.cat([z, f.narrow(dim, 0, n + k)], dim=dim)


def _corr1d(f, taps_list, dim):
    accs = [None] * len(taps_list)
    for k in range(-_WIN, _WIN + 1):
        s = _shift_zero(f, k, dim)
        for m, taps in enumerate(taps_list):
            w = float(taps[k + _WIN])
            if w == 0.0:
                continue
            term = s * w if w != 1.0 else s
            accs[m] = term if accs[m] is None else accs[m] + term
    return accs


def _layer(X1e, X2e, known, frontier, fx, fy):
    kf = known.to(X1e.dtype)
    k_1, k_wx, k_wxd, k_wxd2 = _corr1d(
        kf, [fx["1"], fx["wx"], fx["wxd"], fx["wxd2"]], 1)
    x1_wx, x1_wxd = _corr1d(kf * X1e, [fx["wx"], fx["wxd"]], 1)
    x2_wx, x2_wxd = _corr1d(kf * X2e, [fx["wx"], fx["wxd"]], 1)
    count = _corr1d(k_1, [fy["1"]], 0)[0]
    a00, a02, a22 = _corr1d(k_wx, [fy["wy"], fy["wyd"], fy["wyd2"]], 0)
    a01, a12 = _corr1d(k_wxd, [fy["wy"], fy["wyd"]], 0)
    a11 = _corr1d(k_wxd2, [fy["wy"]], 0)[0]
    b1_0, b1_2 = _corr1d(x1_wx, [fy["wy"], fy["wyd"]], 0)
    b1_1 = _corr1d(x1_wxd, [fy["wy"]], 0)[0]
    b2_0, b2_2 = _corr1d(x2_wx, [fy["wy"], fy["wyd"]], 0)
    b2_1 = _corr1d(x2_wxd, [fy["wy"]], 0)[0]
    c1, ok = solve3x3_sym(a00, a01, a02, a11, a12, a22, b1_0, b1_1, b1_2)
    c2, _ = solve3x3_sym(a00, a01, a02, a11, a12, a22, b2_0, b2_1, b2_2)
    accept = frontier & (count >= 3.0) & ok
    return (torch.where(accept, c1, X1e), torch.where(accept, c2, X2e),
            known | accept)


def extrapolate(X1, X2, phi, dx, dy, layers):
    """(X1, X2) grown ``layers`` cells from the known cells (phi < 0), a
    Gaussian-weighted least-squares plane over each frontier cell's 9x9
    window, layer by layer."""
    Ny, Nx = X1.shape
    fx, fy = _kernels_1d(dx, dy)
    jj = torch.arange(Ny, device=X1.device)[:, None]
    ii = torch.arange(Nx, device=X1.device)[None, :]
    interior = (jj > 0) & (jj < Ny - 1) & (ii > 0) & (ii < Nx - 1)
    known = phi < 0.0
    for _ in range(layers):
        kf = known.to(X1.dtype)
        row = torch.maximum(torch.maximum(shift_x(kf, -1), kf),
                            shift_x(kf, 1))
        neigh = torch.maximum(torch.maximum(shift_y(row, -1), row),
                              shift_y(row, 1))
        frontier = (~known) & (neigh > 0.0) & interior
        X1, X2, known = _layer(X1, X2, known, frontier, fx, fy)
    return X1, X2


def heaviside(x, w_t):
    inv_wt = 1.0 / w_t
    inv_pi = 1.0 / math.pi
    H = 0.5 * (1.0 + x * inv_wt + torch.sin(math.pi * x * inv_wt) * inv_pi)
    H = torch.where(x > w_t, torch.ones_like(H), H)
    return torch.where(x < -w_t, torch.zeros_like(H), H)


def stress(X1, X2, dx, dy, mu_s, kappa, phi):
    """The interior-mode neo-Hookean stress (sxx, sxy, syy, J), unclamped:
    one-sided differences next to fluid, 0 (J = 1) outside phi <= 0, on
    the boundary ring and where |det G| < 1e-10."""
    inv_dx, inv_dy = 1.0 / dx, 1.0 / dy
    inv_2dx, inv_2dy = 1.0 / (2.0 * dx), 1.0 / (2.0 * dy)
    X1_xp, X1_xm = shift_x(X1, 1), shift_x(X1, -1)
    X2_xp, X2_xm = shift_x(X2, 1), shift_x(X2, -1)
    X1_yp, X1_ym = shift_y(X1, 1), shift_y(X1, -1)
    X2_yp, X2_ym = shift_y(X2, 1), shift_y(X2, -1)
    in_band = phi <= 0.0
    left_fluid = shift_x(phi, -1) > 0.0
    right_fluid = shift_x(phi, 1) > 0.0
    lo_x = left_fluid & ~right_fluid
    hi_x = right_fluid & ~left_fluid
    g11 = torch.where(lo_x, (X1_xp - X1) * inv_dx, torch.where(
        hi_x, (X1 - X1_xm) * inv_dx, (X1_xp - X1_xm) * inv_2dx))
    g21 = torch.where(lo_x, (X2_xp - X2) * inv_dx, torch.where(
        hi_x, (X2 - X2_xm) * inv_dx, (X2_xp - X2_xm) * inv_2dx))
    bot_fluid = shift_y(phi, -1) > 0.0
    top_fluid = shift_y(phi, 1) > 0.0
    lo_y = bot_fluid & ~top_fluid
    hi_y = top_fluid & ~bot_fluid
    g12 = torch.where(lo_y, (X1_yp - X1) * inv_dy, torch.where(
        hi_y, (X1 - X1_ym) * inv_dy, (X1_yp - X1_ym) * inv_2dy))
    g22 = torch.where(lo_y, (X2_yp - X2) * inv_dy, torch.where(
        hi_y, (X2 - X2_ym) * inv_dy, (X2_yp - X2_ym) * inv_2dy))
    detG = g11 * g22 - g12 * g21
    nonsingular = torch.abs(detG) >= 1e-10
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
    vol = kappa * (inv_det - 1.0)
    zero = torch.zeros_like(X1)
    return (torch.where(active, mu_s * b11 + vol, zero),
            torch.where(active, mu_s * b12, zero),
            torch.where(active, mu_s * b22 + vol, zero),
            torch.where(active, inv_det, torch.ones_like(X1)))


# --- momentum --------------------------------------------------------------


def timestep(u, v, dx, cfg):
    """The adaptive dt (the step's float path): the fluid CFL against the
    least of the solid P-wave, viscous and cap limits (no surface
    tension in these configurations)."""
    u_max = torch.sqrt(torch.amax(u * u + v * v))
    dt_fluid = cfg["CFL"] * dx / (u_max + 1e-6)
    cs = np.sqrt((cfg["kappa"] + cfg["mu_s"] * 4.0 / 3.0)
                 / (cfg["rho_s"] + 1e-12))
    dt_solid = cfg["CFL"] * dx / (cs + 1e-14)
    dt_visc = 1.0
    mu_max = max(cfg["mu_f"], cfg["eta_s"])
    rho_min = min(cfg["rho_s"], cfg["rho_f"])
    if mu_max > 1e-12 and rho_min > 1e-12:
        dt_visc = cfg["CFL"] * rho_min * dx**2 / (4.0 * mu_max)
    dt_static = float(min(dt_solid, 1.0, dt_visc, cfg["dt_min_cap"]))
    return torch.clamp(dt_fluid, max=dt_static)


def velocity_rhs(u, v, p, sxx_s, sxy_s, syy_s, dx, dy, mu_f, Hf, rho):
    du_dx, dv_dy = gx2(u, dx), gy2(v, dy)
    du_dy, dv_dx = gy2(u, dy), gx2(v, dx)
    sig_xx = Hf * (2.0 * mu_f * du_dx) + sxx_s
    sig_yy = Hf * (2.0 * mu_f * dv_dy) + syy_s
    sig_xy = Hf * (mu_f * (du_dy + dv_dx)) + sxy_s
    div_x = gx2(sig_xx, dx) + gy2(sig_xy, dy)
    div_y = gx2(sig_xy, dx) + gy2(sig_yy, dy)
    u_adv = -u * upwind3(u, u, dx, 1) - v * upwind3(u, v, dy, 0)
    v_adv = -u * upwind3(v, u, dx, 1) - v * upwind3(v, v, dy, 0)
    dp_dx, dp_dy = gx2(p, dx), gy2(p, dy)
    inv_rho = 1.0 / (rho + 1e-12)
    return (u_adv + (div_x - dp_dx) * inv_rho,
            v_adv + (div_y - dp_dy) * inv_rho)


def momentum_rk4(u, v, p, sxx, sxy, syy, Hf, rho, mkv, bc, *, eta_s, dx, dy,
                 dt, mu_f):
    """The four RK4 stages of the blended RHS, the BC on every stage's
    input and on the result, the Kelvin-Voigt term at every stage."""

    def rhs(us, vs):
        us, vs = bc(us, vs)
        a, b, c = sxx, sxy, syy
        if eta_s > 0.0:
            du_dx, dv_dy = gx2(us, dx), gy2(vs, dy)
            du_dy, dv_dx = gy2(us, dy), gx2(vs, dx)
            a = a + mkv * (eta_s * du_dx)
            c = c + mkv * (eta_s * dv_dy)
            b = b + mkv * (eta_s * 0.5 * (du_dy + dv_dx))
        return velocity_rhs(us, vs, p, a, b, c, dx, dy, mu_f, Hf, rho)

    k1u, k1v = rhs(u, v)
    k2u, k2v = rhs(u + 0.5 * dt * k1u, v + 0.5 * dt * k1v)
    k3u, k3v = rhs(u + 0.5 * dt * k2u, v + 0.5 * dt * k2v)
    k4u, k4v = rhs(u + dt * k3u, v + dt * k3v)
    u_new = u + (dt * (1.0 / 6.0)) * (k1u + 2 * k2u + 2 * k3u + k4u)
    v_new = v + (dt * (1.0 / 6.0)) * (k1v + 2 * k2v + 2 * k3v + k4v)
    return bc(u_new, v_new)


# --- projection ------------------------------------------------------------


def dct_matrix(N, dtype, device):
    """The unnormalised DCT-I matrix C[k, n] = w_n cos(pi k n / (N - 1)),
    w = 1 at the ends and 2 inside."""
    k = np.arange(N)[:, None]
    n = np.arange(N)[None, :]
    w = np.full(N, 2.0)
    w[0] = w[-1] = 1.0
    C = np.cos(np.pi * k * n / (N - 1)) * w[None, :]
    return torch.as_tensor(C, dtype=dtype, device=device)


def eigenvalues(N, dx, dtype, device):
    lam = -2.0 * (1.0 - np.cos(np.pi * np.arange(N) / (N - 1))) / dx**2
    eig = lam[None, :] + lam[:, None]
    eig[0, 0] = 1.0
    return torch.as_tensor(eig, dtype=dtype, device=device)


def dct_solve(rhs, eig, C):
    N = C.shape[0]
    r_hat = C @ rhs @ C.T
    p = C @ (r_hat / eig) @ C.T / (
        4.0 * (N - 1) * (N - 1))
    return p - torch.mean(p)


def divergence_rc(a, b, p, dt, rho, dx, dy):
    dpdx_cc, dpdy_cc = gx2(p, dx), gy2(p, dy)
    u_face = 0.5 * (a[:, :-1] + a[:, 1:])
    face_dpdx = (p[:, 1:] - p[:, :-1]) / dx
    avg_dpdx = 0.5 * (dpdx_cc[:, :-1] + dpdx_cc[:, 1:])
    v_face = 0.5 * (b[:-1, :] + b[1:, :])
    face_dpdy = (p[1:, :] - p[:-1, :]) / dy
    avg_dpdy = 0.5 * (dpdy_cc[:-1, :] + dpdy_cc[1:, :])
    d_x = d_y = dt / torch.mean(rho)
    u_rc = u_face - d_x * (face_dpdx - avg_dpdx)
    v_rc = v_face - d_y * (face_dpdy - avg_dpdy)
    div = ((u_rc[1:-1, 1:] - u_rc[1:-1, :-1]) / dx
           + (v_rc[1:, 1:-1] - v_rc[:-1, 1:-1]) / dy)
    return F.pad(div, (1, 1, 1, 1))


def pressure_gradient(p, dx, dy):
    Ny, Nx = p.shape
    jj = torch.arange(Ny, device=p.device)[:, None]
    ii = torch.arange(Nx, device=p.device)[None, :]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    row_in = (jj > 0) & (jj < Ny - 1)
    col_edge = (ii == 0) | (ii == Nx - 1)
    dpdx = torch.where(col_edge | row_in, gx2(p, dx), zero)
    col_in = (ii > 0) & (ii < Nx - 1)
    row_edge = (jj == 0) | (jj == Ny - 1)
    dpdy = torch.where(row_edge | col_in, gy2(p, dy), zero)
    return dpdx, dpdy


# --- the step --------------------------------------------------------------


class Reference:
    """One configuration's reference step on an N x N grid, in ``dtype``
    on ``device``: ``step(u, v, p, X1, X2)`` returns the step's outputs,
    ``maps(u, v, X1, X2)`` the solid block's advected and extrapolated
    maps alone, ``init_maps()`` the initial maps. ``cfg`` holds the
    physics (the configuration file's ``physics`` keys), ``disc`` the
    solid's (x0, y0, R)."""

    def __init__(self, cfg, lid_speed, disc, N, dtype, device):
        self.cfg, self.disc, self.N = cfg, disc, N
        self.dx = self.dy = 1.0 / (N - 1)
        self.kw = dict(dtype=dtype, device=device)
        self.bc = lambda u, v: lid_bc(u, v, lid_speed)
        self.C = dct_matrix(N, **self.kw)
        self.eig = eigenvalues(N, self.dx, **self.kw)

    def phi(self, X1, X2):
        return disc_phi(X1, X2, *self.disc)

    def init_maps(self):
        """The identity map inside the disc, extrapolated into the fluid."""
        X, Y = coords(self.N, **self.kw)
        phi = self.phi(X, Y)
        mask = (phi <= 0.0).to(X.dtype)
        return extrapolate(X * mask, Y * mask, phi, self.dx, self.dy,
                           self.cfg["num_layers"])

    def maps(self, u, v, X1, X2):
        """The solid block's maps: (X1, X2) advected by (u, v) over the
        step's dt, masked to the solid and extrapolated; with phi0 (the
        level set rebuilt from the maps taken) and dt."""
        c, dx, dy = self.cfg, self.dx, self.dy
        dt = timestep(u, v, dx, c)
        phi0 = self.phi(X1, X2)
        qs = advect_sl_rk4(torch.stack([X1, X2]), u, v, dt, dx, dy)
        mask = (phi0 <= 0.0).to(u.dtype)
        X1e, X2e = extrapolate(qs[0] * mask, qs[1] * mask, phi0, dx, dy,
                               c["num_layers"])
        return X1e, X2e, phi0, dt

    def step(self, u, v, p, X1, X2):
        c, dx, dy = self.cfg, self.dx, self.dy
        w_t = c["w_t_cells"] * dx
        # the solid block: rebuild, advect, mask, extrapolate, rebuild,
        # stress, Heaviside, blends
        X1e, X2e, phi0, dt = self.maps(u, v, X1, X2)
        phi = self.phi(X1e, X2e)
        sxx, sxy, syy, J = stress(X1e, X2e, dx, dy, c["mu_s"], c["kappa"],
                                  phi)
        H = heaviside(phi, w_t)
        rho = H * c["rho_f"] + (1.0 - H) * c["rho_s"]
        sb = [(1.0 - H) * f for f in (sxx, sxy, syy)]
        mkv = ((phi <= 0.0).to(u.dtype) * (1.0 - H) if c["eta_s"] > 0.0
               else torch.zeros_like(u))
        a, b = momentum_rk4(u, v, p, *sb, H, rho, mkv, self.bc,
                            eta_s=c["eta_s"], dx=dx, dy=dy, dt=dt,
                            mu_f=c["mu_f"])
        # the incremental Rhie-Chow projection
        div = divergence_rc(a, b, p, dt, rho, dx, dy)
        p_corr = dct_solve(rho * div / dt, self.eig, self.C)
        dpdx, dpdy = pressure_gradient(p_corr, dx, dy)
        u_new, v_new = self.bc(a - (dt / rho) * dpdx, b - (dt / rho) * dpdy)
        p_new = p + p_corr
        p_new = p_new - torch.mean(p_new)
        return dict(u=u_new, v=v_new, p=p_new, X1=X1e, X2=X2e,
                    phi=phi, phi0=phi0, J=J, sxx=sxx, sxy=sxy, syy=syy,
                    dt=dt)
