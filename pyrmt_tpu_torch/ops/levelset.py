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
3-cell periodic wrap of phi.

Curvature, for surface tension: ``compute_curvature`` (div(grad phi /
|grad phi|)), the sharp solid fraction of each cell from the linear
reconstruction of phi (``sharp_solid_fraction``) and the height-function
estimate built on it (``compute_curvature_hf``), all elementwise and shift
expressions in the JAX package's order, with its double-where guards.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from pyrmt_tpu_torch.ops.fd import grad_central_x_2nd, grad_central_y_2nd


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


def _norm(sq, *xs):
    """sqrt(sq). Where a gradient flows to ``xs`` the double-where of the
    JAX package (sqrt only of a positive operand, 0 elsewhere): the sqrt's
    derivative at 0 is inf, and autograd's product with a zero cotangent
    NaN. The two are equal bit for bit."""
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return torch.sqrt(sq)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


@dataclasses.dataclass(frozen=True)
class Disc:
    """Signed distance to a circle: phi = |x - (x0, y0)| - R (its gradient
    finite at the centre, ``_norm``)."""

    x0: float
    y0: float
    R: float

    @property
    def kernel_spec(self):
        return ("disc", float(self.x0), float(self.y0), float(self.R))

    def __call__(self, X1, X2):
        ex = X1 - self.x0
        ey = X2 - self.y0
        return _norm(ex * ex + ey * ey, X1, X2) - self.R


@dataclasses.dataclass(frozen=True)
class Ellipse:
    """The quasi signed distance of an ellipse with semi-axes a (along x)
    and b: the implicit function r - 1, r = |((x - x0)/a, (y - y0)/b)|,
    over its gradient's norm (``benchmarks/capillary_drop_coupled.py``'s
    ``make_ellipse_phi_init``): exact on the ellipse, first-order distance
    off it. Its operations are the JAX function's in its order, with each
    division by a semi-axis a product by its reciprocal (the rounding the
    CUDA kernel reproduces; a few ulps from the JAX function)."""

    x0: float
    y0: float
    a: float
    b: float

    @property
    def kernel_spec(self):
        return ("ellipse", float(self.x0), float(self.y0), float(self.a),
                float(self.b))

    def __call__(self, X1, X2):
        inv_a, inv_b = 1.0 / self.a, 1.0 / self.b
        fx = (X1 - self.x0) * inv_a
        fy = (X2 - self.y0) * inv_b
        r = torch.sqrt(fx * fx + fy * fy + 1e-30)
        f = r - 1.0
        ga = fx * inv_a
        gb = fy * inv_b
        grad = _norm(ga * ga + gb * gb, X1, X2) / r + 1e-12
        return f / grad


def rebuild_phi_from_reference_map(X1, X2, phi_init_func):
    """phi = phi_init(X1, X2): the compatibility reconstruction."""
    return phi_init_func(X1, X2)


def _smoothed_H(x):
    """The cosine-smoothed Heaviside of x = phi / w_t (the area fix's form:
    divisions, as in the JAX package)."""
    H = 0.5 * (1.0 + x + torch.sin(math.pi * x) / math.pi)
    H = torch.where(x > 1.0, 1.0, H)
    return torch.where(x < -1.0, 0.0, H)


def _total(t, mesh):
    """sum(t): over the whole grid from the ranks' blocks with a mesh."""
    return torch.sum(t) if mesh is None else mesh.sum(torch.sum(t))


def smoothed_solid_area(phi, dx, dy, w_t):
    """Smoothed solid (phi < 0) area  A = sum(1 - H_{w_t}(phi)) dx dy, as a
    0-d tensor."""
    return torch.sum(1.0 - _smoothed_H(phi / w_t)) * (dx * dy)


def area_conserving_shift(phi, dx, dy, w_t, area_target, n_newton=2,
                          mesh=None):
    """Return ``phi + c`` with the scalar ``c`` from ``n_newton`` Newton
    steps on A(phi + c) = ``area_target`` (a Python float):

        c_{k+1} = c_k + (A(c_k) - A0) / P(c_k),   P = sum H'(phi + c) dx dy

    Where the interface has vanished (P <= 1e-8) the step is 0. ``c`` stays
    on the device: the guard is a select, so the call never waits for the
    card. With a ``mesh`` ``phi`` is this rank's block and the area and
    the perimeter are sums over the ranks, the same on each of them.
    """
    c = torch.zeros((), dtype=phi.dtype, device=phi.device)
    cell = dx * dy
    p_floor = 1e-8
    for _ in range(n_newton):
        x = (phi + c) / w_t
        area = _total(1.0 - _smoothed_H(x), mesh) * cell
        dH = torch.where(torch.abs(x) < 1.0,
                         (0.5 / w_t) * (1.0 + torch.cos(math.pi * x)), 0.0)
        perim = _total(dH, mesh) * cell
        ok = perim > p_floor
        c = c + torch.where(
            ok, (area - area_target) / torch.clamp(perim, min=p_floor), 0.0)
    return phi + c


def compute_curvature(phi, dx, dy):
    """kappa = div(grad phi / |grad phi|) with 2nd-order central stencils.
    Where |grad phi|^2 < 1e-24 (a flat far field) the radicand is replaced
    by 1 before the square root (the JAX function's AD-safe guard)."""
    phi_x = grad_central_x_2nd(phi, dx)
    phi_y = grad_central_y_2nd(phi, dy)
    g2 = phi_x**2 + phi_y**2
    g2 = torch.where(g2 < 1e-24, torch.ones_like(g2), g2)
    grad_mag = torch.sqrt(g2) + 1e-12
    nx = phi_x / grad_mag
    ny = phi_y / grad_mag
    return grad_central_x_2nd(nx, dx) + grad_central_y_2nd(ny, dy)


def _edge_pad(phi):
    phi = torch.cat([phi[0:1, :], phi, phi[-1:, :]], dim=0)
    return torch.cat([phi[:, 0:1], phi, phi[:, -1:]], dim=1)


def sharp_solid_fraction(phi, dx, dy):
    """The sharp solid (phi < 0) fraction of each dx-by-dy cell from the
    linear reconstruction of phi: the cell-centre distance s = phi / |grad
    phi| and the normal give the closed form of Scardovelli and Zaleski
    (1999), exact for a straight interface at any slope. Where the gradient
    is flat (its 1-norm over the cell at most 1e-6 (dx + dy)) the fraction
    is the sign indicator; the guards of the JAX function (the radicand and
    the denominators replaced before use) are kept."""
    gx = grad_central_x_2nd(phi, dx)
    gy = grad_central_y_2nd(phi, dy)
    g2 = gx * gx + gy * gy
    g2 = torch.where(g2 < 1e-24, torch.ones_like(g2), g2)
    gm = torch.sqrt(g2) + 1e-12
    m1 = torch.abs(gx) / gm * dx
    m2 = torch.abs(gy) / gm * dy
    lo = torch.clamp(torch.minimum(m1, m2), min=1e-9 * (dx + dy))
    mtot = m1 + m2
    flat = mtot <= 1e-6 * (dx + dy)
    hi = torch.where(flat, torch.full_like(gm, dx + dy),
                     torch.maximum(m1, m2))
    s = phi / gm
    a = torch.minimum(torch.clamp(0.5 * mtot - s, min=0.0), mtot)
    F1 = a * a / (2.0 * lo * hi)
    F2 = (a - 0.5 * lo) / hi
    F3 = 1.0 - (mtot - a) ** 2 / (2.0 * lo * hi)
    F = torch.where(a < lo, F1, torch.where(a <= hi, F2, F3))
    return torch.where(flat, (phi < 0.0).to(phi.dtype), F)


def _pad_rows(f, k):
    """f with its first and last rows repeated k times above and below."""
    return torch.cat([f[:1, :].expand(k, -1), f, f[-1:, :].expand(k, -1)],
                     dim=0)


def _pad_cols(f, k):
    return torch.cat([f[:, :1].expand(-1, k), f, f[:, -1:].expand(-1, k)],
                     dim=1)


def _fp_min_products(m, dim, fp, smooth):
    """The least product of a column's bracket m with the brackets of the
    columns the estimate reads (+-1 without smoothing, edge-replicated;
    +-fp with it, the first and last fp rings marked invalid by -1)."""
    if smooth == 0:
        if dim == 1:
            mp = _pad_cols(m, 1)
            return torch.minimum(mp[:, :-2] * m, m * mp[:, 2:])
        mp = _pad_rows(m, 1)
        return torch.minimum(mp[:-2, :] * m, m * mp[2:, :])
    pads = [m]
    for k in range(1, fp + 1):
        pads.append(torch.roll(m, k, dims=dim))
        pads.append(torch.roll(m, -k, dims=dim))
    mm = m * pads[1]
    for q in pads[2:]:
        mm = torch.minimum(mm, m * q)
    n = m.shape[dim]
    idx = torch.arange(n, device=m.device)
    interior = (idx >= fp) & (idx < n - fp)
    interior = interior[None, :] if dim == 1 else interior[:, None]
    return torch.where(interior, mm, torch.full_like(mm, -1.0))


def compute_curvature_hf(phi, dx, dy, hh, kappa_fallback, smooth=0):
    """Height-function curvature (Cummins, Francois and Kothe 2005), the
    JAX function's estimator and cascade: the sharp fractions c of
    ``sharp_solid_fraction`` summed over columns of 2 hh + 1 cells along
    each axis give the interface heights h, and kappa = -h'' / (1 +
    h'^2)^(3/2). A column is valid where its bracket (c at its bottom
    minus c at its top) times each neighbour's exceeds 0.81. With
    ``smooth`` = 0 each cell takes the orientation its normal prefers
    (|phi_y| >= |phi_x|: vertical columns), else the other valid one,
    else ``kappa_fallback``; with ``smooth`` = s > 0 the heights are
    filtered s times by a tangential [1, 2, 1] / 4 pass and the two
    orientations blend convexly: validity ramps over the products' [0.9025,
    0.98] times the weights phi_y^2 / |grad phi|^2 and its complement, the
    rest of the weight on ``kappa_fallback``. The result is clamped to
    |kappa| <= 1 / min(dx, dy). ``hh`` is a Python int."""
    c = sharp_solid_fraction(phi, dx, dy)
    Ny, Nx = c.shape
    W = 2 * hh + 1
    like = dict(dtype=c.dtype, device=c.device)
    one = torch.ones((), **like)

    # vertical columns: heights h(x) = sum_k c[i + k, j] dy
    cpv = _pad_rows(c, hh)
    h = sum(cpv[k:k + Ny, :] for k in range(W)) * dy
    m_v = cpv[0:Ny, :] - cpv[2 * hh:2 * hh + Ny, :]
    for _ in range(smooth):
        hs = _pad_cols(h, 1)
        h = 0.25 * (hs[:, :-2] + 2.0 * h + hs[:, 2:])
    hp = _pad_cols(h, 1)
    h_x = (hp[:, 2:] - hp[:, :-2]) / (2.0 * dx)
    h_xx = (hp[:, 2:] - 2.0 * h + hp[:, :-2]) / (dx * dx)
    kap_v = -h_xx / (one + h_x * h_x) ** 1.5

    fp = 1 + smooth
    thr = torch.tensor(0.81, **like)
    mm_v = _fp_min_products(m_v, 1, fp, smooth)
    valid_v = mm_v > thr

    # horizontal columns: heights g(y) = sum_k c[i, j + k] dx
    cph = _pad_cols(c, hh)
    gsum = sum(cph[:, k:k + Nx] for k in range(W)) * dx
    m_h = cph[:, 0:Nx] - cph[:, 2 * hh:2 * hh + Nx]
    for _ in range(smooth):
        gs = _pad_rows(gsum, 1)
        gsum = 0.25 * (gs[:-2, :] + 2.0 * gsum + gs[2:, :])
    gp = _pad_rows(gsum, 1)
    g_y = (gp[2:, :] - gp[:-2, :]) / (2.0 * dy)
    g_yy = (gp[2:, :] - 2.0 * gsum + gp[:-2, :]) / (dy * dy)
    kap_h = -g_yy / (one + g_y * g_y) ** 1.5
    mm_h = _fp_min_products(m_h, 0, fp, smooth)
    valid_h = mm_h > thr

    phi_x = grad_central_x_2nd(phi, dx)
    phi_y = grad_central_y_2nd(phi, dy)
    cap = torch.tensor(1.0 / min(dx, dy), **like)

    if smooth:
        lo = torch.tensor(0.9025, **like)
        full = torch.tensor(0.98, **like)
        w_v = torch.clamp((mm_v - lo) / (full - lo), 0.0, 1.0)
        w_h = torch.clamp((mm_h - lo) / (full - lo), 0.0, 1.0)
        g2 = phi_x * phi_x + phi_y * phi_y + torch.tensor(1e-30, **like)
        qv = phi_y * phi_y / g2
        wv = w_v * qv
        wh = w_h * (one - qv)
        # a zero weight must not read a non-finite column estimate
        zero = torch.zeros_like(kap_v)
        kap_v = torch.where(wv > 0.0, kap_v, zero)
        kap_h = torch.where(wh > 0.0, kap_h, zero)
        kap = wv * kap_v + wh * kap_h + (one - wv - wh) * kappa_fallback
        return torch.minimum(torch.maximum(kap, -cap), cap)

    prefer_v = torch.abs(phi_y) >= torch.abs(phi_x)
    kap = torch.where(
        prefer_v & valid_v, kap_v,
        torch.where((~prefer_v) & valid_h, kap_h,
                    torch.where(valid_v, kap_v,
                                torch.where(valid_h, kap_h, kappa_fallback))))
    return torch.minimum(torch.maximum(kap, -cap), cap)


def reinitialize_phi_PDE(phi_in, dx, dy, num_iters, apply_phi_BCs_func=None,
                         dt_reinit_factor=0.5, *, mesh=None):
    """Sussman-Smereka-Osher reinitialisation: ``num_iters`` Godunov-upwind
    pseudo-time steps with the smoothed sign of the input, each followed
    by ``apply_phi_BCs_func(phi)`` where one is given (as the JAX
    function's hook: ``apply_phi_BCs`` with its periodic BC, for one).

    With a ``mesh`` (``parallel.sharding``) ``phi_in`` is this rank's
    block: the iterations run ``REINIT_CHUNK`` at a time on slabs padded
    by as many exchanged cells (``Mesh.stencil``: the edge pad at the
    domain's edge only), each iteration reading one cell further. A hook
    acts on the whole field, so it raises ValueError with a mesh (JAX's
    sharded step passes none)."""
    if mesh is not None and apply_phi_BCs_func is not None:
        raise ValueError("reinitialize_phi_PDE on a mesh takes no "
                         "apply_phi_BCs_func: the hook acts on the whole "
                         "field")
    sign0 = phi_in / torch.sqrt(phi_in**2 + dx**2)
    dt_reinit = dt_reinit_factor * min(dx, dy)

    def iterate(phi, sign0, n):
        mask_pos = sign0 > 0
        mask_neg = sign0 < 0
        for _ in range(n):
            phi = _pde_iteration(phi, sign0, mask_pos, mask_neg, dx, dy,
                                 dt_reinit)
            if apply_phi_BCs_func is not None:
                phi = apply_phi_BCs_func(phi)
        return phi

    if mesh is None:
        return iterate(phi_in, sign0, num_iters)
    phi, done = phi_in, 0
    while done < num_iters:
        n = min(REINIT_CHUNK, num_iters - done)
        phi = mesh.stencil(functools.partial(iterate, n=n), halo=n)(phi,
                                                                    sign0)
        done += n
    return phi


# Iterations of the sharded PDE reinitialisation per halo exchange (and
# the exchanged halo's depth).
REINIT_CHUNK = 8


def reinitialize_phi_fmm_equivalent(phi, dx, dy):
    """The long-horizon PDE reinitialisation, max(200, 1.5 max(shape))
    iterations at dt_reinit_factor 0.5 (the JAX package's 'fmm' stand-in,
    exported as ``reinitialize_phi_fmm``; the step's 'fmm' is the fast
    sweep, ``reinitialize_phi_fsm``)."""
    iters = max(200, int(1.5 * max(phi.shape)))
    return reinitialize_phi_PDE(phi, dx, dy, iters, None,
                                dt_reinit_factor=0.5)


def _pde_iteration(phi, sign0, mask_pos, mask_neg, dx, dy, dt_reinit):
    """One Godunov-upwind pseudo-time step of ``reinitialize_phi_PDE``."""
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
    # the double-where where a gradient flows: on a mesh's slab the
    # discarded cells by a cut can have a zero upwind gradient
    grad_mag = _norm(gx + gy, phi)
    return phi - dt_reinit * sign0 * (grad_mag - 1.0)


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
                           dt_reinit_factor=0.2, apply_phi_BCs_func=None, *,
                           mesh=None):
    """Switchable reinitialisation: 'none', 'pde' (with the phi BC hook
    ``apply_phi_BCs_func``, as ``reinitialize_phi_PDE``) or 'fmm'. With a
    ``mesh`` (``parallel.sharding``) ``phi`` is this rank's block: 'pde'
    runs on exchanged halo slabs (``reinitialize_phi_PDE``); 'fmm', a
    sweep over the whole grid whose edges and cap are the whole grid's,
    runs on the whole phi gathered on every rank, of which each keeps its
    block."""
    if method == "none":
        return phi
    if method == "pde":
        return reinitialize_phi_PDE(phi, dx, dy, num_iters,
                                    apply_phi_BCs_func, dt_reinit_factor,
                                    mesh=mesh)
    if method == "fmm":
        if mesh is None:
            return reinitialize_phi_fsm(phi, dx, dy)
        ly, lx = phi.shape
        rows, cols = mesh.block(ly * mesh.shape[0], lx * mesh.shape[1])
        return reinitialize_phi_fsm(mesh.gather(phi), dx, dy)[
            rows, cols].contiguous()
    raise ValueError(
        f"Unknown reinit method {method!r} (expected 'none', 'pde' or 'fmm')")
