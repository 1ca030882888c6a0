"""Adaptive timestep, blended momentum RHS, the plain RK4 momentum update and
the n-solid momentum step from the maps that the general tier takes
(counterpart of ``pyrmt_tpu.physics``).

The one-fluid mixture blends the stress tensors before the divergence:
sigma = Hf sigma_f + sum_i (1 - H_i) sigma_s_i, with Hf = sum_i H_i - (S-1).
The RHS takes an external force field: surface tension, as the cell-centred
CSF (``external_forces``) or the balanced-force CSF sampled at the faces
(``balanced_csf_forces``), pairwise contact between solids and gravity,
which ``body_forces`` assembles as the JAX step does. On the
doubly-periodic box (``periodic=True``) every stencil is its overlap-grid
wrap variant.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pyrmt_tpu_torch.ops.contact import compute_contact_force
from pyrmt_tpu_torch.ops.fd import (
    diff_upwind_3rd,
    diff_upwind_3rd_periodic,
    grad_central_x_2nd,
    grad_central_x_2nd_periodic,
    grad_central_y_2nd,
    grad_central_y_2nd_periodic,
)
from pyrmt_tpu_torch.ops.levelset import (
    compute_curvature,
    compute_curvature_hf,
)
from pyrmt_tpu_torch.ops.slab import has_offsets, on_slab
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside, solid_cauchy_stress

# How far the RK4 update reads: each of its four stages reads the one
# before at up to +-2 cells (the 3rd-order upwind, and the stress's central
# difference of a central difference). The JAX kernel's _HALO.
RK4_HALO = 8


def _speed_max(a, b, mesh=None):
    """max |(a, b)| over the grid. Where a gradient flows to (a, b) the
    norm is the double-where of the JAX package (sqrt only of a positive
    operand, 0 elsewhere), so a from-rest field's backward stays finite
    (sqrt's derivative at 0 is inf, and a zero cotangent times it NaN);
    otherwise the one sqrt of the max. The two are equal bit for bit.
    With a ``mesh`` (``parallel.sharding``) (a, b) are this rank's block
    and the max is an all-reduce over the ranks, on the device: every
    rank gets the whole grid's value, bit for bit; a gradient is shared
    among the cells of all ranks that attain it (``Mesh.max``'s count),
    as on one device."""
    sq = a * a + b * b
    if not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        m = torch.amax(sq)
        return torch.sqrt(m if mesh is None else mesh.max(m))
    pos = sq > 0.0
    speed = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    m = torch.amax(speed)
    if mesh is None:
        return m
    return mesh.max(m, count=torch.sum(speed == m))


def compute_timestep(a, b, dx, dy, CFL, dt_min_cap, mu_s, rho_s, gamma,
                     rho_f, mu_f=0.0, eta_s=0.0, kappa=0.0, mesh=None):
    """Adaptive dt: the least of the fluid advection CFL, the solid P-wave
    CFL, the Brackbill capillary limit, the viscous limit and dt_min_cap.
    Returns a 0-d tensor; only the fluid CFL reads the device.

    The physics scalars are Python floats or, traced by
    ``sim.make_step(traced_params=...)``, 0-d tensors. With floats the
    static limits are computed on the host; with any tensor the JAX
    package's tensor path runs on the device, its guards double-wheres
    (the P-wave speed's argument kept >= 1e-30, the capillary and viscous
    limits selected on the device), so that dt differentiates with respect
    to every traced scalar. With a ``mesh`` (a, b) are a rank's block
    (``_speed_max``)."""
    u_max = _speed_max(a, b, mesh)
    dt_fluid = CFL * dx / (u_max + 1e-6)

    scalars = (mu_s, rho_s, gamma, rho_f, kappa)
    if any(isinstance(x, torch.Tensor) for x in scalars):
        mu_s, rho_s, gamma, rho_f, kappa = (
            x if isinstance(x, torch.Tensor) else torch.full_like(u_max, x)
            for x in scalars)
        p_arg = (kappa + mu_s * 4.0 / 3.0) / (rho_s + 1e-12)
        cs_solid = torch.sqrt(torch.clamp(p_arg, min=1e-30))
        dt_solid = CFL * dx / (cs_solid + 1e-14)

        # 1.0 is the float path's value of a disabled limit, not a cap
        st_on = gamma > 1e-12
        g_safe = torch.where(st_on, gamma, 1.0)
        rho_avg = 0.5 * (rho_s + rho_f)
        dt_st = torch.where(
            st_on,
            torch.sqrt((rho_avg * dx**3) / (2.0 * math.pi * g_safe)) * 0.5,
            1.0)

        # mu_f and eta_s are not traceable: the viscous limit's gate on
        # them stays on the host
        mu_max = max(mu_f, eta_s)
        dt_static = torch.minimum(dt_solid, dt_st)
        if mu_max > 1e-12:
            rho_min = torch.minimum(rho_s, rho_f)
            dt_visc = torch.where(rho_min > 1e-12,
                                  CFL * rho_min * dx**2 / (4.0 * mu_max), 1.0)
            dt_static = torch.clamp(torch.minimum(dt_static, dt_visc),
                                    max=dt_min_cap)
        else:
            dt_static = torch.clamp(dt_static, max=min(1.0, dt_min_cap))
        return torch.minimum(dt_fluid, dt_static).to(u_max.dtype)

    cs_solid = np.sqrt((kappa + mu_s * 4.0 / 3.0) / (rho_s + 1e-12))
    dt_solid = CFL * dx / (cs_solid + 1e-14)

    dt_st = 1.0
    if gamma > 1e-12:
        rho_avg = 0.5 * (rho_s + rho_f)
        dt_st = np.sqrt((rho_avg * dx**3) / (2.0 * np.pi * gamma)) * 0.5

    dt_visc = 1.0
    mu_max = max(mu_f, eta_s)
    rho_min = min(rho_s, rho_f)
    if mu_max > 1e-12 and rho_min > 1e-12:
        dt_visc = CFL * rho_min * dx**2 / (4.0 * mu_max)

    dt_static = float(min(dt_solid, dt_st, dt_visc, dt_min_cap))
    return torch.clamp(dt_fluid, max=dt_static)


def velocity_rhs_blended(u, v, p, sig_sxx, sig_sxy, sig_syy, dx, dy, mu_f,
                         Hf, rho_local, f_ext_x=None, f_ext_y=None,
                         periodic=False):
    """Conservative one-fluid RHS. ``sig_s**`` are the pre-blended solid
    stresses sum_i (1 - H_i) sigma_s_i and ``Hf`` the fluid fraction. The
    external force (f_ext_x, f_ext_y) adds to the stress divergence, in the
    JAX package's order; without it (None) the sum is left out.
    ``periodic=True`` takes the overlap-grid wrap stencils. The CUDA
    counterpart (Neumann walls only, as in the JAX package) is
    kernels/momentum_rhs.py."""
    if periodic:
        gx2, gy2 = grad_central_x_2nd_periodic, grad_central_y_2nd_periodic
        dup3 = diff_upwind_3rd_periodic
    else:
        gx2, gy2 = grad_central_x_2nd, grad_central_y_2nd
        dup3 = diff_upwind_3rd
    du_dx = gx2(u, dx)
    dv_dy = gy2(v, dy)
    du_dy = gy2(u, dy)
    dv_dx = gx2(v, dx)

    sig_xx = Hf * (2.0 * mu_f * du_dx) + sig_sxx
    sig_yy = Hf * (2.0 * mu_f * dv_dy) + sig_syy
    sig_xy = Hf * (mu_f * (du_dy + dv_dx)) + sig_sxy

    div_sigma_x = gx2(sig_xx, dx) + gy2(sig_xy, dy)
    div_sigma_y = gx2(sig_xy, dx) + gy2(sig_yy, dy)

    u_adv = -u * dup3(u, u, dx, 1) - v * dup3(u, v, dy, 0)
    v_adv = -u * dup3(v, u, dx, 1) - v * dup3(v, v, dy, 0)

    dp_dx = gx2(p, dx)
    dp_dy = gy2(p, dy)

    if f_ext_x is not None:
        div_sigma_x = div_sigma_x + f_ext_x
        div_sigma_y = div_sigma_y + f_ext_y
    inv_rho = 1.0 / (rho_local + 1e-12)
    rhs_u = u_adv + (div_sigma_x - dp_dx) * inv_rho
    rhs_v = v_adv + (div_sigma_y - dp_dy) * inv_rho
    return rhs_u, rhs_v


def _solid_curvature(phi, dx, dy, w_t, curvature, kappa_interface,
                     hf_smooth=0):
    """One solid's curvature: the finite-difference div(grad phi / |grad
    phi|); with ``kappa_interface`` projected to the nearest interface
    point, kappa / (1 - phi kappa) with the denominator kept at |den| >=
    0.25 (kappa*); with ``curvature='hf'`` the height-function estimate
    where its columns are valid, the fd (or kappa*) value its fallback, over
    columns of hh = max(3, ceil(sqrt(2) w_t / min(dx, dy)) + 2) cells each
    side, smoothed with ``hf_smooth`` > 0."""
    kap = compute_curvature(phi, dx, dy)
    if kappa_interface:
        den = 1.0 - phi * kap
        den = torch.where(den >= 0.0, torch.clamp(den, min=0.25),
                          torch.clamp(den, max=-0.25))
        kap = kap / den
    if curvature == "hf":
        kap = compute_curvature_hf(phi, dx, dy, hf_half_height(w_t, dx, dy),
                                   kap, smooth=hf_smooth)
    return kap


def hf_half_height(w_t, dx, dy) -> int:
    """The height function's columns: hh = max(3, ceil(sqrt(2) w_t /
    min(dx, dy)) + 2) cells each side of a cell."""
    return max(3, int(np.ceil(np.sqrt(2.0) * w_t / min(dx, dy))) + 2)


def surface_tension_reach(dx, dy, w_t, st_method="csf", st_curvature="fd",
                          st_hf_smooth=0) -> int:
    """How many cells away along either axis the surface-tension force of
    a cell (and with ``st_method='balanced'`` its east and north faces)
    reads phi, away from the domain's edge: the fd curvature 2 (the central
    difference of the normal, itself one of phi; kappa* is pointwise);
    the height function hh + 1 (its columns of the sharp fractions, which
    read phi at +-1), and st_hf_smooth + 2 across them (the tangential
    smoothing passes, then h' and h'', or the brackets' least product over
    +-(1 + st_hf_smooth) columns); the cell CSF's grad H 1; the balanced
    CSF's faces one more than the curvature (the face's mean of its two
    cells), its cell force the mean of two faces."""
    kap = 2
    if st_curvature == "hf":
        kap = max(kap, hf_half_height(w_t, dx, dy) + 1, st_hf_smooth + 2)
    return kap + 1 if st_method == "balanced" else kap


def external_forces(phis, H_s, dx, dy, *, gamma, k_rep, w_c, w_t,
                    curvature="fd", kappa_interface=False, hf_smooth=0,
                    st_enabled=None):
    """The body forces that stay constant over the RK4 stages: the
    cell-centred CSF surface tension -gamma kappa_i grad H_i of each solid
    (``H_s``: the (S, Ny, Nx) Heaviside stack; the curvature as
    ``_solid_curvature`` estimates it), then pairwise repulsive contact
    between the level sets ``phis``, summed over the pairs i < j, with
    half-width ``w_c`` (2 w_t when None). ``st_enabled`` switches surface
    tension on or off whatever gamma is (None: gamma > 1e-12). Returns
    (f_ext_x, f_ext_y)."""
    S = phis.shape[0]
    f_ext_x = torch.zeros(phis.shape[1:], dtype=phis.dtype,
                          device=phis.device)
    f_ext_y = torch.zeros_like(f_ext_x)
    if st_enabled is None:
        st_enabled = gamma > 1e-12
    if st_enabled:
        for i in range(S):
            kap = _solid_curvature(phis[i], dx, dy, w_t, curvature,
                                   kappa_interface, hf_smooth=hf_smooth)
            dH_dx = grad_central_x_2nd(H_s[i], dx)
            dH_dy = grad_central_y_2nd(H_s[i], dy)
            f_ext_x = f_ext_x - gamma * kap * dH_dx
            f_ext_y = f_ext_y - gamma * kap * dH_dy
    if k_rep > 0.0 and S >= 2:
        wc = (2.0 * w_t) if w_c is None else w_c
        for i in range(S):
            for j in range(i + 1, S):
                fcx, fcy = compute_contact_force(phis[i], phis[j], k_rep, wc,
                                                 dx, dy)
                f_ext_x = f_ext_x + fcx
                f_ext_y = f_ext_y + fcy
    return f_ext_x, f_ext_y


def balanced_csf_forces(phis, H_s, dx, dy, gamma, kappas=None,
                        kappa_interface=False, curvature="fd", w_t=None,
                        hf_smooth=0):
    """The balanced-force CSF (Francois et al. 2006 on the collocated
    Rhie-Chow grid): the capillary force sampled compactly at the faces,
    Fx_face = -gamma kappa_face (H_E - H_C) / dx with kappa_face the mean
    of the two cells' curvatures, the same difference the face pressure
    jump takes, and the cell force the mean of its two faces (zero beyond
    the domain's edge), so that for a face-constant curvature p = gamma
    kappa H + const balances it exactly. ``kappas`` ((S, Ny, Nx)) replaces
    the estimated curvatures (projected as kappa* with
    ``kappa_interface``). Returns (fx_cell, fy_cell, Fx_face, Fy_face),
    the faces (Ny, Nx - 1) and (Ny - 1, Nx); the projection takes all four
    as ``st_faces``."""
    S = phis.shape[0]
    Ny, Nx = phis.shape[1:]
    like = dict(dtype=phis.dtype, device=phis.device)
    Fx = torch.zeros((Ny, Nx - 1), **like)
    Fy = torch.zeros((Ny - 1, Nx), **like)
    for i in range(S):
        if kappas is not None:
            kap = kappas[i]
            if kappa_interface:
                den = 1.0 - phis[i] * kap
                den = torch.where(den >= 0.0, torch.clamp(den, min=0.25),
                                  torch.clamp(den, max=-0.25))
                kap = kap / den
        else:
            kap = _solid_curvature(phis[i], dx, dy, w_t, curvature,
                                   kappa_interface, hf_smooth=hf_smooth)
        kx_f = 0.5 * (kap[:, :-1] + kap[:, 1:])
        ky_f = 0.5 * (kap[:-1, :] + kap[1:, :])
        Fx = Fx - gamma * kx_f * (H_s[i][:, 1:] - H_s[i][:, :-1]) / dx
        Fy = Fy - gamma * ky_f * (H_s[i][1:, :] - H_s[i][:-1, :]) / dy
    zx = torch.zeros((Ny, 1), **like)
    zy = torch.zeros((1, Nx), **like)
    Fx_pad = torch.cat([zx, Fx, zx], dim=1)
    Fy_pad = torch.cat([zy, Fy, zy], dim=0)
    fx_cell = 0.5 * (Fx_pad[:, :-1] + Fx_pad[:, 1:])
    fy_cell = 0.5 * (Fy_pad[:-1, :] + Fy_pad[1:, :])
    return fx_cell, fy_cell, Fx, Fy


def body_forces(phis, rho_local, dx, dy, *, gamma, k_rep, w_c, w_t,
                g_x=0.0, g_y=0.0, g_rho_ref=1.0, st_method="csf",
                st_curvature="fd", st_kappa_interface=False, st_hf_smooth=0,
                with_faces=False, st_enabled=None):
    """The step's stage-constant force (f_x, f_y), as the JAX step builds
    it: with surface tension (``st_enabled``; None: gamma > 1e-12, which
    needs a float gamma; a traced gamma comes with its configuration's
    gate, as the JAX step gates it) or contact, the balanced CSF
    (``st_method='balanced'``) plus the contact of ``external_forces`` at
    gamma 0, or ``external_forces`` with the cell CSF; then gravity's
    (rho_local - g_rho_ref) g; (None, None) with none of them. The
    Heaviside stack of the level sets ``phis`` feeds the CSF. With
    ``with_faces`` returns (f_x, f_y, st_faces): the balanced CSF's
    (Fx_face, Fy_face, fx_cell, fy_cell) for the projection, else None."""
    S = phis.shape[0]
    st = (gamma > 1e-12 if st_enabled is None else st_enabled) and S > 0
    forces = st or (k_rep > 0.0 and S >= 2)
    gravity = g_x != 0.0 or g_y != 0.0
    st_faces = None
    if forces:
        H_s = smoothed_heaviside(phis, w_t) if st else None
        kw = dict(k_rep=k_rep, w_c=w_c, w_t=w_t)
        if st and st_method == "balanced":
            fxc, fyc, Fxf, Fyf = balanced_csf_forces(
                phis, H_s, dx, dy, gamma, kappa_interface=st_kappa_interface,
                curvature=st_curvature, w_t=w_t, hf_smooth=st_hf_smooth)
            cfx, cfy = external_forces(phis, H_s, dx, dy, gamma=0.0, **kw)
            fx, fy = fxc + cfx, fyc + cfy
            st_faces = (Fxf, Fyf, fxc, fyc)
        else:
            fx, fy = external_forces(
                phis, H_s, dx, dy, gamma=gamma, curvature=st_curvature,
                kappa_interface=st_kappa_interface, hf_smooth=st_hf_smooth,
                st_enabled=st, **kw)
    if not gravity:
        out = (fx, fy) if forces else (None, None)
    else:
        drho = rho_local - g_rho_ref
        out = ((drho * g_x, drho * g_y) if not forces
               else (fx + drho * g_x, fy + drho * g_y))
    return (*out, st_faces) if with_faces else out


def momentum_core(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                  rho_local, mkv, velocity_bc, *, eta_s, dx, dy, dt, mu_f,
                  f_ext_x=None, f_ext_y=None, rhs_fn=velocity_rhs_blended,
                  periodic=False, row_offset=None, Ny_total=None,
                  col_offset=None, Nx_total=None):
    """Plain RK4 velocity update from pre-blended fields, with the velocity
    BC applied to every stage input and to the result.

    ``mkv`` is the Kelvin-Voigt blend mask sum_i mask_i (1 - H_i); it is
    read only when eta_s > 0. ``f_ext_x``, ``f_ext_y`` are the stage-
    constant body forces, None for none. ``rhs_fn`` is each stage's RHS,
    called as ``velocity_rhs_blended`` after the stage loop's BC and
    Kelvin-Voigt ops, with the force keywords where a force is given: the
    plain version, or the one-RHS kernel (kernels/momentum_rhs.py) as
    ``use_pallas_rhs`` selects. ``periodic=True`` takes the overlap-grid
    wrap stencils and the plain RHS, whatever ``rhs_fn`` is: the JAX
    package skips its one-RHS kernel on the periodic box. The CUDA
    counterpart of the whole update is kernels/momentum_rk4.py.

    ``row_offset``, ``Ny_total``, ``col_offset``, ``Nx_total`` make the
    fields one shard's slab (``ops.slab.on_slab``; the JAX kernel's
    operands): the update of the domain's cells, with the BC at the
    domain's edge, and 0 within ``RK4_HALO`` cells of a cut and outside the
    domain, as the CUDA kernel leaves them. Not on the periodic box.
    """
    if has_offsets(row_offset, Ny_total, col_offset, Nx_total):
        if periodic:
            raise ValueError("momentum_core: the periodic box takes no "
                             "sharding offsets")
        return on_slab(
            momentum_core, (u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                            rho_local, mkv, velocity_bc),
            dict(eta_s=eta_s, dx=dx, dy=dy, dt=dt, mu_f=mu_f,
                 f_ext_x=f_ext_x, f_ext_y=f_ext_y, rhs_fn=rhs_fn),
            row_offset=row_offset, Ny_total=Ny_total, col_offset=col_offset,
            Nx_total=Nx_total, stale=RK4_HALO)
    rhs_kw = {} if f_ext_x is None else dict(f_ext_x=f_ext_x, f_ext_y=f_ext_y)
    if periodic:
        gx2, gy2 = grad_central_x_2nd_periodic, grad_central_y_2nd_periodic
        rhs_kw["periodic"] = True
        rhs_fn = velocity_rhs_blended
    else:
        gx2, gy2 = grad_central_x_2nd, grad_central_y_2nd

    def rhs(u_stage, v_stage):
        u_stage, v_stage = velocity_bc(u_stage, v_stage)
        sxx, sxy, syy = sig_sxx_el, sig_sxy_el, sig_syy_el
        if eta_s > 0.0:
            # Kelvin-Voigt damping: eta_s times the rate of strain inside
            # the solid, through the same (1 - H) blend as the elastic
            # stress
            du_dx = gx2(u_stage, dx)
            dv_dy = gy2(v_stage, dy)
            du_dy = gy2(u_stage, dy)
            dv_dx = gx2(v_stage, dx)
            sxx = sxx + mkv * (eta_s * du_dx)
            syy = syy + mkv * (eta_s * dv_dy)
            sxy = sxy + mkv * (eta_s * 0.5 * (du_dy + dv_dx))
        return rhs_fn(u_stage, v_stage, p, sxx, sxy, syy, dx, dy, mu_f, Hf,
                      rho_local, **rhs_kw)

    k1u, k1v = rhs(u, v)
    k2u, k2v = rhs(u + 0.5 * dt * k1u, v + 0.5 * dt * k1v)
    k3u, k3v = rhs(u + 0.5 * dt * k2u, v + 0.5 * dt * k2v)
    k4u, k4v = rhs(u + dt * k3u, v + dt * k3v)

    # dt * (1/6), not dt / 6: the CUDA kernel rounds the same way
    u_new = u + (dt * (1.0 / 6.0)) * (k1u + 2 * k2u + 2 * k3u + k4u)
    v_new = v + (dt * (1.0 / 6.0)) * (k1v + 2 * k2v + 2 * k3v + k4v)
    return velocity_bc(u_new, v_new)


def momentum_step_rk4_multi(
    u, v, p, X1s, X2s, phis, velocity_bc, *, mu_s, kappa, eta_s, dx, dy,
    dt, rho_s, rho_f, mu_f, w_t, gamma=0.0, stress_w_cut=0.0,
    stress_clamp=0.0, k_rep=0.0, w_c=None, g_x=0.0, g_y=0.0,
    g_rho_ref=None, ext_override=None, st_curvature="fd",
    st_kappa_interface=False, st_hf_smooth=0, use_pallas_rhs=False,
    momentum_fn=None, periodic=False, st_enabled=None, mesh=None,
):
    """The n-solid RK4 momentum step from the maps: each solid's stress
    and J from (X1s[i], X2s[i], phis[i]) ((S, Ny, Nx) stacks), the
    mixture blends, the stage-constant force and the RK4 update. Returns
    (u_new, v_new, sxx, sxy, syy, J), the last four (S, Ny, Nx).

    The force is ``ext_override`` (f_x, f_y) where given (the step's
    balanced CSF and contact), else the cell CSF and the contact of
    ``external_forces`` (zero fields where neither acts), then gravity's
    (rho_local - g_rho_ref) g (g_rho_ref None: rho_f), as in the JAX
    package: the update always takes a force operand.

    ``momentum_fn`` is the RK4 update, called as ``momentum_core``; by
    default the RK4 kernel's wrapper where it applies ``velocity_bc``
    (``momentum_rk4_supported``: the kernel on a CUDA tensor, the plain
    update on a CPU one), else the plain stage loop, whose stage RHS is the
    one-RHS kernel with ``use_pallas_rhs``.

    With a ``mesh`` (``parallel.sharding``) the fields are a rank's block:
    the stress runs on slabs of ``STENCIL_HALO`` exchanged cells, cut back
    to the block (``Mesh.stencil``); a force that reads neighbours (the
    CSF, the contact) comes as ``ext_override``, built on slabs of its
    reach, and ``momentum_fn`` is the sharded update
    (``parallel.sharding.make_momentum_rk4_sharded``).
    """
    S = X1s.shape[0]

    def stresses(X1s, X2s, phis):
        stress = [solid_cauchy_stress(X1s[i], X2s[i], dx, dy, mu_s, kappa,
                                      phis[i], w_cut=stress_w_cut,
                                      detg_clamp=stress_clamp)
                  for i in range(S)]
        return tuple(torch.stack(c) for c in zip(*stress))

    if mesh is not None:
        stresses = mesh.stencil(stresses)
    sxx_s, sxy_s, syy_s, J_s = stresses(X1s, X2s, phis)

    H_s = smoothed_heaviside(phis, w_t)
    one_minus_H = 1.0 - H_s
    Hf = torch.sum(H_s, dim=0) - (S - 1.0)
    rho_local = Hf * rho_f + torch.sum(one_minus_H, dim=0) * rho_s
    sig_sxx_el = torch.sum(one_minus_H * sxx_s, dim=0)
    sig_sxy_el = torch.sum(one_minus_H * sxy_s, dim=0)
    sig_syy_el = torch.sum(one_minus_H * syy_s, dim=0)

    if ext_override is not None:
        f_ext_x, f_ext_y = ext_override
    else:
        f_ext_x, f_ext_y = external_forces(
            phis, H_s, dx, dy, gamma=gamma, k_rep=k_rep, w_c=w_c, w_t=w_t,
            curvature=st_curvature, kappa_interface=st_kappa_interface,
            hf_smooth=st_hf_smooth, st_enabled=st_enabled)
    if g_x != 0.0 or g_y != 0.0:
        drho = rho_local - (rho_f if g_rho_ref is None else g_rho_ref)
        f_ext_x = f_ext_x + drho * g_x
        f_ext_y = f_ext_y + drho * g_y

    mkv = (torch.sum((phis <= 0.0).to(u.dtype) * one_minus_H, dim=0)
           if eta_s > 0.0 else torch.zeros_like(u))

    if momentum_fn is None:
        momentum_fn = _default_momentum_fn(velocity_bc, use_pallas_rhs)
    u_new, v_new = momentum_fn(
        u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf, rho_local, mkv,
        velocity_bc, eta_s=eta_s, dx=dx, dy=dy, dt=dt, mu_f=mu_f,
        f_ext_x=f_ext_x, f_ext_y=f_ext_y, periodic=periodic)
    return u_new, v_new, sxx_s, sxy_s, syy_s, J_s


def _default_momentum_fn(velocity_bc, use_pallas_rhs=False):
    """``momentum_step_rk4_multi``'s RK4 update for ``velocity_bc``, as
    ``make_step`` picks it under ``momentum_method`` 'auto': the RK4
    kernel's wrapper where the kernel applies the BC, else the plain stage
    loop, with the one-RHS kernel at each stage under ``use_pallas_rhs``
    (imported here: the kernel wrappers import this module)."""
    from pyrmt_tpu_torch.kernels.momentum_rhs import (
        velocity_rhs_blended_fused,
    )
    from pyrmt_tpu_torch.kernels.momentum_rk4 import (
        momentum_rk4_fused,
        momentum_rk4_supported,
    )

    if momentum_rk4_supported(velocity_bc):
        return momentum_rk4_fused
    if use_pallas_rhs:
        return functools.partial(momentum_core,
                                 rhs_fn=velocity_rhs_blended_fused)
    return momentum_core


def momentum_step_rk4(u, v, p, X1, X2, velocity_bc, mu_s, kappa, eta_s, dx,
                      dy, dt, rho_s, rho_f, phi, mu_f, w_t, gamma=0.0,
                      stress_band=False, detg_clamp=3.0):
    """One solid (pyRMT's ``velocity_RK4``): ``momentum_step_rk4_multi``
    with the band-mode stress clamped to ``detg_clamp`` under
    ``stress_band``. Returns (u, v, sxx, sxy, syy, J)."""
    w_cut = w_t if stress_band else 0.0
    clamp = detg_clamp if stress_band else 0.0
    u_new, v_new, sxx_s, sxy_s, syy_s, J_s = momentum_step_rk4_multi(
        u, v, p, X1[None], X2[None], phi[None], velocity_bc,
        mu_s=mu_s, kappa=kappa, eta_s=eta_s, dx=dx, dy=dy, dt=dt,
        rho_s=rho_s, rho_f=rho_f, mu_f=mu_f, w_t=w_t, gamma=gamma,
        stress_w_cut=w_cut, stress_clamp=clamp)
    return u_new, v_new, sxx_s[0], sxy_s[0], syy_s[0], J_s[0]


def momentum_step_rk4_2solids(u, v, p, X1a, X2a, X1b, X2b, velocity_bc, mu_s,
                              kappa, eta_s, dx, dy, dt, rho_s, rho_f, phi_a,
                              phi_b, mu_f, w_t, k_rep=0.0, w_c=None,
                              detg_clamp=4.0):
    """Two solids (pyRMT's two-solid step): the interior stress with the
    det G clamp, no Kelvin-Voigt term (``eta_s`` is not read, as in the
    JAX package) and the contact force. Returns (u, v, min(J_a, J_b))."""
    u_new, v_new, _, _, _, J_s = momentum_step_rk4_multi(
        u, v, p, torch.stack([X1a, X1b]), torch.stack([X2a, X2b]),
        torch.stack([phi_a, phi_b]), velocity_bc,
        mu_s=mu_s, kappa=kappa, eta_s=0.0, dx=dx, dy=dy, dt=dt,
        rho_s=rho_s, rho_f=rho_f, mu_f=mu_f, w_t=w_t, gamma=0.0,
        stress_w_cut=0.0, stress_clamp=detg_clamp, k_rep=k_rep, w_c=w_c)
    return u_new, v_new, torch.minimum(J_s[0], J_s[1])
