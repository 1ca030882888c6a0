"""Simulation state and the FSI step (counterpart of ``pyrmt_tpu.sim``).

    state', aux = step(state, t_end)

One step of the ported slice, the fused branch of the JAX ``make_step``:
  1. adaptive dt (compute_timestep), clipped at t_end;
  2. the RMT solid block (kernels/rmt_block.py): rebuild, advect, mask,
     extrapolate, rebuild, stress, Heaviside, mixture blends;
  3. the RK4 momentum update (kernels/momentum_rk4.py);
  4. the incremental Rhie-Chow projection with the DCT-I Poisson solve;
  5. t += dt.

On a CUDA state the two blocks run their CUDA kernels; on a CPU state they
run the plain PyTorch versions. dt stays a 0-d device tensor for the whole
step, so a step never waits for the card.

The step takes the flagship's feature set (one solid, semi-Lagrangian
gather-free bilinear advection with CFL < 1, Neumann walls, constant
density, no surface tension, gravity, reinitialisation, area fix or
rebasing) and raises NotImplementedError, naming the ROADMAP item that
ports it, for anything else.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_fused
from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_fused
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.ops.poisson import (
    precompute_dct_matrices,
    precompute_poisson_eigenvalues,
)
from pyrmt_tpu_torch.ops.projection import pressure_projection
from pyrmt_tpu_torch.physics import compute_timestep


@dataclasses.dataclass
class SimState:
    """The whole simulation state; tensors on one device."""

    u: torch.Tensor      # (Ny, Nx)
    v: torch.Tensor      # (Ny, Nx)
    p: torch.Tensor      # (Ny, Nx)
    X1: torch.Tensor     # (S, Ny, Nx) reference-map x-components
    X2: torch.Tensor     # (S, Ny, Nx) reference-map y-components
    t: torch.Tensor      # 0-d time
    step: torch.Tensor   # 0-d int32 step counter
    phis0: torch.Tensor | None = None  # (0, Ny, Nx): base level sets of
                                       # map rebasing, which is not ported


@dataclasses.dataclass(frozen=True)
class RMTConfig:
    """Static configuration, with the field names and defaults of
    ``pyrmt_tpu.sim.RMTConfig`` so that one dict builds both. The fields
    that select a TPU implementation or tune a Pallas kernel
    (``rmt_method``, ``momentum_method``, ``extrap_method``, ``dct_method``,
    ``rmt_panel_width``, ``rmt_tile``, ``kernel_slab_halo``) are accepted and
    do not change the port's path: the state's device chooses kernels or
    plain versions. ``make_step`` checks the rest against the slice."""

    grid: Grid
    mu_s: float = 0.0
    kappa: float = 0.0
    eta_s: float = 0.0
    rho_s: float = 1.0
    mu_f: float = 1.0
    rho_f: float = 1.0
    gamma: float = 0.0
    st_method: str = "csf"
    st_kappa_interface: bool = False
    st_curvature: str = "fd"
    st_hf_smooth: int = 0
    g_x: float = 0.0
    g_y: float = 0.0
    g_rho_ref: float | None = None
    w_t_cells: float = 2.0
    scheme: str = "semilagrangian"
    bc_type: str = "neumann"
    reinit_method: str = "none"
    reinit_iters: int = 20
    map_rebase_minj: float = 0.0
    map_rebase_rebuild: str = "cond"
    phi_area_fix: bool = False
    stress_band: bool = False
    detg_clamp: float = 3.0
    two_solid_clamp: float = 4.0
    num_layers: int = 3
    w_cut: float = 0.0
    k_rep: float = 0.0
    w_c_cells: float = 3.0
    CFL: float = 0.2
    dt_min_cap: float = 1e-3
    fixed_dt: float | None = None
    sl_local: bool = True
    sl_interp: str = "bilinear"
    sl_band_guard: float = 3.0
    use_pallas_rhs: bool = False
    dct_method: str = "auto"
    dct_precision: str = "auto"
    extrap_method: str = "auto"
    momentum_method: str = "auto"
    rmt_method: str = "auto"
    rmt_panel_width: int | None = None
    rmt_tile: int | None = None
    kernel_slab_halo: bool = True
    projection_method: str = "auto"
    variable_rho: bool = False
    cg_tol: float = 1e-6
    cg_maxiter: int = 200

    @property
    def w_t(self) -> float:
        return self.w_t_cells * self.grid.dx

    @property
    def w_c(self) -> float:
        return self.w_c_cells * self.grid.dx


# (what, is it outside the slice?, the ROADMAP item that ports it)
_OUTSIDE_SLICE = (
    ("scheme != 'semilagrangian'",
     lambda c: c.scheme != "semilagrangian", "modules item 14"),
    ("sl_local=False", lambda c: not c.sl_local, "modules item 9"),
    ("CFL >= 1 (the gather-free backtrace needs CFL < 1)",
     lambda c: c.CFL >= 1.0, "modules item 9"),
    ("sl_interp='bicubic'", lambda c: c.sl_interp != "bilinear",
     "modules item 10"),
    ("bc_type='periodic'", lambda c: c.bc_type != "neumann",
     "modules item 13"),
    ("reinitialisation", lambda c: c.reinit_method != "none",
     "modules item 9"),
    ("phi_area_fix", lambda c: c.phi_area_fix, "modules item 9"),
    ("map rebasing", lambda c: c.map_rebase_minj > 0.0, "modules item 9"),
    ("stress_band (band-mode stress)", lambda c: c.stress_band,
     "modules item 9"),
    ("surface tension", lambda c: c.gamma > 1e-12, "modules item 11"),
    ("gravity", lambda c: c.g_x != 0.0 or c.g_y != 0.0, "modules item 11"),
    ("variable_rho", lambda c: c.variable_rho, "modules item 12"),
    ("use_pallas_rhs (velocity_rhs_blended_pallas)",
     lambda c: c.use_pallas_rhs, "kernels item 6"),
    ("projection_method='pallas' (rc_rhs_pallas, grad_correct_pallas)",
     lambda c: c.projection_method == "pallas", "kernels item 5"),
)

_KNOWN_VALUES = {
    "rmt_method": ("auto", "xla", "pallas"),
    "momentum_method": ("auto", "xla", "pallas"),
    "extrap_method": ("auto", "xla", "sparse", "pallas"),
    "dct_method": ("auto", "fft", "matmul", "matmul_rec"),
    "projection_method": ("auto", "xla", "pallas"),
    # the TPU's reduced-precision DCT passes (docs/DESIGN.md #6) are not
    # carried over: the port's DCT runs in full precision
    "dct_precision": ("auto", "highest"),
}


def check_narrow_band(w_t, dx, num_layers):
    """Raise if the extrapolation band cannot cover the (1 - H) > 0 blend
    region: it needs ceil(w_t/dx) + 1 layers."""
    need = int(math.ceil(w_t / dx)) + 1
    if num_layers < need:
        raise ValueError(
            "Narrow-band inconsistency: w_t=%.4g (=%0.2f dx) needs >= %d "
            "extrapolation layers but only %d requested."
            % (w_t, w_t / dx, need, num_layers))
    return need


def check_slice(cfg: RMTConfig, n_solids: int) -> None:
    """Raise NotImplementedError for a configuration outside the ported
    slice and ValueError for an unknown option value."""
    for name, values in _KNOWN_VALUES.items():
        if getattr(cfg, name) not in values:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: expected one "
                             f"of {values}")
    if n_solids != 1:
        item = "modules item 11" if n_solids > 1 else "modules item 17"
        raise NotImplementedError(
            f"{n_solids} solids: the port runs one solid so far; this waits "
            f"for ROADMAP {item}")
    for what, outside, item in _OUTSIDE_SLICE:
        if outside(cfg):
            raise NotImplementedError(
                f"{what} is outside the ported slice; it waits for ROADMAP "
                f"{item}")


def make_step(
    cfg: RMTConfig,
    velocity_bc: Callable,
    phi_inits: Sequence[Callable] = (),
    dtype=torch.float32,
    device="cpu",
    rmt_block_impl: Callable | None = None,
    momentum_rk4_impl: Callable | None = None,
):
    """Build the FSI step for a fixed configuration.

    ``phi_inits`` holds one level-set function of the reference map per
    solid (the kernel path needs ``ops.levelset.Disc``); ``velocity_bc`` is
    one of ``bcs``. Returns ``step(state, t_end) -> (state, aux)``.

    ``rmt_block_impl`` / ``momentum_rk4_impl`` substitute the two blocks
    with functions of the same signatures, for example the plain versions
    ``kernels.rmt_block.rmt_block_plain`` and ``physics.momentum_core`` to
    run the plain path on a CUDA state.

    Building a step turns TF32 off for matmuls and cuDNN: the DCT solve's
    matrix products must run in full float32.
    """
    check_slice(cfg, len(phi_inits))
    g = cfg.grid
    dx, dy = g.dx, g.dy
    check_narrow_band(cfg.w_t, dx, cfg.num_layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    eig = precompute_poisson_eigenvalues(g.Nx, g.Ny, dx, dy, dtype, device)
    dct_mats = precompute_dct_matrices(g.Nx, g.Ny, dtype, device)
    params = torch.tensor([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f],
                          dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    fixed_dt = (None if cfg.fixed_dt is None else
                torch.full((), cfg.fixed_dt, dtype=dtype, device=device))
    rmt_fn = rmt_block_impl or rmt_block_fused
    momentum_fn = momentum_rk4_impl or momentum_rk4_fused
    phi_inits = tuple(phi_inits)

    def step(state: SimState, t_end):
        u, v, p = state.u, state.v, state.p
        if fixed_dt is not None:
            dt = fixed_dt
        else:
            dt = compute_timestep(
                u, v, dx, dy, cfg.CFL, cfg.dt_min_cap, cfg.mu_s, cfg.rho_s,
                cfg.gamma, cfg.rho_f, mu_f=cfg.mu_f, eta_s=cfg.eta_s,
                kappa=cfg.kappa)
        dt = torch.minimum(dt, torch.clamp(t_end - state.t, min=0.0)).to(dtype)
        # Once t reaches t_end the clipped dt is 0 and rho*div/dt would be
        # NaN: run the step with dt = 1 and freeze the state afterwards, so
        # a loop can overrun t_end with no-op steps.
        active = dt > 0.0
        dt = torch.where(active, dt, one)

        (X1e, X2e, phis, sxx, sxy, syy, J, Hf, rho_local,
         sb_xx, sb_xy, sb_yy) = rmt_fn(
            u, v, state.X1, state.X2, dt, phi_inits=phi_inits, dx=dx, dy=dy,
            num_layers=cfg.num_layers, w_t=cfg.w_t, params=params)

        if cfg.eta_s > 0.0:
            # Kelvin-Voigt mask of the one solid: (phi <= 0) (1 - Hf)
            mkv = (phis[0] <= 0.0).to(dtype) * (1.0 - Hf)
        else:
            mkv = torch.zeros_like(u)
        u_star, v_star = momentum_fn(
            u, v, p, sb_xx, sb_xy, sb_yy, Hf, rho_local, mkv, velocity_bc,
            eta_s=cfg.eta_s, dx=dx, dy=dy, dt=dt, mu_f=cfg.mu_f)
        u_new, v_new, p_new = pressure_projection(
            u_star, v_star, dx, dy, dt, rho_local, velocity_bc, p, eig,
            dct_mats)

        # On a no-op step the state stays exactly frozen; the aux fields
        # reflect the discarded trial step, as on the JAX fused path.
        def frz(new, old):
            return torch.where(active, new, old)

        dt_taken = torch.where(active, dt, zero)
        new_state = SimState(
            u=frz(u_new, u), v=frz(v_new, v), p=frz(p_new, p),
            X1=frz(X1e, state.X1), X2=frz(X2e, state.X2),
            t=state.t + dt_taken,
            step=state.step + active.to(torch.int32),
            phis0=state.phis0,
        )
        aux = {"dt": dt_taken, "phis": phis, "J": J, "sxx": sxx, "sxy": sxy,
               "syy": syy, "rho_local": rho_local}
        return new_state, aux

    return step


def make_init_state(cfg: RMTConfig, phi_inits: Sequence[Callable] = (),
                    u0=None, v0=None, dtype=torch.float32, device="cpu"):
    """Initial state: reference maps seeded with the identity inside each
    solid and extrapolated ``num_layers`` cells into the fluid."""
    g = cfg.grid
    X, Y = g.coords(dtype=dtype, device=device)
    zeros = torch.zeros(g.shape, dtype=dtype, device=device)
    u = zeros if u0 is None else torch.as_tensor(u0, dtype=dtype, device=device)
    v = zeros if v0 is None else torch.as_tensor(v0, dtype=dtype, device=device)
    X1s, X2s = [], []
    for phi_init in phi_inits:
        phi = phi_init(X, Y).to(dtype)
        mask = (phi <= 0.0).to(dtype)
        X1e, X2e = extrapolate_reference_map(X * mask, Y * mask, phi, g.dx,
                                             g.dy, cfg.num_layers)
        X1s.append(X1e)
        X2s.append(X2e)
    empty = torch.zeros((0,) + g.shape, dtype=dtype, device=device)
    return SimState(
        u=u, v=v, p=zeros.clone(),
        X1=torch.stack(X1s) if X1s else empty,
        X2=torch.stack(X2s) if X2s else empty.clone(),
        t=torch.zeros((), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        phis0=empty.clone(),
    )


def diverged(state: SimState, umax_cap=1.0e3):
    """0-d bool tensor: a non-finite field or |u| above the cap."""
    umax = torch.amax(torch.sqrt(state.u**2 + state.v**2))
    finite = (torch.isfinite(state.u).all() & torch.isfinite(state.v).all()
              & torch.isfinite(state.p).all()
              & torch.isfinite(state.X1).all()
              & torch.isfinite(state.X2).all())
    return (~finite) | (umax > umax_cap)


def run_until(step_fn, state: SimState, t_end, max_steps=10**8,
              callback=None):
    """Host-driven loop: one step per iteration with an optional host
    callback. Stops at t_end or divergence; returns (state, diverged)."""
    n = 0
    while float(state.t) < t_end and n < max_steps:
        state, aux = step_fn(state, t_end)
        n += 1
        if callback is not None:
            callback(state, aux)
        if bool(diverged(state)):
            return state, True
    return state, False


def make_run_chunk(step_fn, n_steps: int):
    """``run_chunk(state, t_end) -> (state, t)``: ``n_steps`` steps with no
    host round-trip (steps past t_end are no-ops)."""

    def run_chunk(state: SimState, t_end):
        for _ in range(n_steps):
            state, _aux = step_fn(state, t_end)
        return state, state.t

    return run_chunk
