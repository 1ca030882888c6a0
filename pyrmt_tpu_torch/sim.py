"""Simulation state, the FSI step and the rebasing runner (counterpart of
``pyrmt_tpu.sim``).

    state', aux = step(state, t_end)

One step:
  1. adaptive dt (compute_timestep), clipped at t_end;
  2. the RMT solid block, on one of three tiers:
     - fused (semi-Lagrangian advection with the gather-free backtrace,
       CFL < 1, and no level-set post-processing): kernels/rmt_block.py
       ``rmt_block_fused`` rebuilds, advects, masks, extrapolates,
       rebuilds, and computes the stress, Heaviside and mixture blends;
     - split (the same advection with reinitialisation, area fix or map
       rebasing): the phi chain (rebuild, reinit, area fix) as plain ops,
       then ``advext_block_fused`` (advect, mask, extrapolate given phi),
       then the rebuild (+ area fix), stress and blends as plain ops;
     - general (``scheme`` 'weno5' or 'central2', ``sl_local=False`` or
       CFL >= 1), the JAX package's unfused step op for op: the phi chain,
       the advection as plain ops (``ops.advect``: WENO5 or central2 with
       SSP-RK3 over the 2S map components at once, or the RK4 backtrace
       and the general gather), the mask, each solid's extrapolation in
       kernels/extrapolate_fused.py, the maps frozen on a no-op step, the
       rebuild (+ area fix), then the stress and blends with the momentum
       (``physics.momentum_step_rk4_multi``);
  3. the body forces, as plain ops (``physics.body_forces``): surface
     tension (``gamma > 0``: the cell-centred CSF, or with
     ``st_method='balanced'`` the balanced-force CSF, whose face forces go
     on to the projection), pairwise contact between two solids or more
     (``k_rep > 0``) and gravity ((rho - rho_ref) g); then the RK4 momentum
     update: by default (``momentum_method`` 'auto' or 'pallas') all four
     stages in kernels/momentum_rk4.py where the kernel applies the BC
     (``momentum_rk4_supported``), else and with ``momentum_method='xla'``
     the stage loop of ``physics.momentum_core``, whose stage RHS is
     kernels/momentum_rhs.py with ``use_pallas_rhs``;
  4. the projection: under Neumann walls the incremental Rhie-Chow
     projection with the DCT-I Poisson solve, its two stencil chains fused
     into kernels/projection_stencils.py with ``projection_method='pallas'``
     (where the kernel applies the BC, with constant density and no face
     forces), with ``variable_rho`` the DCT-preconditioned CG solve; on the
     doubly-periodic box (``bc_type='periodic'``) the FFT solve on the
     reduced sub-grid, as plain ops on every path;
  5. with rebasing, ``maybe_rebase``; t += dt.

On a CUDA state the blocks run their CUDA kernels; on a CPU state they run
the plain PyTorch versions. dt stays a 0-d device tensor for the whole
step, so a step never waits for the card, except where rebasing reads its
trigger (``map_rebase_rebuild`` 'cond' or 'sampled': once per step) and
where the variable-density CG reads its stopping test (once every
``ops.poisson.CG_READ_EVERY`` iterations). The built step's ``paths``
names the path each block takes.

The step differentiates on either device: every kernel wrapper is an
``autograd.Function`` whose backward is its plain version's autograd
(``kernels._autograd``), and the CG has its implicit adjoint.
``make_step(traced_params=...)`` takes physics scalars at run time,
``make_rollout`` checkpoints a rollout step by step, and
``diff.make_diff_step`` keeps only each step's inputs for the backward.

The step takes no solid (the pure-fluid solver: no solid block, the
constant blends Hf = 1, rho = rho_f and no solid stress into the RK4
kernel), one solid or more (two or more with the JAX package's two-solid
stress: interior mode, det G clamped to ``two_solid_clamp``; one solid with
``stress_band`` the band-mode stress, clamped to ``detg_clamp``), pairwise
contact and gravity, surface tension (the cell-centred or balanced-force
CSF) and variable density (the CG projection), with any of the JAX
package's advection schemes: semi-Lagrangian (whose final sample is
bilinear or, with ``sl_interp='bicubic'``, bicubic under the band guard
``sl_band_guard``, raw with a guard of 0), WENO5 or central2 (banded by
``w_cut``), on Neumann walls or the doubly-periodic box (the periodic
stencils in the momentum, the solid block clamped at the edge as in the
JAX package, so a solid must keep ``periodic_seam_clearance_cells`` from
the seam). The fused tier's kernel evaluates discs and ellipses
(``ops.levelset.Disc``, ``Ellipse``), 16 at most; another level set, or
more solids, takes the split tier, which reads phi as a field.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Sequence

import torch
import torch.utils.checkpoint

from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.kernels.extrapolate_fused import (
    extrapolate_reference_map_fused,
)
from pyrmt_tpu_torch.kernels.momentum_rhs import velocity_rhs_blended_fused
from pyrmt_tpu_torch.kernels.momentum_rk4 import (
    momentum_rk4_fused,
    momentum_rk4_supported,
)
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_fused,
    grad_correct_plain,
    projection_stencils_supported,
    rc_rhs_fused,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.kernels.rmt_block import (
    SL_INTERPS,
    advext_block_fused,
    rmt_block_fused,
    rmt_block_supported,
)
from pyrmt_tpu_torch.ops.advect import (
    RK3_REACH,
    advect_reference_map_multi,
    check_scheme,
)
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.ops.interp import bilinear_interpolate
from pyrmt_tpu_torch.ops.levelset import (
    area_conserving_shift,
    reinitialize_level_set,
    reinitialize_phi_fsm,
    smoothed_solid_area,
)
from pyrmt_tpu_torch.ops.poisson import (
    faces_to_cells,
    precompute_dct_matrices,
    precompute_poisson_eigenvalues,
    precompute_poisson_eigenvalues_periodic,
)
from pyrmt_tpu_torch.ops.projection import pressure_projection
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside, solid_cauchy_stress
from pyrmt_tpu_torch.physics import (
    body_forces,
    compute_timestep,
    momentum_core,
    momentum_step_rk4_multi,
)


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
    phis0: torch.Tensor | None = None  # (S, Ny, Nx) base level sets of
                                       # map rebasing; (0, Ny, Nx) without


@dataclasses.dataclass(frozen=True)
class RMTConfig:
    """Static configuration, with the field names and defaults of
    ``pyrmt_tpu.sim.RMTConfig`` so that one dict builds both.

    Three fields choose the path as in the JAX package:
    ``momentum_method`` 'auto' or 'pallas' runs the RK4 kernel and 'xla'
    the stage loop of ``physics.momentum_core``; on that loop
    ``use_pallas_rhs`` makes each stage's RHS the one-RHS kernel (ignored
    under the RK4 kernel, as in JAX, and on the periodic box);
    ``projection_method='pallas'`` runs the projection's stencil kernels
    under Neumann walls ('auto' and 'xla' the plain ops; the periodic box
    runs its FFT projection as plain ops). With no solid 'auto' keeps the
    RK4 kernel, where the JAX package keeps XLA's momentum (XLA folds the
    constant blends; PyTorch cannot, and the kernel is faster). The
    fields that select or tune the TPU's other kernels (``rmt_method``,
    ``extrap_method``, ``dct_method``, ``rmt_panel_width``, ``rmt_tile``,
    ``kernel_slab_halo``) are accepted and do not change the port's path.
    On every path the state's device chooses kernels (CUDA) or plain
    versions (CPU). ``make_step`` checks the option values."""

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


_KNOWN_VALUES = {
    "bc_type": ("neumann", "periodic"),
    "rmt_method": ("auto", "xla", "pallas"),
    "momentum_method": ("auto", "xla", "pallas"),
    "extrap_method": ("auto", "xla", "sparse", "pallas"),
    "dct_method": ("auto", "fft", "matmul", "matmul_rec"),
    "projection_method": ("auto", "xla", "pallas"),
    "reinit_method": ("none", "pde", "fmm"),
    "map_rebase_rebuild": ("cond", "analytic", "sampled"),
    # the TPU's reduced-precision DCT passes (docs/DESIGN.md #6) are not
    # carried over: the port's DCT runs in full precision
    "dct_precision": ("auto", "highest"),
    # checked at any gamma, as the JAX package checks them
    "st_method": ("csf", "balanced"),
    "st_curvature": ("fd", "hf"),
    "sl_interp": SL_INTERPS,
}


def required_extrapolation_layers(w_t, dx):
    """The layers the extrapolation band needs to cover the (1 - H) > 0
    blend region: ceil(w_t/dx) + 1."""
    return int(math.ceil(w_t / dx)) + 1


def check_narrow_band(w_t, dx, num_layers):
    """Raise if the extrapolation band cannot cover the (1 - H) > 0 blend
    region (``required_extrapolation_layers``); returns the layers it
    needs."""
    need = required_extrapolation_layers(w_t, dx)
    if num_layers < need:
        raise ValueError(
            "Narrow-band inconsistency: w_t=%.4g (=%0.2f dx) needs >= %d "
            "extrapolation layers but only %d requested."
            % (w_t, w_t / dx, need, num_layers))
    return need


def check_options(cfg: RMTConfig) -> None:
    """Raise ValueError for an unknown option value (an unknown ``scheme``
    is ``make_step``'s, with the JAX package's message)."""
    for name, values in _KNOWN_VALUES.items():
        if getattr(cfg, name) not in values:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: expected one "
                             f"of {values}")


def check_projection(cfg: RMTConfig) -> None:
    """Raise ValueError for the balanced-force CSF off Neumann walls (the
    JAX step's check, after its warnings), and for ``variable_rho`` off
    them: the CG solve is the Neumann projection's (the JAX step fails on
    that configuration too, reading CG statistics the periodic projection
    does not return)."""
    if (cfg.st_method == "balanced" and cfg.gamma > 1e-12
            and cfg.bc_type != "neumann"):
        raise ValueError(
            "st_method='balanced' requires the incremental Neumann "
            "(Rhie-Chow) projection (bc_type='neumann')")
    if cfg.variable_rho and cfg.bc_type != "neumann":
        raise ValueError(
            "variable_rho=True requires the Neumann projection "
            "(bc_type='neumann'): its CG solve has no periodic counterpart")


def periodic_seam_clearance_cells(cfg: RMTConfig) -> int:
    """Cells of clearance a solid needs from every domain edge under
    ``bc_type='periodic'``: the extrapolation band (num_layers), the wider
    of the Heaviside blend band and the bicubic band guard, and 2 cells of
    gather and stencil reach. The solid block clamps its gathers and
    stencils at the domain's edge rather than wrapping them (in both
    packages), so a solid crossing the seam is rejected, not run."""
    guard = cfg.sl_band_guard if cfg.sl_interp == "bicubic" else 0.0
    band = max(math.ceil(cfg.w_t_cells), math.ceil(guard))
    return cfg.num_layers + band + 2


def _seam_ring(shape, k, device):
    """Bool (Ny, Nx): the cells within k of a domain edge."""
    ring = torch.zeros(shape, dtype=torch.bool, device=device)
    ring[..., :k, :] = True
    ring[..., -k:, :] = True
    ring[..., :, :k] = True
    ring[..., :, -k:] = True
    return ring


def solid_near_periodic_seam(phis, clear_cells: int):
    """0-d bool tensor: a solid cell (phi <= 0) of any level set in
    ``phis`` within ``clear_cells`` of a domain edge, the periodic seam. A
    periodic run polls it on aux["phis"] beside ``diverged``: True means a
    solid drifted into the clamped region and the run is no longer
    trustworthy."""
    ring = _seam_ring(phis.shape[-2:], int(clear_cells), phis.device)
    return torch.any((phis <= 0.0) & ring)


def check_periodic_seam_clearance(cfg: RMTConfig, phi_inits, dtype,
                                  device="cuda"):
    """Raise ValueError unless every initial solid clears the periodic seam
    by ``periodic_seam_clearance_cells`` (``make_init_state`` calls it
    under ``bc_type='periodic'``)."""
    k = periodic_seam_clearance_cells(cfg)
    X, Y = cfg.grid.coords(dtype=dtype, device=device)
    ring = _seam_ring(cfg.grid.shape, k, device)
    for i, pi in enumerate(phi_inits):
        if bool(torch.any((pi(X, Y) <= 0.0) & ring)):
            raise ValueError(
                f"bc_type='periodic': solid {i} starts within {k} cells of "
                "the periodic seam. A solid crossing the seam is not "
                "supported (the solid block's gathers and stencils clamp at "
                f"the domain's edge); keep solids >= {k} cells clear, or use "
                "a larger domain. Poll sim.solid_near_periodic_seam during "
                "the run to detect drift into the seam.")


def stress_mode(cfg: RMTConfig, S: int) -> tuple[float, float]:
    """(w_cut, detg_clamp) of the solid stress, as the JAX step chooses
    them (``pyrmt_tpu/sim.py:615-622``): two solids or more take the
    interior stress with the collision clamp ``two_solid_clamp``; otherwise
    ``stress_band`` takes the band mode (w_cut = w_t) with the clamp
    ``detg_clamp``, and without it the interior stress is unclamped."""
    if S >= 2:
        return 0.0, cfg.two_solid_clamp
    return (cfg.w_t, cfg.detg_clamp) if cfg.stress_band else (0.0, 0.0)


def sl_band_guard(cfg: RMTConfig):
    """The bicubic final sample's band guard in physical units, as the JAX
    step computes it (``pyrmt_tpu/sim.py:866-868``): ``sl_band_guard``
    cells of the coarser spacing; None for raw bicubic (guard 0) and for
    the bilinear sample."""
    g = cfg.grid
    if cfg.sl_interp == "bicubic" and cfg.sl_band_guard > 0.0:
        return cfg.sl_band_guard * max(g.dx, g.dy)
    return None


def warn_as_jax(cfg: RMTConfig, need: int) -> None:
    """The JAX step's three warnings for a solid, in its order
    (``pyrmt_tpu/sim.py:541-599``): the band-mode stress with fewer than
    need + 1 extrapolation layers, the bicubic band guard off the
    gather-free sub-cell backtrace, and the raw height-function curvature
    (``st_hf_smooth=0``) on the coupled moving interface. ``need`` is
    ``check_narrow_band``'s count."""
    if cfg.stress_band and cfg.num_layers < need + 1:
        warnings.warn(
            f"stress_band=True with num_layers={cfg.num_layers}: the "
            f"banded stress reads the outermost extrapolation ring; "
            f"use num_layers >= {need + 1} (= ceil(w_t/dx)+2) for "
            f"stability on demanding flows (see benchmarks/README.md).",
            stacklevel=3)
    if (cfg.sl_interp == "bicubic" and cfg.sl_band_guard > 0.0
            and (not cfg.sl_local or cfg.CFL >= 1.0)):
        warnings.warn(
            "sl_interp='bicubic' with sl_local=False or CFL >= 1: the "
            "band guard assumes sub-cell departure displacements and "
            "can under-cover here — raise sl_band_guard or use "
            "bilinear.",
            stacklevel=3)
    if (cfg.st_curvature == "hf" and cfg.gamma > 1e-12
            and cfg.st_hf_smooth == 0):
        warnings.warn(
            "st_curvature='hf' (raw, st_hf_smooth=0) on a COUPLED moving "
            "interface: the raw height-function estimator is measured to "
            "destabilise the coupled capillary case at t~0.44 "
            "(benchmarks/README.md); set st_hf_smooth=2 (the stabilised "
            "estimator) or use st_curvature='fd' with "
            "st_kappa_interface=True (kappa*) for coupled flows.",
            stacklevel=3)


def _rmt_advect_fusible(cfg: RMTConfig, S: int) -> bool:
    """The base conditions of both fused tiers: semi-Lagrangian gather-free
    advection with a sub-cell (CFL < 1) backtrace."""
    return (S >= 1 and cfg.scheme == "semilagrangian" and cfg.sl_local
            and cfg.sl_interp in SL_INTERPS and cfg.CFL < 1.0)


def rmt_block_fusible(cfg: RMTConfig, S: int) -> bool:
    """The full RMT-block kernel can run the solid block: the base
    advection conditions and no level-set post-processing (reinit, area
    fix), which would rewrite phi after the kernel's internal rebuild, and
    no map rebasing, whose rebuild samples ``SimState.phis0``."""
    return (_rmt_advect_fusible(cfg, S) and cfg.reinit_method == "none"
            and not cfg.phi_area_fix and cfg.map_rebase_minj == 0.0)


def rmt_block_split_eligible(cfg: RMTConfig, S: int) -> bool:
    """Configurations that post-process phi but meet the base advection
    conditions run the split tier: ``advext_block_fused`` with the phi
    chain, the stress and the blends as plain ops around it."""
    return _rmt_advect_fusible(cfg, S) and not rmt_block_fusible(cfg, S)


def _rebasing(cfg: RMTConfig, S: int) -> bool:
    return cfg.map_rebase_minj > 0.0 and S > 0


def _area_targets(cfg, phi_inits, X, Y, dtype):
    """Per-solid smoothed areas at t=0, as Python floats: the rebuild at
    the identity map is phi_init(X, Y). Read once, when a step is built."""
    g = cfg.grid
    return tuple(float(smoothed_solid_area(pi(X, Y).to(dtype), g.dx, g.dy,
                                           cfg.w_t)) for pi in phi_inits)


def _rebase_map(phi, X, Y, dx, dy, num_layers, extrap_fn):
    """One solid's rebase: redistance its current level set by fast
    sweeping into the new base phi0, and extrapolate the identity map from
    it. Returns (X1, X2, phi0)."""
    phi0 = reinitialize_phi_fsm(phi, dx, dy)
    mask = (phi0 <= 0.0).to(phi.dtype)
    X1, X2 = extrap_fn(X * mask, Y * mask, phi0, dx, dy, num_layers)
    return X1, X2, phi0


# How far (in ulps of the type, times |seed| + max |seed|) phis0 may lie
# from a solid's seed phi_init(X, Y) and still read as it in 'cond' mode.
SEED_ULPS = 4


def _make_rebuild(cfg, phi_inits, X, Y, dtype):
    """``rebuild_phis(X1s, X2s, phis0)``: phi_i = phi0_i(xi_i). Without
    rebasing, and in map_rebase_rebuild 'analytic' mode, phi0_i is the
    analytic phi_inits[i]; in 'sampled' mode the bilinear sample of
    phis0[i]; in 'cond' mode the analytic rebuild until a rebase has
    rewritten phis0[i] and the sample after, both computed and selected on
    the device, so the choice needs no host read.

    A rebase writes a redistanced level set, far from the seed in many
    cells; a state made by the JAX package holds its own seeds, which may
    round a few cells an ulp away from the port's. So phis0[i] reads as
    the seed where it lies within ``SEED_ULPS`` ulps of it (of |seed| +
    max |seed|, the scale of the square root's rounding) in every cell.

    X, Y and phis0 are the whole grid's (a rank's step of a domain
    decomposition gathers phis0), the maps may be a block of it."""
    g = cfg.grid
    mode = cfg.map_rebase_rebuild if _rebasing(cfg, len(phi_inits)) \
        else "analytic"
    seeds = ([pi(X, Y).to(dtype) for pi in phi_inits] if mode == "cond"
             else None)
    eps = torch.finfo(dtype).eps
    tols = ([SEED_ULPS * eps * (sd.abs() + sd.abs().amax()) for sd in seeds]
            if mode == "cond" else None)

    def rebuild_phis(X1s, X2s, phis0):
        outs = []
        for i, phi_init in enumerate(phi_inits):
            if mode == "analytic":
                outs.append(phi_init(X1s[i], X2s[i]).to(dtype))
                continue
            phi = bilinear_interpolate(phis0[i], X1s[i], X2s[i], g.dx, g.dy)
            if mode == "cond":
                rebased = ~(torch.abs(phis0[i] - seeds[i]) <= tols[i])
                phi = torch.where(rebased.any(), phi,
                                  phi_init(X1s[i], X2s[i]).to(dtype))
            outs.append(phi)
        return torch.stack(outs)

    return rebuild_phis


def _make_maybe_rebase(cfg, S, X, Y, extrap_fn, mesh=None):
    """``maybe_rebase(X1s, X2s, phis, J_s, phis0, active)`` ->
    (X1s, X2s, phis0, rebased): where a solid's least J over phi <= 0
    drops below ``cfg.map_rebase_minj`` on an active step, reset its map
    to the identity against its redistanced level set (``_rebase_map``).
    J = 1 at the identity, so a rebase cannot re-trigger at once. X, Y
    are the whole grid's coordinates.

    With a ``mesh`` (``parallel.sharding``) the fields are this rank's
    block: the least J is a min over the ranks, so every rank reads the
    same trigger, and a rebase redistances and extrapolates the whole
    level set gathered on every rank (the fast sweep and its cap are the
    whole grid's), of which each keeps its block.

    The JAX package selects the rebase with ``lax.cond`` on the device;
    here the step reads the S trigger flags on the host, once per step,
    and runs the redistance and extrapolation only when one fires. Mode
    'analytic' (the runner's pre-rebase step) never triggers: there the
    runner owns the trigger, and the step reads nothing on the host.
    """
    g = cfg.grid

    def maybe_rebase(X1s, X2s, phis, J_s, phis0, active):
        if cfg.map_rebase_rebuild == "analytic":
            return X1s, X2s, phis0, torch.zeros((S,), dtype=torch.bool,
                                                device=X1s.device)
        minJ = torch.amin(torch.where(phis <= 0.0, J_s, float("inf")),
                          dim=(1, 2))
        if mesh is not None:
            minJ = mesh.min(minJ)
        trig = (minJ < cfg.map_rebase_minj) & active
        fire = trig.tolist()  # the step's one host read
        if not any(fire):
            return X1s, X2s, phis0, trig
        block = (slice(None), slice(None))
        if mesh is not None:
            phis = mesh.gather(phis)
            block = mesh.block(*phis.shape[-2:])
        outs = [tuple(f[block] for f in _rebase_map(
                    phis[i], X, Y, g.dx, g.dy, cfg.num_layers, extrap_fn))
                if fire[i] else (X1s[i], X2s[i], phis0[i]) for i in range(S)]
        return (*(torch.stack(c) for c in zip(*outs)), trig)

    return maybe_rebase


# The physics scalars a step may take at run time (the JAX package's
# ``_TRACEABLE_PARAMS``); mu_f, eta_s and k_rep select the kernels'
# structure and stay configuration.
_TRACEABLE_PARAMS = ("mu_s", "kappa", "gamma", "rho_s", "rho_f")


def make_step(
    cfg: RMTConfig,
    velocity_bc: Callable,
    phi_inits: Sequence[Callable] = (),
    dtype=torch.float32,
    rmt_block_impl: Callable | None = None,
    momentum_rk4_impl: Callable | None = None,
    traced_params: tuple[str, ...] | None = None,
    *,
    device="cuda",
    advext_impl: Callable | None = None,
    extrap_impl: Callable | None = None,
    momentum_rhs_impl: Callable | None = None,
    projection_stencils_impl: tuple[Callable, Callable] | None = None,
    mesh=None,
):
    """Build the FSI step for a fixed configuration.

    ``phi_inits`` holds one level-set function of the reference map per
    solid, none for the pure-fluid solver; ``velocity_bc`` is one of
    ``bcs`` (``periodic_bc`` with ``bc_type='periodic'``) or any BC
    function. The fused tier's CUDA kernel evaluates 1 to 16
    ``ops.levelset.Disc`` or ``Ellipse`` level sets
    (``kernels.rmt_block.rmt_block_supported``); any other torch callable,
    or more solids, runs the split tier, as reinit, the area fix and
    rebasing do. The RK4 and projection-stencil kernels apply the BC from
    its ``kernel_spec``; a BC without one runs their plain versions.
    Returns ``step(state, t_end) -> (state, aux)``; with rebasing,
    aux["rebased"] holds the per-solid flags, with ``variable_rho``
    aux["cg_iters"] and aux["cg_relres"] the CG's. On a no-op step (past
    t_end) the state stays as it was; aux holds the discarded trial step on
    the fused and split tiers (as the JAX fused path) and the unchanged
    maps' fields on the general tier (as the JAX unfused step).
    ``step.paths`` names the path of each block: 'solid' ('fused',
    'split', 'general' or 'none'),
    'momentum' ('rk4 kernel', 'stage loop' or 'stage loop, rhs kernel'),
    'projection' ('stencils', 'stencil kernels', 'faces', 'cg' or 'fft').

    ``rmt_block_impl``, ``momentum_rk4_impl``, ``advext_impl``,
    ``extrap_impl`` (the general tier's extrapolation and the rebase's),
    ``momentum_rhs_impl`` and ``projection_stencils_impl``
    substitute the kernel blocks with functions of the same signatures, for
    example the plain versions ``kernels.rmt_block.rmt_block_plain``,
    ``physics.momentum_core``, ``kernels.rmt_block.advext_block_plain``,
    ``ops.extrapolate.extrapolate_reference_map``,
    ``physics.velocity_rhs_blended`` and the pair
    ``(kernels.projection_stencils.rc_rhs_plain, grad_correct_plain)`` to
    run the plain path on a CUDA state.

    ``traced_params`` names physics scalars (of ``_TRACEABLE_PARAMS``:
    mu_s, kappa, gamma, rho_s, rho_f) that the step takes at run time in
    place of cfg's floats, as the JAX package's ``make_step`` does: the
    step is then ``step(state, t_end, params) -> (state, aux)`` with
    ``params`` a dict of 0-d tensors, one for each name (a key outside
    the names raises), differentiable with respect to each of them (and
    to ``t_end`` where it is a tensor). They reach the timestep, the
    solid block's ``params`` operand (the fused tier's kernel reads it on
    the device), the split and general tiers' stress and blends, the
    surface tension and gravity's reference density (``g_rho_ref`` None:
    rho_f). The structural choices (surface tension on or off, the tier,
    the branches of the dt caps) follow cfg's values, so a traced value
    must not cross its cfg twin's threshold (keep a traced gamma > 0 iff
    cfg.gamma > 0). With ``traced_params=None`` the step computes what it
    computes without the option, bit for bit. Every kernel differentiates
    through its plain version (``kernels._autograd``); the
    variable-density CG through its implicit adjoint.

    Building a step turns TF32 off for matmuls and cuDNN: the DCT solve's
    matrix products must run in full float32.

    ``mesh`` (a ``parallel.sharding.Mesh``; ``parallel.make_sharded_step``
    builds it so, with the sharded solid-block and RK4 hooks) makes the
    step one rank's of a domain decomposition: the state is the rank's
    block of the grid, the adaptive dt's max, the projection's means, the
    CG's dot products, the area fix's sums and a rebase's least J are
    over all ranks, the DCT and FFT solves are distributed, the contact
    force and surface tension (the balanced CSF's faces in the block
    layout of ``ops.poisson.faces_to_cells``), the projection's and the
    split and general tiers' stencils and the PDE reinitialisation run on
    halo slabs (the periodic box's on wrap-padded ones), the general
    tier's WENO5 and central2 on slabs of their three stages' reach
    (``ops.advect.RK3_REACH``, the edge-clamped shifts' zero halo beyond
    the domain on the periodic box too, as the solid machinery never
    wraps) and its extrapolation on slabs with the sharding offsets
    (``parallel.sharding.make_extrapolate_sharded`` around
    ``extrap_impl``), and the gather path, the fast sweeps ('fmm', a
    rebase) and the rebuild's sample of phis0 take the whole field
    gathered on every rank. Without one the step is the single-device
    step and communicates nothing.
    """
    check_options(cfg)
    if traced_params is not None:
        bad = set(traced_params) - set(_TRACEABLE_PARAMS)
        if bad:
            raise ValueError(
                f"traced_params {sorted(bad)} not traceable; allowed: "
                f"{_TRACEABLE_PARAMS}")
    g = cfg.grid
    dx, dy = g.dx, g.dy
    phi_inits = tuple(phi_inits)
    S = len(phi_inits)
    if S > 0:
        warn_as_jax(cfg, check_narrow_band(cfg.w_t, dx, cfg.num_layers))
    check_projection(cfg)
    if S > 0:
        check_scheme(cfg.scheme)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    periodic = cfg.bc_type == "periodic"
    if periodic:
        eig = precompute_poisson_eigenvalues_periodic(g.Nx, g.Ny, dx, dy,
                                                      dtype, device)
        dct_mats = None
    else:
        eig = precompute_poisson_eigenvalues(g.Nx, g.Ny, dx, dy, dtype,
                                             device)
        dct_mats = precompute_dct_matrices(g.Nx, g.Ny, dtype, device)
    # the grid of this step's fields: a rank's block with a mesh, whose
    # DCT solve takes its block of the eigenvalues and its rows of C_x and
    # C_y (the FFT solve the whole reduced grid's eigenvalues)
    shape = g.shape
    if mesh is not None:
        rows, cols = mesh.block(g.Ny, g.Nx)
        if not periodic:
            eig = eig[rows, cols].contiguous()
            dct_mats = (dct_mats[0][cols].contiguous(),
                        dct_mats[1][rows].contiguous())
        shape = (rows.stop - rows.start, cols.stop - cols.start)
    params0 = torch.tensor([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f],
                           dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    fixed_dt = (None if cfg.fixed_dt is None else
                torch.full((), cfg.fixed_dt, dtype=dtype, device=device))
    rmt_fn = rmt_block_impl or rmt_block_fused
    advext_fn = advext_impl or advext_block_fused
    # the force of a step without one: none, or zero fields for the
    # one-RHS kernel, which takes them as the JAX step passes them
    f_none = None
    # the RK4 kernel where it applies the BC (or a substitute is given), as
    # the JAX step checks momentum_rk4_supported; else the stage loop
    if cfg.momentum_method != "xla" and (
            momentum_rk4_impl is not None
            or momentum_rk4_supported(velocity_bc)):
        momentum_fn = momentum_rk4_impl or momentum_rk4_fused
        momentum_path = "rk4 kernel"
    elif cfg.use_pallas_rhs:
        f_none = torch.zeros(shape, dtype=dtype, device=device)
        momentum_fn = functools.partial(
            momentum_core,
            rhs_fn=momentum_rhs_impl or velocity_rhs_blended_fused)
        momentum_path = "stage loop, rhs kernel"
    else:
        momentum_fn = momentum_core
        momentum_path = "stage loop"
    st_faces_on = cfg.st_method == "balanced" and cfg.gamma > 1e-12 and S > 0
    stencil_kernels = cfg.projection_method == "pallas" and (
        projection_stencils_impl is not None
        or projection_stencils_supported(velocity_bc))
    stencils = ((projection_stencils_impl or (rc_rhs_fused, grad_correct_fused))
                if stencil_kernels else (rc_rhs_plain, grad_correct_plain))
    if periodic:
        projection_path = "fft"
    elif cfg.variable_rho:
        projection_path = "cg"
    elif st_faces_on:
        projection_path = "faces"
    else:
        projection_path = "stencil kernels" if stencil_kernels else "stencils"

    # the whole grid's coordinates, and the block's with a mesh: the seeds,
    # the area targets and a rebase are the whole grid's
    Xw, Yw = g.coords(dtype=dtype, device=device)
    X, Y = Xw, Yw
    if mesh is not None:
        X, Y = X[rows, cols].contiguous(), Y[rows, cols].contiguous()
    rebuild_phis = _make_rebuild(cfg, phi_inits, Xw, Yw, dtype)
    # the rebuild samples phis0 at the maps' points, anywhere in the
    # domain: a rank's step gathers the whole phis0 for it
    gather_phis0 = (mesh is not None and _rebasing(cfg, S)
                    and cfg.map_rebase_rebuild != "analytic")
    fix_areas = None
    if cfg.phi_area_fix:
        targets = _area_targets(cfg, phi_inits, Xw, Yw, dtype)

        def fix_areas(phis):
            return torch.stack([
                area_conserving_shift(phis[i], dx, dy, cfg.w_t, targets[i],
                                      mesh=mesh)
                for i in range(S)])

    extrap_fn = extrap_impl or extrapolate_reference_map_fused
    maybe_rebase = (_make_maybe_rebase(cfg, S, Xw, Yw, extrap_fn, mesh)
                    if _rebasing(cfg, S) else None)
    # the general tier for what the fused tiers' gather-free backtrace
    # does not take: WENO5, central2, sl_local=False, CFL >= 1
    general = S > 0 and not _rmt_advect_fusible(cfg, S)
    # the general tier's extrapolation: a rank's on its block padded by
    # the sweeps' reach, with the sharding offsets (a rebase extrapolates
    # the whole gathered field)
    block_extrap = extrap_fn
    if mesh is not None and general:
        from pyrmt_tpu_torch.parallel.sharding import make_extrapolate_sharded

        block_extrap = make_extrapolate_sharded(mesh, g.Ny, g.Nx,
                                                cfg.num_layers, extrap_fn)
    w_cut, clamp = stress_mode(cfg, S)
    sample = dict(sl_interp=cfg.sl_interp, sl_guard=sl_band_guard(cfg))
    forces = functools.partial(
        body_forces, dx=dx, dy=dy, k_rep=cfg.k_rep,
        w_c=cfg.w_c, w_t=cfg.w_t, g_x=cfg.g_x, g_y=cfg.g_y,
        st_method=cfg.st_method, st_curvature=cfg.st_curvature,
        st_kappa_interface=cfg.st_kappa_interface,
        st_hf_smooth=cfg.st_hf_smooth, with_faces=True,
        st_enabled=cfg.gamma > 1e-12)
    # the surface tension's and the contact force's stencils on halo slabs
    # (gravity is pointwise)
    mesh_forces = mesh is not None and ((cfg.gamma > 1e-12 and S > 0)
                                        or (cfg.k_rep > 0.0 and S >= 2))
    if mesh_forces:
        from pyrmt_tpu_torch.parallel.sharding import force_halo

        forces = _on_mesh_slabs(mesh, forces, force_halo(cfg))

    def g_rho_ref(pp):
        """Gravity's reference density: rho_f, traced or not, unless cfg
        sets its own."""
        return pp["rho_f"] if cfg.g_rho_ref is None else cfg.g_rho_ref

    def phi_chain(X1s, X2s, phis0):
        """The pre-advection level sets: rebuild, reinit, area fix."""
        phis = rebuild_phis(X1s, X2s, phis0)
        if cfg.reinit_method != "none":
            phis = torch.stack([
                reinitialize_level_set(phis[i], dx, dy,
                                       method=cfg.reinit_method,
                                       num_iters=cfg.reinit_iters, mesh=mesh)
                for i in range(S)])
        if fix_areas is not None:
            phis = fix_areas(phis)
        return phis

    def stresses(X1e, X2e, phis, pp):
        """Each solid's stress and J, stacked."""
        stress = [solid_cauchy_stress(X1e[i], X2e[i], dx, dy, pp["mu_s"],
                                      pp["kappa"], phis[i], w_cut=w_cut,
                                      detg_clamp=clamp) for i in range(S)]
        return tuple(torch.stack(c) for c in zip(*stress))

    def split_block(u, v, X1s, X2s, phis0, dt, pp):
        """The split tier's solid block; the results of rmt_block_plain.
        With a mesh the stress's stencils run on halo slabs."""
        if gather_phis0:
            phis0 = mesh.gather(phis0)
        phis = phi_chain(X1s, X2s, phis0)
        X1e, X2e = advext_fn(u, v, X1s, X2s, phis, dt, dx=dx, dy=dy,
                             num_layers=cfg.num_layers, **sample)
        phis = rebuild_phis(X1e, X2e, phis0)
        if fix_areas is not None:
            phis = fix_areas(phis)
        if mesh is None:
            sxx, sxy, syy, J = stresses(X1e, X2e, phis, pp)
        else:
            sxx, sxy, syy, J = mesh.stencil(
                lambda a, b, c: stresses(a, b, c, pp))(X1e, X2e, phis)
        H = smoothed_heaviside(phis, cfg.w_t)
        one_mH = 1.0 - H
        Hf = torch.sum(H, dim=0) - (S - 1.0)
        rho_local = Hf * pp["rho_f"] + torch.sum(one_mH, dim=0) * pp["rho_s"]
        return (X1e, X2e, phis, sxx, sxy, syy, J, Hf, rho_local,
                torch.sum(one_mH * sxx, dim=0),
                torch.sum(one_mH * sxy, dim=0),
                torch.sum(one_mH * syy, dim=0))

    guard = sl_band_guard(cfg)

    def general_block(u, v, X1s, X2s, phis0, dt, active):
        """The general tier's solid block, op for op the JAX package's
        unfused step: the phi chain; the 2S map components advected by
        ``cfg.scheme`` (semi-Lagrangian: one backtrace and the gather, the
        bicubic band guard from the pre-advection phis; WENO5 and central2:
        all 2S at once, each with its solid's phi); the mask; each solid's
        extrapolation; the maps frozen on a no-op step; the rebuild and
        area fix. Returns (X1s, X2s, phis). With a mesh, a rank's block:
        the gather path backtraces and samples the block's nodes from the
        whole fields (the departure points may lie anywhere); WENO5 and
        central2 run on slabs of their three stages' reach (one
        exchange); the extrapolation is ``block_extrap``."""
        if gather_phis0:
            phis0 = mesh.gather(phis0)
        phis = phi_chain(X1s, X2s, phis0)
        qs, phi2 = torch.cat([X1s, X2s]), torch.cat([phis, phis])
        cubic_mask = None
        if cfg.scheme == "semilagrangian" and guard is not None:
            m = phis < -guard
            cubic_mask = torch.cat([m, m])

        def advect(qs, a, b, phi, at=None):
            return advect_reference_map_multi(
                qs, a, b, X, Y, dt, dx, dy, phi, cfg.scheme, cfg.w_cut,
                sl_interp=cfg.sl_interp, sl_cubic_mask=cubic_mask, sl_at=at)

        if mesh is None:
            qs = advect(qs, u, v, phi2)
        elif cfg.scheme == "semilagrangian":
            qs = advect(*(mesh.gather(f) for f in (qs, u, v)), None,
                        at=(rows, cols))
        else:
            qs = mesh.stencil(advect, RK3_REACH[cfg.scheme])(qs, u, v, phi2)
        masks = (phis <= 0.0).to(dtype)
        X1a, X2a = qs[:S] * masks, qs[S:] * masks
        ext = [block_extrap(X1a[i], X2a[i], phis[i], dx, dy,
                            cfg.num_layers) for i in range(S)]
        # freeze before the rebuild, so that on a no-op step phi, the
        # stress, J and the density come from the unchanged maps
        X1s = torch.where(active, torch.stack([e[0] for e in ext]), X1s)
        X2s = torch.where(active, torch.stack([e[1] for e in ext]), X2s)
        phis = rebuild_phis(X1s, X2s, phis0)
        if fix_areas is not None:
            phis = fix_areas(phis)
        return X1s, X2s, phis

    st_forces = functools.partial(forces, g_x=0.0, g_y=0.0)

    def general_tier(u, v, p, state, dt, active, pp):
        """The general tier's solid block, then its stress, blends, forces
        and RK4 update (``physics.momentum_step_rk4_multi``), the balanced
        CSF's forces built first, as the JAX step builds them, for the
        projection, and on a mesh any force that reads neighbours (on
        ``force_halo`` slabs). Returns (X1s, X2s, phis, sxx, sxy, syy, J, rho_local,
        u*, v*, st_faces)."""
        X1s, X2s, phis = general_block(u, v, state.X1, state.X2,
                                       state.phis0, dt, active)
        ext_override = st_faces = None
        if st_faces_on or mesh_forces:
            fx, fy, st_faces = st_forces(phis, None, gamma=pp["gamma"],
                                         g_rho_ref=g_rho_ref(pp))
            ext_override = (fx, fy)
        u_star, v_star, sxx, sxy, syy, J = momentum_step_rk4_multi(
            u, v, p, X1s, X2s, phis, velocity_bc, mu_s=pp["mu_s"],
            kappa=pp["kappa"], eta_s=cfg.eta_s, dx=dx, dy=dy, dt=dt,
            rho_s=pp["rho_s"], rho_f=pp["rho_f"], mu_f=cfg.mu_f, w_t=cfg.w_t,
            gamma=pp["gamma"], stress_w_cut=w_cut, stress_clamp=clamp,
            st_enabled=cfg.gamma > 1e-12, k_rep=cfg.k_rep, w_c=cfg.w_c,
            g_x=cfg.g_x, g_y=cfg.g_y, g_rho_ref=g_rho_ref(pp),
            ext_override=ext_override, st_curvature=cfg.st_curvature,
            st_kappa_interface=cfg.st_kappa_interface,
            st_hf_smooth=cfg.st_hf_smooth, momentum_fn=momentum_fn,
            periodic=periodic, mesh=mesh)
        H = smoothed_heaviside(phis, cfg.w_t)
        Hf = torch.sum(H, dim=0) - (S - 1.0)
        rho_local = (Hf * pp["rho_f"]
                     + torch.sum(1.0 - H, dim=0) * pp["rho_s"])
        return (X1s, X2s, phis, sxx, sxy, syy, J, rho_local, u_star, v_star,
                st_faces)

    # the split tier for phi post-processing, and for level sets the fused
    # kernel does not evaluate (any callable, more than 16 solids)
    split = rmt_block_split_eligible(cfg, S) or (
        rmt_block_fusible(cfg, S) and rmt_block_impl is None
        and not rmt_block_supported(phi_inits))
    # the pure-fluid step's block: no solid, the constant blends
    empty = torch.zeros((0,) + shape, dtype=dtype, device=device)
    fluid_block = (empty, torch.ones(shape, dtype=dtype, device=device),
                   torch.full(shape, cfg.rho_f, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def block_tier(u, v, p, state, dt, active, pp, params):
        """The fused, split or pure-fluid solid block, then the body forces
        and the RK4 update; on a no-op step the maps are frozen after, so
        that the aux fields reflect the discarded trial step, as on the JAX
        fused path. Returns what ``general_tier`` returns."""
        if S == 0:
            e, Hf, rho_f, z = fluid_block
            if isinstance(pp["rho_f"], torch.Tensor):
                rho_f = Hf * pp["rho_f"]
            block = (state.X1, state.X2, e, e, e, e, e, Hf, rho_f, z, z, z)
        elif split:
            block = split_block(u, v, state.X1, state.X2, state.phis0, dt,
                                pp)
        else:
            block = rmt_fn(u, v, state.X1, state.X2, dt, phi_inits=phi_inits,
                           dx=dx, dy=dy, num_layers=cfg.num_layers,
                           w_t=cfg.w_t, params=params, stress_w_cut=w_cut,
                           stress_clamp=clamp, **sample)
        (X1e, X2e, phis, sxx, sxy, syy, J, Hf, rho_local,
         sb_xx, sb_xy, sb_yy) = block

        if cfg.eta_s > 0.0 and S == 1:
            # Kelvin-Voigt mask of one solid: (phi <= 0) (1 - Hf), Hf = H
            mkv = (phis[0] <= 0.0).to(dtype) * (1.0 - Hf)
        elif cfg.eta_s > 0.0 and S > 0:
            # of S solids: sum_i (phi_i <= 0) (1 - H_i)
            H = smoothed_heaviside(phis, cfg.w_t)
            mkv = torch.sum((phis <= 0.0).to(dtype) * (1.0 - H), dim=0)
        else:
            mkv = torch.zeros_like(u)
        f_x, f_y, st_faces = forces(phis, rho_local, gamma=pp["gamma"],
                                    g_rho_ref=g_rho_ref(pp))
        if f_x is None:
            f_x = f_y = f_none
        u_star, v_star = momentum_fn(
            u, v, p, sb_xx, sb_xy, sb_yy, Hf, rho_local, mkv, velocity_bc,
            eta_s=cfg.eta_s, dx=dx, dy=dy, dt=dt, mu_f=cfg.mu_f,
            f_ext_x=f_x, f_ext_y=f_y, periodic=periodic)
        X1s = torch.where(active, X1e, state.X1)
        X2s = torch.where(active, X2e, state.X2)
        return (X1s, X2s, phis, sxx, sxy, syy, J, rho_local, u_star, v_star,
                st_faces)

    def _step(state: SimState, t_end, pp, params):
        u, v, p = state.u, state.v, state.p
        if fixed_dt is not None:
            dt = fixed_dt
        else:
            dt = compute_timestep(
                u, v, dx, dy, cfg.CFL, cfg.dt_min_cap, pp["mu_s"],
                pp["rho_s"], pp["gamma"], pp["rho_f"], mu_f=cfg.mu_f,
                eta_s=cfg.eta_s, kappa=pp["kappa"], mesh=mesh)
        dt = torch.minimum(dt, torch.clamp(t_end - state.t, min=0.0)).to(dtype)
        # Once t reaches t_end the clipped dt is 0 and rho*div/dt would be
        # NaN: run the step with dt = 1 and freeze the state afterwards, so
        # a loop can overrun t_end with no-op steps.
        active = dt > 0.0
        dt = torch.where(active, dt, one)

        def frz(new, old):
            return torch.where(active, new, old)

        (X1s, X2s, phis, sxx, sxy, syy, J, rho_local, u_star, v_star,
         st_faces) = (general_tier(u, v, p, state, dt, active, pp) if general
                      else block_tier(u, v, p, state, dt, active, pp, params))
        proj = pressure_projection(
            u_star, v_star, dx, dy, dt, rho_local, velocity_bc, p, eig,
            dct_mats=dct_mats, stencils=stencils, bc_type=cfg.bc_type,
            variable_rho=cfg.variable_rho, cg_tol=cfg.cg_tol,
            cg_maxiter=cfg.cg_maxiter, cg_info=cfg.variable_rho,
            st_faces=st_faces, mesh=mesh)
        u_new, v_new, p_new = proj[:3]

        # on a no-op step the state stays exactly frozen
        dt_taken = torch.where(active, dt, zero)
        phis0 = state.phis0
        aux = {"dt": dt_taken, "phis": phis, "J": J, "sxx": sxx, "sxy": sxy,
               "syy": syy, "rho_local": rho_local}
        if cfg.variable_rho:
            aux["cg_iters"], aux["cg_relres"] = proj[3]
        if maybe_rebase is not None:
            # after the step's physics, which used the pre-rebase maps
            X1s, X2s, phis0, aux["rebased"] = maybe_rebase(
                X1s, X2s, phis, J, state.phis0, active)
        new_state = SimState(
            u=frz(u_new, u), v=frz(v_new, v), p=frz(p_new, p),
            X1=X1s, X2=X2s, t=state.t + dt_taken,
            step=state.step + active.to(torch.int32), phis0=phis0,
        )
        return new_state, aux

    base = {k: getattr(cfg, k) for k in _TRACEABLE_PARAMS}
    if traced_params is None:
        def step(state: SimState, t_end):
            return _step(state, t_end, base, params0)
    else:
        names = tuple(traced_params)
        order = ("mu_s", "kappa", "rho_s", "rho_f")

        def step(state: SimState, t_end, params):
            extra = set(params) - set(names)
            if extra:
                raise ValueError(
                    f"params {sorted(extra)} are not among the step's "
                    f"traced_params {names}")
            pp = dict(base)
            for k in names:
                pp[k] = torch.as_tensor(params[k], dtype=dtype, device=device)
            # the solid block's operand [mu_s, kappa, rho_s, rho_f], the
            # untraced entries cfg's (as the default build rounds them)
            ops = torch.stack([pp[k] if k in names else params0[i]
                               for i, k in enumerate(order)])
            return _step(state, t_end, pp, ops)

    solid_path = ("none" if S == 0 else "general" if general
                  else "split" if split else "fused")
    step.paths = {"solid": solid_path,
                  "momentum": momentum_path, "projection": projection_path}
    return step


def _on_mesh_slabs(mesh, forces, halo):
    """``body_forces`` (the step's partial) on a rank's block: the level
    sets and the density padded by ``halo`` cells
    (``parallel.sharding.force_halo``), the forces computed on the slab
    (``ops.slab.on_slab``: the curvatures' one-sided closures and edge
    replication at the domain's edge only), cut back to the block; the
    balanced CSF's faces in the block layout of
    ``ops.poisson.faces_to_cells``, which the sharded projection takes."""

    def on_slab(phis, rho_local, **kw):
        f_x, f_y, st_faces = forces(phis, rho_local, **kw)
        return (f_x, f_y) + (() if st_faces is None
                             else faces_to_cells(st_faces))

    def run(phis, rho_local, **kw):
        out = mesh.stencil(functools.partial(on_slab, **kw), halo)(
            phis, rho_local)
        return out[0], out[1], (tuple(out[2:]) or None)

    return run


def make_init_state(cfg: RMTConfig, phi_inits: Sequence[Callable] = (),
                    u0=None, v0=None, dtype=torch.float32, device="cuda"):
    """Initial state: reference maps seeded with the identity inside each
    solid and extrapolated ``num_layers`` cells into the fluid; with map
    rebasing, ``phis0`` holds each phi_init(X, Y) as it is, so the rebuild
    at the identity map reproduces the analytic level set exactly. With no
    solid the stacks are (0, Ny, Nx). Under ``bc_type='periodic'`` each
    solid must clear the seam (``check_periodic_seam_clearance``)."""
    g = cfg.grid
    if cfg.bc_type == "periodic" and len(phi_inits) > 0:
        check_periodic_seam_clearance(cfg, phi_inits, dtype, device)
    X, Y = g.coords(dtype=dtype, device=device)
    zeros = torch.zeros(g.shape, dtype=dtype, device=device)
    u = zeros if u0 is None else torch.as_tensor(u0, dtype=dtype, device=device)
    v = zeros if v0 is None else torch.as_tensor(v0, dtype=dtype, device=device)
    X1s, X2s, phi0s = [], [], []
    for phi_init in phi_inits:
        phi = phi_init(X, Y).to(dtype)
        mask = (phi <= 0.0).to(dtype)
        X1e, X2e = extrapolate_reference_map(X * mask, Y * mask, phi, g.dx,
                                             g.dy, cfg.num_layers)
        X1s.append(X1e)
        X2s.append(X2e)
        phi0s.append(phi)
    empty = torch.zeros((0,) + g.shape, dtype=dtype, device=device)
    return SimState(
        u=u, v=v, p=zeros.clone(),
        X1=torch.stack(X1s) if X1s else empty,
        X2=torch.stack(X2s) if X2s else empty.clone(),
        t=torch.zeros((), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        phis0=(torch.stack(phi0s) if _rebasing(cfg, len(phi_inits))
               else empty.clone()),
    )


def diverged(state: SimState, umax_cap=1.0e3):
    """0-d bool tensor: a non-finite field or |u| above the cap."""
    umax = torch.amax(torch.sqrt(state.u**2 + state.v**2))
    finite = (torch.isfinite(state.u).all() & torch.isfinite(state.v).all()
              & torch.isfinite(state.p).all()
              & torch.isfinite(state.X1).all()
              & torch.isfinite(state.X2).all())
    return (~finite) | (umax > umax_cap)


def stop_time(t_end, dtype):
    """``t_end`` as a state of ``dtype`` holds it: the time a run reaches.
    A float32 run to 0.01 stops at float32(0.01) < 0.01, so a loop that
    compared t with the Python ``t_end`` would run no-op steps forever."""
    return float(torch.as_tensor(t_end, dtype=dtype))


def run_until(step_fn, state: SimState, t_end, max_steps=10**8,
              callback=None):
    """Host-driven loop: one step per iteration with an optional host
    callback. Stops at t_end (as the state's dtype holds it: ``stop_time``)
    or divergence; returns (state, diverged)."""
    n = 0
    t_stop = stop_time(t_end, state.t.dtype)
    while float(state.t) < t_stop and n < max_steps:
        state, aux = step_fn(state, t_end)
        n += 1
        if callback is not None:
            callback(state, aux)
        if bool(diverged(state)):
            return state, True
    return state, False


def make_run_chunk(step_fn, n_steps: int, donate: bool = False):
    """``run_chunk(state, t_end) -> (state, t)``: ``n_steps`` steps with no
    host round-trip (steps past t_end are no-ops). ``donate`` is the JAX
    signature's: there it hands the input state's buffers to the output,
    and the caller must chain states; here the caller chains states
    either way (``state = run_chunk(state, t)[0]``), and no buffer is
    freed early: each step makes new tensors and the caller's state stays
    valid."""

    def run_chunk(state: SimState, t_end):
        for _ in range(n_steps):
            state, _aux = step_fn(state, t_end)
        return state, state.t

    return run_chunk


def make_rollout(step_fn, n_steps: int, remat: bool = True):
    """A differentiable ``n_steps``-step rollout (the JAX package's
    ``make_rollout``): ``rollout(state, t_end) -> state``, or
    ``rollout(state, t_end, params)`` for a step built with
    ``traced_params``. Its forward is ``make_run_chunk``'s, bit for bit.

    With ``remat`` each step runs under ``torch.utils.checkpoint`` (not
    reentrant): a backward pass keeps one state per step and recomputes
    the step's inside from it, memory O(n_steps * state) in place of
    every intermediate of every step. The recompute runs the step's
    forward again, kernels included (their launch counters count it), and
    then each kernel's backward, its plain version's autograd. Over a
    sharded step (``parallel.make_sharded_step``) the recompute reruns the
    forward's collectives inside the backward, on every rank in the same
    order."""

    def one(s, t_end, *params):
        return step_fn(s, t_end, *params)[0]

    def rollout(state: SimState, t_end, *params):
        for _ in range(n_steps):
            if remat:
                state = torch.utils.checkpoint.checkpoint(
                    one, state, t_end, *params, use_reentrant=False)
            else:
                state = one(state, t_end, *params)
        return state

    return rollout


class RebaseRunner:
    """Chunked runner of a map-rebasing configuration (the JAX package's
    production path, ``make_rebase_runner``).

    Two steps of the same physics differ only in ``map_rebase_rebuild``:
    the 'analytic' pre-rebase step (no trigger in the step, no host read)
    and the 'sampled' post-rebase step (phis0 sampled at every rebuild,
    the in-step trigger for later rebases). In the pre phase the runner
    owns the trigger: after each chunk it computes each solid's least J
    (one host read per chunk) and, where one falls below the threshold,
    rebases that solid (``rebase``) and switches to the post phase for
    good. A trigger is thus seen at the end of the chunk it occurs in, and
    the first one switches every solid to the sampled rebuild.

    The extrapolation of a rebase is ``extrapolate_reference_map_fused``:
    the CUDA kernel on a CUDA state, the plain version on a CPU state.

    ``runner(state, t_end) -> (state, t)`` runs one chunk of ``n_steps``
    steps, as ``make_run_chunk`` does.
    """

    def __init__(self, cfg, velocity_bc, phi_inits, n_steps,
                 dtype=torch.float32, device="cuda", donate=False):
        self.phi_inits = tuple(phi_inits)
        S = len(self.phi_inits)
        if not _rebasing(cfg, S):
            raise ValueError("make_rebase_runner requires map_rebase_minj > 0 "
                             "and at least one solid")
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.pre_step = make_step(
            dataclasses.replace(cfg, map_rebase_rebuild="analytic"),
            velocity_bc, self.phi_inits, **kw)
        self.post_step = make_step(
            dataclasses.replace(cfg, map_rebase_rebuild="sampled"),
            velocity_bc, self.phi_inits, **kw)
        self._pre_chunk = make_run_chunk(self.pre_step, n_steps, donate)
        self._post_chunk = make_run_chunk(self.post_step, n_steps, donate)
        self.X, self.Y = cfg.grid.coords(**kw)
        self._targets = (_area_targets(cfg, self.phi_inits, self.X, self.Y,
                                       dtype) if cfg.phi_area_fix else None)
        self.dtype = dtype
        self.post = False

    def _phi(self, state, i):
        """Solid i's level set at the end of a pre-phase chunk: the
        analytic rebuild, area-fixed where the step fixes it."""
        g = self.cfg.grid
        phi = self.phi_inits[i](state.X1[i], state.X2[i]).to(self.dtype)
        if self._targets is None:
            return phi
        return area_conserving_shift(phi, g.dx, g.dy, self.cfg.w_t,
                                     self._targets[i])

    def min_J(self, state):
        """(S,) tensor: each solid's least J over phi <= 0, from the step's
        stress (``stress_mode``)."""
        g, cfg = self.cfg.grid, self.cfg
        w_cut, clamp = stress_mode(cfg, len(self.phi_inits))
        mins = []
        for i in range(len(self.phi_inits)):
            phi = self._phi(state, i)
            J = solid_cauchy_stress(state.X1[i], state.X2[i], g.dx, g.dy,
                                    cfg.mu_s, cfg.kappa, phi, w_cut=w_cut,
                                    detg_clamp=clamp)[3]
            mins.append(torch.amin(torch.where(phi <= 0.0, J, float("inf"))))
        return torch.stack(mins)

    def rebase(self, state, fire):
        """Rebase the solids i with ``fire[i]`` true (as the in-step
        rebase does) and switch to the post phase."""
        g = self.cfg.grid
        outs = [_rebase_map(self._phi(state, i), self.X, self.Y, g.dx, g.dy,
                            self.cfg.num_layers,
                            extrapolate_reference_map_fused) if f
                else (state.X1[i], state.X2[i], state.phis0[i])
                for i, f in enumerate(fire)]
        X1, X2, phis0 = (torch.stack(c) for c in zip(*outs))
        self.post = True
        return dataclasses.replace(state, X1=X1, X2=X2, phis0=phis0)

    def __call__(self, state: SimState, t_end):
        if self.post:
            return self._post_chunk(state, t_end)
        state, t = self._pre_chunk(state, t_end)
        fire = (self.min_J(state) < self.cfg.map_rebase_minj).tolist()
        if any(fire):
            state = self.rebase(state, fire)
        return state, t


def make_rebase_runner(cfg, velocity_bc, phi_inits, n_steps: int,
                       dtype=torch.float32, donate: bool = False, *,
                       device="cuda") -> RebaseRunner:
    """The chunked rebasing runner (see ``RebaseRunner``); ``donate`` as
    in ``make_run_chunk``."""
    return RebaseRunner(cfg, velocity_bc, phi_inits, n_steps, dtype, device,
                        donate)


def extrapolate_reference_map_compat(X1, X2, phi, dx, dy, max_layers):
    """The reference signature's name of
    ``ops.extrapolate.extrapolate_reference_map``."""
    return extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers)
