"""pyrmt_tpu_torch — the PyTorch and CUDA port of pyrmt_tpu.

The Reference Map Technique for fully Eulerian fluid-structure interaction
(Jain, Kamrin & Mani 2019), ported slice by slice from the JAX package
``pyrmt_tpu``, which stays the reference. Module layout and function names
mirror ``pyrmt_tpu``. Every TPU kernel on the ported path is a CUDA kernel
written for Hopper (``csrc/``), with a plain PyTorch version beside it: a
CPU tensor runs the plain version, a CUDA tensor runs the kernel or raises.
The entry points (``make_step``, ``make_init_state``,
``make_rebase_runner``, ``state_from_numpy``) run on the card unless the
caller passes ``device="cpu"``. With no level set the step is the
pure-fluid solver; ``bc_type='periodic'`` with ``periodic_bc`` runs the
doubly-periodic box; ``gamma > 0`` adds surface tension (the cell-centred
or balanced-force CSF) and ``variable_rho=True`` the variable-density CG
projection; ``scheme`` 'weno5' or 'central2', ``sl_local=False`` or
CFL >= 1 run the general tier (the advection as plain ops, each solid's
extrapolation in its CUDA kernel). The step differentiates: every kernel
is an ``autograd.Function`` whose backward is its plain version's
autograd, the variable-density CG has its implicit adjoint, and
``make_step(traced_params=...)``, ``make_rollout``, ``make_diff_step``
and ``make_diff_rollout`` are the JAX package's gradient API.
``make_mesh``, ``state_sharding``, ``shard_state`` and
``make_sharded_step`` (``parallel``) decompose the grid over the ranks of
a ``torch.distributed`` world: one block per rank, the kernels on
exchanged halos with the sharding offsets, the rest as collectives. The
sharded step differentiates too: every collective has its adjoint, the
traced scalars enter through ``Mesh.replicate``, and the global loss is
the sum of the ranks' block losses (``parallel.sharding``'s note).
Every name that ``pyrmt_tpu`` binds is bound here too, pyRMT's aliases
among them, and its functions take the JAX package's parameters in its
order and under its names; the port's own (``device``, ``mesh``, the
``*_impl`` substitutes) follow as keywords. ``momentum_rk4_pallas`` takes
the JAX kernel's parameters and calls the port's ``momentum_rk4_fused``
(the RK4 kernel's wrapper, which takes the BC function where the JAX
kernel takes its spec).

This package imports ``torch`` and never ``jax``.
"""

from pyrmt_tpu_torch.bcs import (
    free_slip_box_bc,
    make_lid_bc,
    no_slip_lid_bc,
    noop_bc,
    periodic_bc,
)
from pyrmt_tpu_torch.diff import make_diff_rollout, make_diff_step
from pyrmt_tpu_torch.diagnostics import (
    compute_kinetic_energy,
    compute_strain_energy,
    compute_viscous_dissipation,
    disc_centroid,
    divergence_2d_interior,
    extract_centerlines,
)
from pyrmt_tpu_torch.grid import Grid, create_grid
from pyrmt_tpu_torch.io import (
    EnergyLogger,
    load_checkpoint,
    load_snapshot,
    output_simulation_data,
    save_checkpoint,
    save_snapshot,
    state_from_numpy,
    state_to_numpy,
)
from pyrmt_tpu_torch.kernels.extrapolate_fused import (
    extrapolate_reference_map_fused,
)
from pyrmt_tpu_torch.kernels.momentum_rhs import velocity_rhs_blended_fused
from pyrmt_tpu_torch.kernels.momentum_rk4 import (
    momentum_rk4_fused,
    momentum_rk4_pallas,
)
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_fused,
    projection_stencils_supported,
    rc_rhs_fused,
)
from pyrmt_tpu_torch.ops.advect import (
    advect_central2_rk3,
    advect_reference_map,
    advect_reference_map_multi,
    advect_semilagrangian_rk4,
    advect_semilagrangian_rk4_multi,
    advect_weno5_rk3,
)
from pyrmt_tpu_torch.ops.contact import compute_contact_force
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.ops.fd import (
    diff_upwind_3rd,
    grad_central_x_2nd,
    grad_central_x_4th,
    grad_central_y_2nd,
    grad_central_y_4th,
    lap_2nd,
    solve3x3_sym,
)
from pyrmt_tpu_torch.ops.interp import (
    bicubic_interpolate,
    bilinear_interpolate,
    cubic_convolution,
    gather_bicubic_local,
    gather_bicubic_multi,
    gather_bilinear_multi,
)
from pyrmt_tpu_torch.ops.levelset import (
    Disc,
    Ellipse,
    apply_phi_BCs,
    compute_curvature,
    compute_curvature_hf,
    rebuild_phi_from_reference_map,
    reinitialize_level_set,
    reinitialize_phi_PDE,
    sharp_solid_fraction,
)
from pyrmt_tpu_torch.ops.levelset import (
    reinitialize_phi_fmm_equivalent as reinitialize_phi_fmm,
)
from pyrmt_tpu_torch.ops.poisson import (
    apply_variable_poisson,
    build_poisson_matrix,
    dct1_2d_matmul,
    precompute_dct_matrices,
    precompute_poisson_eigenvalues,
    precompute_poisson_eigenvalues_periodic,
    solve_poisson_dct,
    solve_poisson_fft,
    solve_variable_poisson_cg,
    solve_variable_poisson_cg_counted,
)
from pyrmt_tpu_torch.ops.projection import pressure_projection
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside, solid_cauchy_stress
from pyrmt_tpu_torch.parallel import (
    make_mesh,
    make_sharded_step,
    shard_state,
    state_sharding,
)
from pyrmt_tpu_torch.physics import (
    balanced_csf_forces,
    compute_timestep,
    external_forces,
    momentum_step_rk4,
    momentum_step_rk4_2solids,
    velocity_rhs_blended,
)
from pyrmt_tpu_torch.sim import (
    RMTConfig,
    SimState,
    check_narrow_band,
    diverged,
    make_init_state,
    make_rebase_runner,
    make_rollout,
    make_run_chunk,
    make_step,
    required_extrapolation_layers,
    run_until,
)

__version__ = "0.1.0"

# pyRMT's names (the JAX package's aliases, pyrmt_tpu/__init__.py:108-119)
pressure_projection_amg = pressure_projection
velocity_RK4 = momentum_step_rk4
compute_solid_stress = solid_cauchy_stress
extrapolate_transverse_layers_2field = extrapolate_reference_map
advect_semi_lagrangian_rk4 = advect_semilagrangian_rk4
heaviside_smooth_alt = smoothed_heaviside
velocity_rhs_blended_optimized = velocity_rhs_blended
_precompute_poisson_eigenvalues = precompute_poisson_eigenvalues
_precompute_poisson_eigenvalues_periodic = (
    precompute_poisson_eigenvalues_periodic)
_solve_poisson_dct = solve_poisson_dct
_solve_poisson_fft = solve_poisson_fft

__all__ = [
    "Disc",
    "Ellipse",
    "EnergyLogger",
    "Grid",
    "RMTConfig",
    "SimState",
    "advect_central2_rk3",
    "advect_reference_map",
    "advect_reference_map_multi",
    "advect_semi_lagrangian_rk4",
    "advect_semilagrangian_rk4",
    "advect_semilagrangian_rk4_multi",
    "advect_weno5_rk3",
    "apply_phi_BCs",
    "apply_variable_poisson",
    "balanced_csf_forces",
    "bicubic_interpolate",
    "bilinear_interpolate",
    "build_poisson_matrix",
    "check_narrow_band",
    "compute_contact_force",
    "compute_curvature",
    "compute_curvature_hf",
    "compute_kinetic_energy",
    "compute_solid_stress",
    "compute_strain_energy",
    "compute_timestep",
    "compute_viscous_dissipation",
    "create_grid",
    "cubic_convolution",
    "dct1_2d_matmul",
    "diff_upwind_3rd",
    "disc_centroid",
    "diverged",
    "divergence_2d_interior",
    "external_forces",
    "extract_centerlines",
    "extrapolate_reference_map",
    "extrapolate_reference_map_fused",
    "extrapolate_transverse_layers_2field",
    "free_slip_box_bc",
    "gather_bicubic_local",
    "gather_bicubic_multi",
    "gather_bilinear_multi",
    "grad_central_x_2nd",
    "grad_central_x_4th",
    "grad_central_y_2nd",
    "grad_central_y_4th",
    "grad_correct_fused",
    "heaviside_smooth_alt",
    "lap_2nd",
    "load_checkpoint",
    "load_snapshot",
    "make_diff_rollout",
    "make_diff_step",
    "make_init_state",
    "make_lid_bc",
    "make_mesh",
    "make_rebase_runner",
    "make_rollout",
    "make_run_chunk",
    "make_sharded_step",
    "make_step",
    "momentum_rk4_fused",
    "momentum_rk4_pallas",
    "momentum_step_rk4",
    "momentum_step_rk4_2solids",
    "no_slip_lid_bc",
    "noop_bc",
    "output_simulation_data",
    "periodic_bc",
    "precompute_dct_matrices",
    "precompute_poisson_eigenvalues",
    "precompute_poisson_eigenvalues_periodic",
    "pressure_projection",
    "pressure_projection_amg",
    "projection_stencils_supported",
    "rc_rhs_fused",
    "rebuild_phi_from_reference_map",
    "reinitialize_level_set",
    "reinitialize_phi_PDE",
    "reinitialize_phi_fmm",
    "required_extrapolation_layers",
    "run_until",
    "save_checkpoint",
    "save_snapshot",
    "shard_state",
    "sharp_solid_fraction",
    "smoothed_heaviside",
    "solid_cauchy_stress",
    "solve3x3_sym",
    "solve_poisson_dct",
    "solve_poisson_fft",
    "solve_variable_poisson_cg",
    "solve_variable_poisson_cg_counted",
    "state_from_numpy",
    "state_sharding",
    "state_to_numpy",
    "velocity_RK4",
    "velocity_rhs_blended",
    "velocity_rhs_blended_fused",
    "velocity_rhs_blended_optimized",
]
