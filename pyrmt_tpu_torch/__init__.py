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
projection.

This package imports ``torch`` and never ``jax``.
"""

from pyrmt_tpu_torch.bcs import (
    free_slip_box_bc,
    make_lid_bc,
    noop_bc,
    periodic_bc,
)
from pyrmt_tpu_torch.diagnostics import (
    compute_kinetic_energy,
    compute_strain_energy,
    compute_viscous_dissipation,
    disc_centroid,
    divergence_2d_interior,
    extract_centerlines,
)
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import (
    EnergyLogger,
    load_checkpoint,
    load_snapshot,
    save_checkpoint,
    save_snapshot,
    state_from_numpy,
    state_to_numpy,
)
from pyrmt_tpu_torch.kernels.momentum_rhs import velocity_rhs_blended_fused
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_fused,
    projection_stencils_supported,
    rc_rhs_fused,
)
from pyrmt_tpu_torch.ops.contact import compute_contact_force
from pyrmt_tpu_torch.ops.interp import (
    bicubic_interpolate,
    cubic_convolution,
    gather_bicubic_local,
    gather_bicubic_multi,
)
from pyrmt_tpu_torch.ops.levelset import (
    Disc,
    Ellipse,
    apply_phi_BCs,
    compute_curvature,
    compute_curvature_hf,
    sharp_solid_fraction,
)
from pyrmt_tpu_torch.ops.poisson import (
    apply_variable_poisson,
    precompute_poisson_eigenvalues_periodic,
    solve_poisson_fft,
    solve_variable_poisson_cg,
    solve_variable_poisson_cg_counted,
)
from pyrmt_tpu_torch.physics import balanced_csf_forces, external_forces
from pyrmt_tpu_torch.sim import (
    RMTConfig,
    SimState,
    diverged,
    make_init_state,
    make_rebase_runner,
    make_run_chunk,
    make_step,
    run_until,
)

__all__ = [
    "Disc",
    "Ellipse",
    "EnergyLogger",
    "Grid",
    "RMTConfig",
    "SimState",
    "apply_phi_BCs",
    "apply_variable_poisson",
    "balanced_csf_forces",
    "bicubic_interpolate",
    "compute_contact_force",
    "compute_curvature",
    "compute_curvature_hf",
    "compute_kinetic_energy",
    "compute_strain_energy",
    "compute_viscous_dissipation",
    "cubic_convolution",
    "disc_centroid",
    "diverged",
    "divergence_2d_interior",
    "external_forces",
    "extract_centerlines",
    "free_slip_box_bc",
    "gather_bicubic_local",
    "gather_bicubic_multi",
    "grad_correct_fused",
    "load_checkpoint",
    "load_snapshot",
    "make_init_state",
    "make_lid_bc",
    "make_rebase_runner",
    "make_run_chunk",
    "make_step",
    "noop_bc",
    "periodic_bc",
    "precompute_poisson_eigenvalues_periodic",
    "projection_stencils_supported",
    "rc_rhs_fused",
    "run_until",
    "save_checkpoint",
    "save_snapshot",
    "sharp_solid_fraction",
    "solve_poisson_fft",
    "solve_variable_poisson_cg",
    "solve_variable_poisson_cg_counted",
    "state_from_numpy",
    "state_to_numpy",
    "velocity_rhs_blended_fused",
]
