"""pyrmt_tpu_torch — the PyTorch and CUDA port of pyrmt_tpu.

The Reference Map Technique for fully Eulerian fluid-structure interaction
(Jain, Kamrin & Mani 2019), ported slice by slice from the JAX package
``pyrmt_tpu``, which stays the reference. Module layout and function names
mirror ``pyrmt_tpu``. Every TPU kernel on the ported path is a CUDA kernel
written for Hopper (``csrc/``), with a plain PyTorch version beside it: a
CPU tensor runs the plain version, a CUDA tensor runs the kernel or raises.
The entry points (``make_step``, ``make_init_state``,
``make_rebase_runner``, ``state_from_numpy``) run on the card unless the
caller passes ``device="cpu"``.

This package imports ``torch`` and never ``jax``.
"""

from pyrmt_tpu_torch.bcs import free_slip_box_bc, make_lid_bc, noop_bc
from pyrmt_tpu_torch.grid import Grid
from pyrmt_tpu_torch.io import state_from_numpy, state_to_numpy
from pyrmt_tpu_torch.kernels.momentum_rhs import velocity_rhs_blended_fused
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_fused,
    projection_stencils_supported,
    rc_rhs_fused,
)
from pyrmt_tpu_torch.ops.contact import compute_contact_force
from pyrmt_tpu_torch.ops.levelset import Disc
from pyrmt_tpu_torch.physics import external_forces
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
    "Grid",
    "RMTConfig",
    "SimState",
    "compute_contact_force",
    "diverged",
    "external_forces",
    "free_slip_box_bc",
    "grad_correct_fused",
    "make_init_state",
    "make_lid_bc",
    "make_rebase_runner",
    "make_run_chunk",
    "make_step",
    "noop_bc",
    "projection_stencils_supported",
    "rc_rhs_fused",
    "run_until",
    "state_from_numpy",
    "state_to_numpy",
    "velocity_rhs_blended_fused",
]
