#!/usr/bin/env python3
"""Smoke run of pyrmt_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-kernels [ROOT]

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases:

  1. probe: torch and CUDA versions, nvcc, the card's name and power limit;
  2. build the five CUDA sources of pyrmt_tpu_torch/csrc side by side;
  3. each of the seven kernels (all tile kernels) against its plain
     PyTorch version on the same tensors on the card: float64 at N=256
     (max-abs <= 1e-11), float32 at N=256 and at the flagship's N=1024
     (bounds below), the disc touching the domain's edge at N=256 (the
     solid-block kernels and the extrapolation), grad_correct under the
     lid, free-slip and no-op BCs, velocity_rhs with a random external
     force; all seven also on ragged grids (203x301, 9x300, 33x49) in both
     types and at N=4096 float32 (there the seven alone: their modes' rows
     at N=1024 hold the same code); the contact configuration's two modes,
     rmt_block with two solids and the two-solid clamp and momentum_rk4
     with the contact and gravity force, at the same sizes; momentum_rk4's
     periodic instantiation on overlap-consistent operands (with and
     without the force, eta_s 0 and 0.01) at N=256, 65x65, 129x129,
     203x301, 9x300 and 33x49 in both types and at N=1024 float32; the new
     modes of the two solid blocks at every one of those sizes but N=4096
     (MODES: rmt_block with the bicubic final sample, band-guarded
     and raw, in the band-mode stress, and with two solids and the bicubic
     sample; advext_block with the bicubic sample, guarded and raw; rmt_block
     with the capillary drop's ellipse, bilinear and bicubic (guarded and
     raw) and in the band mode, and with a disc beside an ellipse in
     contact range, bilinear and bicubic); extrapolate_fused on the masked
     maps that one general-tier step hands it (the flagship with WENO5,
     with central2, and with CFL 1.5 on the gather path, from a swirl) at
     N=256, 203x301 (both types) and 1024 (float32); then the times
     of kernel and plain version at N=1024 (CUDA events), and in one
     torch.profiler session each kernel's device time and device kernels
     per call at N=1024 and N=4096 beside its bound (rmt_block,
     advext_block and extrapolate_fused also with every tile skipping; the
     two contact modes, the periodic instantiation beside the lid's, and
     the FFT solve of the periodic projection, cuFFT, at N=1024; the new
     modes beside the bilinear rows, the ellipse's among them), and the
     kernels and device-busy ms per step of phases 4, 4b, 4c, 4d, 4e, 4f,
     5, 8, 10 and 11's configurations (20 steps each; for 4f also
     extrapolate_fused's device kernels and time per step);
  4. the flagship soft disc in the lid-driven cavity at N=1024 float32
     (the fused tier): 50 warm-up steps, one step under sync-debug, 500
     timed steps with the launch counts checked;
  4b. the flagship with projection_method='pallas' (the projection's
     stencil kernels): 20 warm-up steps, one under sync-debug, 200 timed;
  4c. the same with momentum_method='xla', use_pallas_rhs=True added (the
     one-RHS kernel at each RK4 stage in place of the RK4 kernel);
  4d. the flagship with sl_interp='bicubic' (bench.py --bicubic: the
     bicubic instantiation of rmt_block, band-guarded) and with
     stress_band=True, num_layers=4 (benchmarks/soft_disc_in_lid_driven.py's
     setting: rmt_block's band mode): 20 warm-up steps, one under
     sync-debug, 200 timed with the launch counts checked;
  4e. the coupled capillary drop (benchmarks/capillary_drop_coupled.py:
     the ellipse on the fused tier, gamma 0.1, the balanced CSF, free
     slip) and the density-contrast disc (benchmarks/density_contrast_disc
     .py: ratio 10, gravity, the variable-density CG with cg_tol 1e-6) at
     N=1024 float32: the same protocol (the sync-debug step lifts the mode
     around the CG's stopping-test reads alone), the CG's iterations and
     host reads per step;
  4f. the general tier at N=1024 float32: the flagship with
     scheme='weno5', with scheme='central2' and with sl_local=False (the
     advection as plain ops, extrapolate_fused once per solid): 10 warm-up
     steps, one under sync-debug, 100 timed with the launch counts checked
     (S extrapolate_fused and 1 momentum_rk4 per step, no solid block);
  5. the split tier at full width: the flagship with the area fix and PDE
     reinitialisation, 20 warm-up steps, one under sync-debug, 200 timed;
  6. rebasing at full width: make_rebase_runner on the flagship with
     map_rebase_minj=0.5, one pre-rebase step under sync-debug, a 50-step
     chunk, a forced rebase (timed, with its fast-sweeping redistance), 20
     post-rebase steps;
  7. paths: 3 float64 steps at N=128 through the kernels and through the
     plain versions, for the flagship, for area fix + PDE reinit, for a
     rebase on every step, for the flagship with both opt-in switches, for
     area fix + PDE reinit with the projection's stencil kernels, for the
     contact configuration with touching contact bands, for it with
     gravity on the split tier (area fix), for the flagship on the
     doubly-periodic box (bench.py --periodic), with no solid for the
     lid-driven cavity and the periodic Taylor-Green vortex, and for the
     bicubic sample (the flagship, area fix on the split tier, the
     periodic flagship) and the band-mode stress, and for surface tension,
     variable density and the faults the port repaired: the cell CSF, the
     balanced CSF with kappa* and with the smoothed height function, the
     capillary ellipse on the fused and (area fix) split tiers, the density
     contrast, a disc beside an ellipse in contact, the lid BC without a
     kernel_spec (the plain RK4 stage loop) and a rounded square (the split
     tier), and for the general tier: the flagship with WENO5, with
     central2, with sl_local=False (bilinear and bicubic) and with CFL 1.5
     (a backtrace longer than a cell, checked), WENO5 with area fix and
     PDE reinit, on the contact configuration and with a rebase on every
     step, central2 on the periodic box; each line names the paths the
     step's blocks took;
  8. contact: the head-on collision of two soft discs
     (benchmarks/two_disc_contact.py: free-slip box, k_rep = 2, the
     two-solid clamp 4) at N=1024 float32: 20 warm-up steps, one under
     sync-debug, 200 timed steps with the launch counts checked;
  9. the collision at N=256 float32 to t = 0.6, the predicates of the JAX
     package's gate (tests/test_validation_gates.py): the least distance
     of the two solids' centroids over the steps above 2R (no
     pass-through), the least J over the run in (0.5, 1);
  10. the flagship on the doubly-periodic box, seeded with a Taylor-Green
     vortex (bench.py --periodic), at N=1024 float32: 20 warm-up steps,
     one under sync-debug, 200 timed with the launch counts checked;
  11. the pure-fluid lid-driven cavity (no solid) at N=1024 float32, on the
     RK4 kernel and with momentum_method='xla': the same protocol;
  12. the JAX package's two solid-free gates on the card, with its own
     predicates and sizes (tests/test_validation_gates.py): the periodic
     Taylor-Green decay at N=65 float64 to t = 0.5 (stable, decay-rate
     error < 1e-2, profile error < 5e-3, divergence < 1e-6), and Ghia's
     lid-driven cavity at Re = 100, N=65 float64 to the steady criterion
     of benchmarks/lid_driven_cavity.py (centreline RMS < 5e-3); then the
     surface-tension and density-contrast gates through validation.py:
     Laplace's law at N=48 float64 (the cell CSF's error < 1.5e-2, the
     balanced CSF with kappa* strictly below it) and the heavy disc at N=48
     float64 to t = 0.25 (sinks, CG iterations < 100, relative divergence
     < 0.2);
  13. gradients: every kernel wrapper is an autograd.Function whose
     backward is its plain version's autograd. Seven [grad] lines, 3
     float64 steps at N=128 (the flagship; with projection_method='pallas';
     the area fix on the split tier; central2 on the general tier; both
     opt-in switches; the density contrast, through the CG's implicit
     adjoint; the capillary drop with gamma traced): d/d(mu_s) (traced) and
     d/d(a factor on the initial velocity) through the kernels against the
     plain path (relative 1e-12) and central differences of the kernel
     path (1e-5), with the forward's launch counts and none in the
     backward, and on the flagship make_rollout's checkpointed gradient;
     one traced flagship step at N=1024 float32 with inputs requiring
     gradients under sync-debug; make_diff_rollout of the flagship at
     N=1024 float32 over 10 steps with mu_s traced (finite, the
     plain-forward rollout's gradient to 1e-5, forward and backward
     ms/step, peak memory); the inverse problem of
     examples/differentiable_fsi.py (N=48 float64, 60 steps, a Taylor-Green
     seed, fixed_dt 1.5e-3: mu_s from 1.2 back to 0.4 within 1 %, two
     Adam steps written inline, then secant iteration). Phase 3 also
     times each kernel's backward (the plain twin's forward and autograd)
     at N=1024 float32 ([backward] lines);
  14. domain decomposition: (a) the sharding offsets of rmt_block
     (bilinear, bicubic, two solids with the clamp, the capillary drop's
     ellipse, a disc beside an ellipse with the clamp), advext_block and
     momentum_rk4 (under the lid, and with the contact and gravity force
     under free slip), in one process: every block of the (4,1), (1,4),
     (2,2) and (2,4) meshes of N=256 float64 and N=1024 float32 operands,
     and of the (2,2) mesh of N=2048 float32 operands (the blocks that
     (b)'s flagship gives its ranks), padded by its exchange halo with
     zeros beyond the domain, through the wrapper with its offsets; the
     blocks stitched must equal the unsharded kernel bit for bit, each
     slab its plain twin with the same offsets within the phase-3 bounds;
     the offset instantiations' times (rmt_block's with a disc and with
     the ellipse) on the (0, 0) block of the (2,2) mesh of N=2048 float32
     (their device times are phase 3's profile rows "..., offsets"); (b)
     the sharded step in one gloo world of 4 processes on the card
     (parallel.launch.run_world: the halo and the gathers through host
     copies) against the single-process step from the same state: at
     N=2048 float32 on (2,2), within 1e-4 of max(1, |field|), the
     flagship (20 steps), the density contrast (the CG, 10 steps, each
     step's iterations beside the single process's, within one), the
     split tier (area fix + PDE reinit, 10 steps), the periodic
     flagship (10 steps) and the capillary drop (phase 4e's: the
     ellipse, the balanced CSF, free slip; 10 steps), each beside a
     float64 single-process run (how far either float32 step lies from
     it); at N=256 float64 on (2,2) and (4,1), 3 steps, within 1e-10 (u,
     v, p) and 1e-11 (X): the flagship, the density contrast (iterations
     equal), the split tier, the periodic Taylor-Green pure fluid, the
     capillary drop, and on (2,2) a pure fluid under the lid and the
     capillary drop's split-tier twin (the cell CSF with kappa*, the area
     fix); at N=128 float64 on (2,2) the 'fmm' reinit and the
     always-firing rebase (3 steps). Every rank launches the offset
     instantiation of each kernel of its step once a step (rmt_block on
     the fused tier, the ellipse's in the capillary drop, advext_block on
     the split tier, momentum_rk4 under walls, with the force where the
     step has one; the periodic box's momentum is the plain stage loop, as in
     JAX) and extrapolate_fused once a rebase. [shard] lines, each
     field's error beside its bound; the wall ms/step of 4 processes
     sharing one card is a
     correctness run's, not a scaling number.

It then prints a [time] line of each phase's wall seconds, a JSON line of
the kernels (with each kernel's backward ms and the largest relative
gradient difference of phase 13) and of the full-width gradient run, the
card's name and power limit as nvidia-smi gives them, and last one JSON
line
{"ok": true, "device": {...}}. Any failure raises before that line and
exits nonzero; so does a machine without CUDA.

With --profile-kernels it runs phases 1 and 2 and the device profile of
the seven kernels only, at N=1024 and N=4096 float32, and of the
step groups of phase 3, for the pyrmt_tpu_torch package under ROOT
(default: this checkout), and prints one JSON line: the way to time
another commit's kernels and steps on the same card, e.g. the parent's
unpacked with git archive into a git-ignored directory (a package
without the contact modes profiles the rest).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

PROFILE_ONLY = len(sys.argv) > 1 and sys.argv[1] == "--profile-kernels"
PORT_ROOT = os.path.abspath(sys.argv[2] if PROFILE_ONLY and len(sys.argv) > 2
                            else os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, PORT_ROOT)

from pyrmt_tpu_torch import (  # noqa: E402
    Disc,
    Grid,
    RMTConfig,
    diverged,
    free_slip_box_bc,
    make_init_state,
    make_lid_bc,
    make_rebase_runner,
    make_step,
    noop_bc,
)
from pyrmt_tpu_torch import bcs  # noqa: E402
from pyrmt_tpu_torch.ops import advect  # noqa: E402
from pyrmt_tpu_torch.ops import levelset  # noqa: E402
from pyrmt_tpu_torch.ops import poisson  # noqa: E402
from pyrmt_tpu_torch.kernels import _build  # noqa: E402
from pyrmt_tpu_torch.kernels import extrapolate_fused as ef  # noqa: E402
from pyrmt_tpu_torch.kernels import momentum_rhs as mr  # noqa: E402
from pyrmt_tpu_torch.kernels import momentum_rk4 as mk  # noqa: E402
from pyrmt_tpu_torch.kernels import projection_stencils as ps  # noqa: E402
from pyrmt_tpu_torch.kernels import rmt_block as rb  # noqa: E402
from pyrmt_tpu_torch.ops.extrapolate import (  # noqa: E402
    extrapolate_reference_map,
)
from pyrmt_tpu_torch.ops.levelset import (  # noqa: E402
    reinitialize_phi_fsm,
    smoothed_solid_area,
)
from pyrmt_tpu_torch.ops.stress import solid_cauchy_stress  # noqa: E402
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside  # noqa: E402
from pyrmt_tpu_torch.physics import (  # noqa: E402
    compute_timestep,
    momentum_core,
    velocity_rhs_blended,
)

# Does the package under PORT_ROOT take two solids, the clamp and forces?
# The periodic box and no solid? (--profile-kernels on an older commit
# profiles the rest.)
HAS_CONTACT = "stress_clamp" in inspect.signature(
    rb.rmt_block_fused).parameters
HAS_PERIODIC = "periodic" in inspect.signature(
    mk.momentum_rk4_fused).parameters
# The bicubic sample and the band-mode stress?
HAS_BICUBIC = "sl_interp" in inspect.signature(rb.rmt_block_fused).parameters
# The ellipse level set in the fused tier's kernel, surface tension and
# variable density?
HAS_ST = hasattr(levelset, "Ellipse")
# The general tier: WENO5, central2, the gather path?
HAS_GENERAL = hasattr(advect, "advect_weno5_rk3")
# The sharding offsets of the solid blocks and the RK4 kernel?
HAS_OFFSETS = "row_offset" in inspect.signature(
    rb.rmt_block_fused).parameters

# Tolerances of kernel vs plain version on the same inputs. Both evaluate
# the same IEEE operations in the same order (nvcc --fmad=false; a
# division by a constant is a product by its reciprocal in both), and on
# the H100 with CUDA 12.9 they agree bit for bit. The bounds leave room for
# a toolkit whose sin or sqrt rounds differently from PyTorch's.
# float64: an ulp of difference anywhere stays far below 1e-11.
TOL_F64 = 1e-11
# float32: an ulp of the map X (6e-8 at |X| ~ 0.5) over 2 dx = 2/1023 is
# ~2e-5 relative in grad X, so J and sigma may move by ~1e-5 of their size
# when the map moves by an ulp. The bound is 1e-4 times max(1, max |plain|):
# sigma and J grow large where det G is small, and there only the relative
# error means anything. The velocity update sees those differences times
# dt, hence 1e-5 there. The projection stencils and the one RHS read no
# map: 1e-5 (their expected difference is 0, as for the others).
TOL_F32_RMT = 1e-4
TOL_F32_MOMENTUM = 1e-5

FLAGSHIP_DISC = Disc(0.6, 0.5, 0.2)
EDGE_DISC = Disc(0.08, 0.9, 0.15)  # clipped by the domain's edge
# the head-on collision (benchmarks/two_disc_contact.py:37-57), and the
# same discs moved so that their contact bands touch at once (the
# configuration of tests/test_sharding.py's contact test)
CONTACT_DISCS = (Disc(0.30, 0.5, 0.15), Disc(0.70, 0.5, 0.15))
TOUCHING_DISCS = (Disc(0.38, 0.5, 0.14), Disc(0.66, 0.5, 0.14))
if HAS_ST:
    # the capillary drop's ellipse (benchmarks/capillary_drop_coupled.py:
    # R = 0.2, eccentricity 1.15: a = 0.23, b = 0.174), and a disc and an
    # ellipse whose contact bands touch at x = 0.49
    ELLIPSE = levelset.Ellipse(0.5, 0.5, 0.2 * 1.15, 0.2 / 1.15)
    DISC_AND_ELLIPSE = (Disc(0.36, 0.5, 0.13),
                        levelset.Ellipse(0.64, 0.52, 0.15, 0.11))
CONTACT_V0 = 0.15
# device kernels per wrapper call: advext_block's and extrapolate_fused's
# flag pre-pass and tile kernel; one for the others
DEVICE_KERNELS = {"advext_block": 2, "extrapolate_fused": 2}
SOURCES = ("rmt_block", "momentum_rk4", "extrapolate_fused",
           "projection_stencils", "momentum_rhs")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "rmt_block": ("pyrmt_tpu_torch/csrc/rmt_block.cu",
                  "pyrmt_tpu/kernels/rmt_block.py:825"),
    "momentum_rk4": ("pyrmt_tpu_torch/csrc/momentum_rk4.cu",
                     "pyrmt_tpu/kernels/momentum_rk4.py:453"),
    # the ('periodic',) spec of the same TPU kernel
    "momentum_rk4_periodic": ("pyrmt_tpu_torch/csrc/momentum_rk4.cu",
                              "pyrmt_tpu/kernels/momentum_rk4.py:453"),
    "advext_block": ("pyrmt_tpu_torch/csrc/rmt_block.cu",
                     "pyrmt_tpu/kernels/rmt_block.py:1085"),
    "extrapolate_fused": ("pyrmt_tpu_torch/csrc/extrapolate_fused.cu",
                          "pyrmt_tpu/kernels/extrapolate_fused.py:202"),
    "rc_rhs": ("pyrmt_tpu_torch/csrc/projection_stencils.cu",
               "pyrmt_tpu/kernels/projection_stencils.py:185"),
    "grad_correct": ("pyrmt_tpu_torch/csrc/projection_stencils.cu",
                     "pyrmt_tpu/kernels/projection_stencils.py:218"),
    "velocity_rhs": ("pyrmt_tpu_torch/csrc/momentum_rhs.cu",
                     "pyrmt_tpu/kernels/momentum_rhs.py:260"),
}
# Device-memory fields each kernel must move (read once, written once) and
# its floating-point operations per cell (counted from the sources, rounded
# up; the solid blocks' window sums on the thin frontier ring left out):
# the bound is the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s
# (the H100 SXM's HBM rate and float32 peak off the tensor cores).
WORK = {  # name: (fields read, fields written, operations per cell)
    "rmt_block": (4, 12, 200),
    "momentum_rk4": (9, 2, 400),
    # the contact configuration's modes: S = 2 solids (2 + 2S read, 7S + 5
    # written), the force without Kelvin-Voigt (u, v, p, three stresses,
    # Hf, rho and the two force fields read)
    "rmt_block, two solids": (6, 19, 400),
    # the bicubic sample: 2 x 16 taps, their min/max and 10 cubic
    # convolutions of ~12 operations a cell more than the bilinear one
    "rmt_block, bicubic": (4, 12, 400),
    "rmt_block, raw bicubic": (4, 12, 400),
    "rmt_block, two solids bicubic": (6, 19, 800),
    "advext_block, bicubic": (5, 2, 350),
    # the ellipse level set: the disc's fields, ~25 more operations per
    # level-set evaluation (a few per cell: the vote, the advection's
    # phi0, the post stage's phi and four neighbours)
    "rmt_block, ellipse": (4, 12, 350),
    "rmt_block, ellipse offsets": (4, 12, 350),
    "rmt_block, disc and ellipse": (6, 19, 550),
    "advext_block, raw bicubic": (5, 2, 350),
    "momentum_rk4, force": (10, 2, 400),
    "momentum_rk4_periodic": (9, 2, 400),
    # the periodic projection's FFT solve (a library call, cuFFT): rhs read,
    # p written; four 1D complex FFT passes of ~5 log2(1023) operations
    "solve_poisson_fft": (1, 1, 200),
    "advext_block": (5, 2, 150),
    "extrapolate_fused": (3, 2, 10),
    "rc_rhs": (4, 1, 40),
    "grad_correct": (4, 2, 30),
    "velocity_rhs": (10, 2, 100),
}
# the profile rows of the contact configuration's modes: {row: kernel}
CONTACT_MODES = {"rmt_block, two solids": "rmt_block",
                 "momentum_rk4, force": "momentum_rk4"}
# the solid blocks' modes of the bicubic sample and the band-mode stress:
# {profile row: kernel}; their bound is the bilinear rows' bytes (the same
# fields read and written), with the bicubic sample's operations added
MODES = {"rmt_block, bicubic": "rmt_block",
         "rmt_block, raw bicubic": "rmt_block",
         "rmt_block, band": "rmt_block",
         "rmt_block, two solids bicubic": "rmt_block",
         "advext_block, bicubic": "advext_block",
         "advext_block, raw bicubic": "advext_block"}
# the ellipse level set's modes of rmt_block: the capillary drop's (one
# ellipse, bilinear, interior stress) and a disc beside an ellipse (the
# S >= 2 instantiation, the clamp), profiled and timed as MODES; the other
# samples and stress modes checked against the plain version only
if HAS_ST:
    MODES.update({"rmt_block, ellipse": "rmt_block",
                  "rmt_block, disc and ellipse": "rmt_block"})
CHECKED = {"rmt_block, ellipse bicubic": "rmt_block",
           "rmt_block, ellipse raw bicubic": "rmt_block",
           "rmt_block, ellipse band": "rmt_block",
           "rmt_block, disc and ellipse bicubic": "rmt_block"}

# the band guard of the flagship's bicubic sample: sl_band_guard's 3 cells
GUARD_CELLS = 3.0
# profile rows whose wrapper runs PyTorch kernels beside its own (the
# periodic wrapper's periodic_bc, a few copies): {row: a part of the name
# of its own device kernel}, which alone makes the row's device time
OWN_KERNEL = {"momentum_rk4_periodic": "rk4_periodic_kernel"}
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the opt-in switches of phases 4c and 7
BOTH_SWITCHES = dict(projection_method="pallas", momentum_method="xla",
                     use_pallas_rhs=True)
# phase 4d's configurations: bench.py --bicubic, and the band-mode stress
# of benchmarks/soft_disc_in_lid_driven.py
NEW_CONFIGS = {"flagship bicubic": dict(sl_interp="bicubic"),
               "flagship band": dict(stress_band=True, num_layers=4)}
# the timed phase 4e's configurations
ST_CONFIGS = ("capillary drop", "density contrast")
# the general tier's configurations (phase 4f and its profile groups): the
# flagship with each advection the gather-free backtrace does not take
GENERAL_CONFIGS = {"weno5": dict(scheme="weno5"),
                   "central2": dict(scheme="central2"),
                   "gather": dict(sl_local=False)}
# CFL >= 1 that the timestep's caps let through: the solid's P-wave limit
# gives dt ~ 1.49 dx, so |u| = 1 moves the map 1.49 cells a step
CFL_RECIPE = dict(CFL=1.5, mu_f=1e-4, mu_s=0.01, kappa=1.0, eta_s=0.0,
                  dt_min_cap=1.0)
# phase 3's general-tier steps whose masked maps extrapolate_fused takes:
# {case: (flagship overrides, swirl amplitude)}
GENERAL_MAPS = {"weno5": (dict(scheme="weno5"), 0.5),
                "central2": (dict(scheme="central2"), 0.5),
                "gather CFL 1.5": (CFL_RECIPE, 1.0)}
# a part of the names of extrapolate_fused's two device kernels
EXTRAP_KERNEL = "extrap_"
PLAIN_IMPLS = dict(rmt_block_impl=rb.rmt_block_plain,
                   momentum_rk4_impl=momentum_core,
                   advext_impl=rb.advext_block_plain,
                   extrap_impl=extrapolate_reference_map,
                   momentum_rhs_impl=velocity_rhs_blended,
                   projection_stencils_impl=(ps.rc_rhs_plain,
                                             ps.grad_correct_plain))
OUT_NAMES = ("X1e", "X2e", "phi", "sxx", "sxy", "syy", "J", "Hf", "rho",
             "sb_xx", "sb_xy", "sb_yy")
# phase 14: the meshes whose blocks phase 14a cuts, and the offset
# instantiations' profile rows, each timed on the (0, 0) block of the
# (2, 2) mesh of an OFFSET_N field (N=1024 cells of it, the unsharded
# row's, plus the halo of the exchange on its two cut sides): {row:
# (the offset_cases case, a part of the names of its own device kernels,
# which alone make the row's device time; the wrapper's zeroed outputs
# are memsets)}
SHARD_MESHES = ((4, 1), (1, 4), (2, 2), (2, 4))
OFFSET_N = 2048
OFFSET_ROWS = {"rmt_block, offsets": ("rmt_block", "rmt_tile_kernel"),
               "rmt_block, ellipse offsets": ("rmt_block, ellipse",
                                              "rmt_tile_kernel"),
               "advext_block, offsets": ("advext_block", "advext_"),
               "momentum_rk4, offsets": ("momentum_rk4", "rk4_kernel")}
# phase 14b: 4 ranks on the one card
SHARD_RANKS = 4


def flagship(N, **overrides):
    """The flagship configuration of __graft_entry__._flagship, with
    overrides."""
    fields = dict(mu_s=0.1, eta_s=0.01, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                  num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    return RMTConfig(grid=Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0),
                     **dict(fields, **overrides))


def contact_config(N, **overrides):
    """The head-on collision's configuration
    (benchmarks/two_disc_contact.py:41-45)."""
    fields = dict(mu_s=1.0, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=0.01,
                  rho_f=1.0, w_t_cells=2.0, w_c_cells=3.0, k_rep=2.0,
                  two_solid_clamp=4.0, num_layers=3, CFL=0.2,
                  dt_min_cap=1e-3)
    return RMTConfig(grid=Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0),
                     **dict(fields, **overrides))


def capillary_config(N, **overrides):
    """The coupled capillary drop's configuration
    (benchmarks/capillary_drop_coupled.py:84-90: mu_s = mu_f = 1e-3, gamma
    0.1, the balanced CSF, CFL 0.4), with overrides; free-slip walls."""
    fields = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                  rho_f=1.0, gamma=0.1, w_t_cells=2.0, st_method="balanced",
                  num_layers=3, CFL=0.4, dt_min_cap=1e-3)
    return RMTConfig(grid=Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0),
                     **dict(fields, **overrides))


def swirl_state(cfg, shapes, dtype, device, amp=0.05):
    """make_init_state with a swirl u = amp sin(pi x) cos(pi y), v = -amp
    cos(pi x) sin(pi y), so that an interface moves from the first step."""
    X, Y = cfg.grid.coords(dtype=dtype, device=device)
    return make_init_state(
        cfg, shapes, u0=amp * torch.sin(math.pi * X) * torch.cos(math.pi * Y),
        v0=-amp * torch.cos(math.pi * X) * torch.sin(math.pi * Y),
        dtype=dtype, device=device)


def lid_without_spec(u, v):
    """The lid BC as a user writes it, with no kernel_spec: the step takes
    the plain RK4 stage loop (and plain projection stencils)."""
    return make_lid_bc(1.0)(u, v)


def rounded_square(X1, X2):
    """A rounded square at the flagship disc's place: a level set the
    fused tier's kernel does not evaluate (the step takes the split
    tier)."""
    qx = torch.clamp(torch.abs(X1 - 0.6) - 0.1, min=0.0)
    qy = torch.clamp(torch.abs(X2 - 0.5) - 0.1, min=0.0)
    inside = torch.clamp(torch.maximum(torch.abs(X1 - 0.6),
                                       torch.abs(X2 - 0.5)) - 0.1, max=0.0)
    return torch.sqrt(qx * qx + qy * qy) + inside - 0.1


def st_case(name, N, dtype, device):
    """(cfg, bc, shapes, state) of phase 4e's configurations: the capillary
    drop with its ellipse, and the density-contrast disc of
    benchmarks/density_contrast_disc.py (ratio 10, g0 = 1, cg_tol 1e-6)
    released at rest."""
    from pyrmt_tpu_torch import validation

    if name == "capillary drop":
        cfg = capillary_config(N)
        return (cfg, free_slip_box_bc, (ELLIPSE,),
                make_init_state(cfg, (ELLIPSE,), dtype=dtype, device=device))
    cfg = validation.density_contrast_config(N)
    shapes = (validation.DENSITY_DISC,)
    return (cfg, free_slip_box_bc, shapes,
            make_init_state(cfg, shapes, dtype=dtype, device=device))


def contact_state(cfg, discs, dtype, device, V0=CONTACT_V0):
    """make_init_state of the collision: u0 = V0 (1 - H_a) - V0 (1 - H_b),
    the discs approaching each other, after the free-slip BC
    (two_disc_contact.py:52-58)."""
    X, Y = cfg.grid.coords(dtype=dtype, device=device)
    Ha = smoothed_heaviside(discs[0](X, Y), cfg.w_t)
    Hb = smoothed_heaviside(discs[1](X, Y), cfg.w_t)
    u0, v0 = free_slip_box_bc(V0 * (1 - Ha) - V0 * (1 - Hb),
                              torch.zeros_like(X))
    return make_init_state(cfg, discs, u0=u0, v0=v0, dtype=dtype,
                           device=device)


def tg_seed(cfg, dtype, device, amp=0.5):
    """bench.py --periodic's Taylor-Green seed (bench.py:65-74):
    u = amp sin(2 pi x) cos(2 pi y), v = -amp cos(2 pi x) sin(2 pi y)."""
    X, Y = cfg.grid.coords(dtype=dtype, device=device)
    return (amp * torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y),
            -amp * torch.cos(2 * math.pi * X) * torch.sin(2 * math.pi * Y))


def periodic_state(cfg, dtype, device):
    """make_init_state of the flagship disc on the periodic box with the
    Taylor-Green seed."""
    u0, v0 = tg_seed(cfg, dtype, device)
    return make_init_state(cfg, (FLAGSHIP_DISC,), u0=u0, v0=v0, dtype=dtype,
                           device=device)


def fluid_case(kind, N, dtype, device, **overrides):
    """(cfg, bc, state) with no solid: 'lid', the lid-driven cavity of
    benchmarks/lid_driven_cavity.py (Re = 100), or 'tg', the periodic
    Taylor-Green vortex of benchmarks/periodic_taylor_green.py."""
    from pyrmt_tpu_torch import validation

    if kind == "lid":
        cfg = dataclasses.replace(validation.lid_cavity_config(N),
                                  **overrides)
        return cfg, make_lid_bc(1.0), validation.lid_cavity_state(
            cfg, dtype, device)
    cfg = dataclasses.replace(validation.taylor_green_config(N), **overrides)
    u0, v0 = tg_seed(cfg, dtype, device)
    return cfg, bcs.periodic_bc, make_init_state(
        cfg, (), u0=u0, v0=v0, dtype=dtype, device=device)


def overlap(f):
    """f made overlap-consistent: column Nx-1 set to column 0, then row
    Ny-1 to row 0 (the periodic box's layout)."""
    f = f.clone()
    f[:, -1] = f[:, 0]
    f[-1, :] = f[0, :]
    return f


def periodic_momentum_args(cfg, d, rmt_out, eta_s, force):
    """momentum_args' operands made overlap-consistent, as the step gives
    them on the periodic box, with kernel_inputs' force where asked."""
    fields, kw = momentum_args(cfg, d, rmt_out, eta_s)
    kw = dict(kw, periodic=True)
    if force:
        kw.update(f_ext_x=overlap(d["fx"]), f_ext_y=overlap(d["fy"]))
    return tuple(overlap(f) for f in fields), kw


def compare_periodic(shape, dtype, device):
    """momentum_rk4's periodic instantiation against the plain periodic
    update (physics.momentum_core(periodic=True)) on the same
    overlap-consistent operands: without and with the force, eta_s 0 and
    the flagship's 0.01. Returns the max-abs difference; raises past the
    tolerance."""
    f64 = dtype == torch.float64
    cfg, d = kernel_inputs(shape, dtype, device)
    g = cfg.grid
    tag = (f"N={g.Nx}" if g.Nx == g.Ny else f"{g.Ny}x{g.Nx}") + \
        f" {str(dtype)[6:]}"
    plain = rmt_call(rb.rmt_block_plain, cfg, d)
    worst = 0.0
    for eta_s in (0.0, cfg.eta_s):
        for force in (False, True):
            args, kw = periodic_momentum_args(cfg, d, plain, eta_s, force)
            ref = momentum_core(*args, bcs.periodic_bc, **kw)
            out = mk.momentum_rk4_fused(*args, bcs.periodic_bc, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(("u_new", "v_new"), out, ref):
                err, scale = max_errs(a, b)
                check_close(f"{tag} momentum_rk4 periodic"
                            f"{' force' if force else ''} eta_s={eta_s} "
                            f"{name}", err, scale, f64, TOL_F32_MOMENTUM)
                worst = max(worst, err)
    return worst


def general_maps(shape, dtype, device, overrides, amp):
    """The masked maps and level sets that one general-tier step hands to
    its extrapolation: the flagship at ``shape`` with ``overrides`` from a
    swirl of amplitude ``amp``, every block on its plain version. Returns
    (cfg, [(X1, X2, phi) of each solid])."""
    Ny, Nx = (shape, shape) if isinstance(shape, int) else shape
    cfg = dataclasses.replace(flagship(Nx, **overrides),
                              grid=Grid(Nx=Nx, Ny=Ny, Lx=1.0, Ly=1.0))
    seen = []

    def record(X1, X2, phi, dx, dy, layers):
        seen.append((X1, X2, phi))
        return extrapolate_reference_map(X1, X2, phi, dx, dy, layers)

    step = make_step(cfg, make_lid_bc(1.0), (FLAGSHIP_DISC,), dtype=dtype,
                     device=device, **dict(PLAIN_IMPLS, extrap_impl=record))
    if step.paths["solid"] != "general":
        raise AssertionError(f"{overrides}: paths {step.paths}")
    step(swirl_state(cfg, (FLAGSHIP_DISC,), dtype, device, amp), 8.0)
    return cfg, seen


def compare_general_extrap(shape, dtype, device):
    """extrapolate_fused against its plain version on the masked maps of
    one general-tier step of each GENERAL_MAPS case (WENO5's and
    central2's banded fronts, the gather path's map moved 1.5 cells).
    Returns the max-abs difference; raises past the tolerance."""
    f64 = dtype == torch.float64
    Ny, Nx = (shape, shape) if isinstance(shape, int) else shape
    tag = (f"N={Nx}" if Nx == Ny else f"{Ny}x{Nx}") + f" {str(dtype)[6:]}"
    worst = 0.0
    for case, (overrides, amp) in GENERAL_MAPS.items():
        cfg, seen = general_maps(shape, dtype, device, overrides, amp)
        g = cfg.grid
        for X1, X2, phi in seen:
            args = (X1, X2, phi, g.dx, g.dy, cfg.num_layers)
            ref = extrapolate_reference_map(*args)
            out = ef.extrapolate_reference_map_fused(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("X1e", "X2e"), out, ref):
                err, scale = max_errs(a, b)
                check_close(f"{tag} extrapolate_fused on the {case} step's "
                            f"masked maps {name}", err, scale, f64,
                            TOL_F32_RMT)
                worst = max(worst, err)
    return worst


def ptxas_lines(log):
    """(entry, its stack, spills and registers) of each entry function of
    an nvcc -Xptxas -v log, the entry's name demangled (c++filt) up to its
    parameter list where the tool is there."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            try:
                entry = subprocess.run(["c++filt", entry], capture_output=True,
                                       text=True, check=True).stdout.strip()
                entry = entry.replace("(anonymous namespace)::", "")
                entry = entry.split("(")[0].replace("void ", "")
            except (OSError, subprocess.CalledProcessError):
                pass
        elif entry and ("spill" in line or "registers" in line):
            out.append((entry, line.split(":", 1)[-1].strip()))
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_us(name, N, dtype=torch.float32):
    """(the least device time of one call at N x N in microseconds, what
    bounds it: 'bytes' or 'operations'); a profile row "kernel, case" takes
    its own work where WORK has it, else the kernel's."""
    read, written, ops = WORK.get(name) or WORK[name.split(",")[0]]
    cells_read = cells_written = N * N
    if name in OFFSET_ROWS:
        # the slab the row times: its cells inside the domain are read,
        # and the kernel writes those farther than the stale depth from
        # its two cuts (the wrapper's memset zeroes the rest)
        kernel = OFFSET_ROWS[name][0]
        depth = (8 if kernel == "momentum_rk4" else
                 rb.cut_depth(flagship(N).num_layers))
        cells_read = (N + offset_halo(kernel)) ** 2
        cells_written = (N + offset_halo(kernel) - depth) ** 2
    item = torch.finfo(dtype).bits // 8
    t_bytes = (1e6 * (read * cells_read + written * cells_written) * item
               / HBM_BYTES_PER_S)
    t_ops = 1e6 * ops * cells_written / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(shape, dtype, device, seed=0, disc=FLAGSHIP_DISC):
    """Seeded smooth inputs around a disc on an N x N (or shape = (Ny, Nx))
    grid: a velocity of a few random Fourier modes scaled to a sub-cell
    displacement, the disc's initial map plus a smooth sub-cell
    perturbation, a smooth pressure, the split tier's pre-advection phi
    (the map's rebuild, shifted and wobbled by a fraction of a cell, as
    reinit and the area fix move it), a pressure correction and an
    external force of random noise."""
    Ny, Nx = (shape, shape) if isinstance(shape, int) else shape
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(flagship(Nx),
                              grid=Grid(Nx=Nx, Ny=Ny, Lx=1.0, Ly=1.0))
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    u = np.zeros((Ny, Nx))
    v = np.zeros((Ny, Nx))
    for _ in range(4):
        kx, ky = rng.integers(1, 4, size=2)
        a, b, c = rng.standard_normal(3)
        u += a * np.sin(np.pi * kx * X + c) * np.cos(np.pi * ky * Y)
        v += b * np.cos(np.pi * kx * X) * np.sin(np.pi * ky * Y + c)
    scale = 0.5 / max(np.abs(u).max(), np.abs(v).max())
    u, v = u * scale, v * scale
    p = 0.05 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    state = make_init_state(cfg, (disc,), dtype=dtype, device=device)
    # half a cell: a larger shift would move the level set past the
    # num_layers-cell band the map was extrapolated into
    r = rng.standard_normal()
    pert = 0.5 * cfg.grid.dx * np.sin(3 * np.pi * X + r) * np.sin(2 * np.pi * Y)
    pert2 = 0.5 * cfg.grid.dx * np.sin(3 * np.pi * Y + r) * np.sin(2 * np.pi * X)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    X1s = (state.X1 + t(pert)).contiguous()
    X2s = (state.X2 - t(pert2)).contiguous()
    # dt such that max|u| dt / dx = 0.4 cells
    dt = t(0.4 * cfg.grid.dx / 0.5)
    params = t([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f])
    wobble = 0.3 * cfg.grid.dx * np.sin(4 * np.pi * X + rng.standard_normal())
    phis = (disc(X1s[0], X2s[0]) + t(wobble))[None].contiguous()
    # the identity map inside phis <= 0, as a rebase extrapolates it
    Xg, Yg = cfg.grid.coords(dtype=dtype, device=device)
    mask = (phis[0] <= 0.0).to(dtype)
    p_corr = 1e-3 * rng.standard_normal((Ny, Nx))
    fx, fy = 0.01 * rng.standard_normal((2, Ny, Nx))
    return cfg, dict(u=t(u), v=t(v), p=t(p), X1s=X1s, X2s=X2s, dt=dt,
                     params=params, phis=phis, Xm=Xg * mask, Ym=Yg * mask,
                     disc=disc, p_corr=t(p_corr), fx=t(fx), fy=t(fy))


def rmt_call(fn, cfg, d, **mode):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["dt"],
              phi_inits=(d["disc"],), dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t, params=d["params"],
              **mode)


def advext_call(fn, cfg, d, **mode):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["phis"], d["dt"],
              dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=cfg.num_layers,
              **mode)


def sample_mode(cfg, guarded=True):
    """The bicubic final sample's keywords: band-guarded with the step's
    default guard (GUARD_CELLS cells of the coarser spacing), or raw."""
    g = cfg.grid
    return dict(sl_interp="bicubic",
                sl_guard=GUARD_CELLS * max(g.dx, g.dy) if guarded else None)


def mode_calls(cfg, d, ccfg, cd, checked=False):
    """{MODES row: (wrapper, its plain version, a call of either)}: the
    solid blocks' new modes on kernel_inputs' operands (the band mode with
    the step's stress_band choice, w_cut = w_t and detg_clamp) and, for two
    solids, contact_kernel_inputs'; the ellipse's on kernel_inputs' and
    contact_kernel_inputs' operands made for ELLIPSE and DISC_AND_ELLIPSE
    (with ``checked`` the CHECKED rows too)."""
    band = dict(stress_w_cut=cfg.w_t, stress_clamp=cfg.detg_clamp)
    rmt = (rb.rmt_block_fused, rb.rmt_block_plain)
    adv = (rb.advext_block_fused, rb.advext_block_plain)
    ellipse = {}
    if HAS_ST:
        u = d["u"]
        at = (tuple(u.shape), u.dtype, u.device)
        ecfg, ed = kernel_inputs(*at, disc=ELLIPSE)
        pcfg, pd = contact_kernel_inputs(*at, solids=DISC_AND_ELLIPSE)
        ellipse = {
            "rmt_block, ellipse": (*rmt, lambda f: rmt_call(f, ecfg, ed)),
            "rmt_block, disc and ellipse": (*rmt, lambda f: contact_rmt_call(
                f, pcfg, pd))}
        if checked:
            ellipse.update({
                "rmt_block, ellipse bicubic": (*rmt, lambda f: rmt_call(
                    f, ecfg, ed, **sample_mode(ecfg))),
                "rmt_block, ellipse raw bicubic": (*rmt, lambda f: rmt_call(
                    f, ecfg, ed, **sample_mode(ecfg, False))),
                "rmt_block, ellipse band": (*rmt, lambda f: rmt_call(
                    f, ecfg, ed, stress_w_cut=ecfg.w_t,
                    stress_clamp=ecfg.detg_clamp)),
                "rmt_block, disc and ellipse bicubic": (
                    *rmt, lambda f: contact_rmt_call(f, pcfg, pd,
                                                     **sample_mode(pcfg)))})
    return {**ellipse,
        "rmt_block, bicubic": (*rmt, lambda f: rmt_call(
            f, cfg, d, **sample_mode(cfg))),
        "rmt_block, raw bicubic": (*rmt, lambda f: rmt_call(
            f, cfg, d, **sample_mode(cfg, False))),
        "rmt_block, band": (*rmt, lambda f: rmt_call(f, cfg, d, **band)),
        "rmt_block, two solids bicubic": (*rmt, lambda f: contact_rmt_call(
            f, ccfg, cd, **sample_mode(ccfg))),
        "advext_block, bicubic": (*adv, lambda f: advext_call(
            f, cfg, d, **sample_mode(cfg))),
        "advext_block, raw bicubic": (*adv, lambda f: advext_call(
            f, cfg, d, **sample_mode(cfg, False))),
    }


def extrap_call(fn, cfg, d):
    return fn(d["Xm"], d["Ym"], d["phis"][0], cfg.grid.dx, cfg.grid.dy,
              cfg.num_layers)


def momentum_args(cfg, d, rmt_out, eta_s):
    """The momentum operands the step builds from the block's outputs, with
    the flagship's adaptive dt (viscous-limited at N=1024; the block's
    sub-cell dt would be far past the RK4 stability bound)."""
    Hf, rho, sbxx, sbxy, sbyy = rmt_out[7:]
    mkv = (rmt_out[2][0] <= 0.0).to(Hf.dtype) * (1.0 - Hf)
    dt = compute_timestep(d["u"], d["v"], cfg.grid.dx, cfg.grid.dy, cfg.CFL,
                          cfg.dt_min_cap, cfg.mu_s, cfg.rho_s, cfg.gamma,
                          cfg.rho_f, mu_f=cfg.mu_f, eta_s=cfg.eta_s,
                          kappa=cfg.kappa)
    return (d["u"], d["v"], d["p"], sbxx, sbxy, sbyy, Hf, rho, mkv), dict(
        eta_s=eta_s, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt, mu_f=cfg.mu_f)


def contact_kernel_inputs(shape, dtype, device, seed=0,
                          solids=TOUCHING_DISCS):
    """The contact modes' inputs: kernel_inputs' velocity, pressure and dt;
    the contact configuration with the touching discs (or ``solids``) and
    rho_s = 1.2 (so gravity's force is not 0), their maps from
    make_init_state with sine waves of a tenth of the domain added: along
    x in the first (d X1/dx from 0.05 to 1.95), along x and y in the
    second (-0.2 to 2.2, det G up to 4.8), so det G leaves the clamp's
    [1/4, 4] at both ends; made in float64 and cast."""
    _, d = kernel_inputs(shape, dtype, device, seed)
    Ny, Nx = (shape, shape) if isinstance(shape, int) else shape
    cfg = dataclasses.replace(contact_config(Nx, rho_s=1.2),
                              grid=Grid(Nx=Nx, Ny=Ny, Lx=1.0, Ly=1.0))
    s = make_init_state(cfg, solids, dtype=torch.float64, device=device)
    X1, X2 = s.X1.clone(), s.X2.clone()
    # waves through 0 where the discs touch (x = 0.52), so the contact
    # force acts at every size
    k = 2.0 * math.pi / 0.1
    X1[0] = X1[0] + (0.95 / k) * torch.sin(k * (X1[0] - 0.52))
    X1[1] = X1[1] + (1.2 / k) * torch.sin(k * (X1[1] - 0.52))
    X2[1] = X2[1] + (1.2 / k) * torch.sin(k * X2[1])
    params = torch.tensor([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f],
                          dtype=dtype, device=device)
    return cfg, dict(d, X1s=X1.to(dtype).contiguous(),
                     X2s=X2.to(dtype).contiguous(), params=params,
                     solids=solids)


def contact_rmt_call(fn, cfg, d, **mode):
    return fn(d["u"], d["v"], d["X1s"], d["X2s"], d["dt"],
              phi_inits=d["solids"], dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t, params=d["params"],
              stress_clamp=cfg.two_solid_clamp, **mode)


def contact_momentum_args(cfg, d, rmt_out, eta_s):
    """The momentum operands of a contact step with gravity (g_y = -1)
    from the two-solid block's outputs: the blends, the Kelvin-Voigt mask
    of the two solids and the force (contact plus gravity), with the
    configuration's adaptive dt."""
    from pyrmt_tpu_torch.physics import body_forces

    phis, Hf, rho, sbxx, sbxy, sbyy = rmt_out[2], *rmt_out[7:]
    g = cfg.grid
    H = smoothed_heaviside(phis, cfg.w_t)
    mkv = torch.sum((phis <= 0.0).to(Hf.dtype) * (1.0 - H), dim=0)
    fx, fy = body_forces(phis, rho, g.dx, g.dy, gamma=0.0, k_rep=cfg.k_rep,
                         w_c=cfg.w_c, w_t=cfg.w_t, g_y=-1.0,
                         g_rho_ref=cfg.rho_f)
    dt = compute_timestep(d["u"], d["v"], g.dx, g.dy, cfg.CFL,
                          cfg.dt_min_cap, cfg.mu_s, cfg.rho_s, cfg.gamma,
                          cfg.rho_f, mu_f=cfg.mu_f, eta_s=eta_s,
                          kappa=cfg.kappa)
    return (d["u"], d["v"], d["p"], sbxx, sbxy, sbyy, Hf, rho, mkv), dict(
        eta_s=eta_s, dx=g.dx, dy=g.dy, dt=dt, mu_f=cfg.mu_f, f_ext_x=fx,
        f_ext_y=fy)


def stencil_args(cfg, d, rmt_out, fields, dt):
    """The operands of the projection kernels and of the one RHS, from
    ``momentum_args``' fields and dt: the velocity as a*, b*, a density
    1 .. 1.3 across the disc's interface (the flagship's is 1 everywhere);
    rc_rhs's (a*, b*, p_prev, rho, dt, d_scalar), grad_correct's (p_corr,
    a*, b*, rho, dt) and velocity_rhs's full argument list."""
    Hf = rmt_out[7]
    rho = 1.0 + 0.3 * (1.0 - Hf)
    g = cfg.grid
    u, v, p = d["u"], d["v"], d["p"]
    rc = (u, v, p, rho, dt, dt / rho.mean())
    gc = (d["p_corr"], u, v, rho, dt)
    rhs = (*fields[:6], g.dx, g.dy, cfg.mu_f, Hf, rho, d["fx"], d["fy"])
    return rc, gc, rhs


def max_errs(a, b):
    """(max-abs, max |b|) of two tensors."""
    return float((a - b).abs().max()), float(b.abs().max())


def check_close(what, err, scale, f64, tol_f32):
    """float64: max-abs <= TOL_F64; float32: max-abs <= tol_f32 times
    max(1, max |plain|). Prints the line and raises past the bound."""
    bound = TOL_F64 if f64 else tol_f32 * max(1.0, scale)
    print(f"[kernels] {what}: max_abs={err:.3e} "
          f"max_rel={err / max(scale, 1e-300):.3e} (bound {bound:.3g})")
    if not err <= bound:
        raise AssertionError(f"{what} differs by {err:.3e} > {bound:.3g}")


def compare_kernels(shape, dtype, device, disc=FLAGSHIP_DISC, modes=True):
    """The kernels against their plain versions on the same tensors (the
    momentum and stencil kernels for the flagship disc only; the solid
    blocks' modes and the contact configuration's with ``modes``). Returns
    {kernel: max-abs over its outputs}; raises past the tolerance."""
    f64 = dtype == torch.float64
    cfg, d = kernel_inputs(shape, dtype, device, disc=disc)
    g = cfg.grid
    tag = (f"N={g.Nx}" if g.Nx == g.Ny else f"{g.Ny}x{g.Nx}") + \
        f" {str(dtype)[6:]}" + ("" if disc == FLAGSHIP_DISC else " edge disc")
    worst = {}

    def hold(name, outs, kern, plain, tol_f32=TOL_F32_RMT, row=None):
        torch.cuda.synchronize()
        for out_name, a, b in zip(outs, kern, plain):
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"plain {name} {out_name} is not finite")
            err, scale = max_errs(a, b)
            check_close(f"{tag} {row or name} {out_name}", err, scale, f64,
                        tol_f32)
            for key in (name, row):
                if key is not None:
                    worst[key] = max(worst.get(key, 0.0), err)

    plain = rmt_call(rb.rmt_block_plain, cfg, d)
    hold("rmt_block", OUT_NAMES, rmt_call(rb.rmt_block_fused, cfg, d), plain)
    hold("advext_block", ("X1e", "X2e"),
         advext_call(rb.advext_block_fused, cfg, d),
         advext_call(rb.advext_block_plain, cfg, d))
    # the new modes of both solid blocks
    if modes:
        ccfg, cd = contact_kernel_inputs(shape, dtype, device)
        for row, (kern, ref, call) in mode_calls(cfg, d, ccfg, cd,
                                                 checked=True).items():
            kernel = MODES.get(row) or CHECKED[row]
            outs = OUT_NAMES if kernel == "rmt_block" else ("X1e", "X2e")
            hold(kernel, outs, call(kern), call(ref), row=row)
    hold("extrapolate_fused", ("X1e", "X2e"),
         extrap_call(ef.extrapolate_reference_map_fused, cfg, d),
         extrap_call(extrapolate_reference_map, cfg, d))
    if disc != FLAGSHIP_DISC:
        return worst
    dx, dy = cfg.grid.dx, cfg.grid.dy
    fields, mkw = momentum_args(cfg, d, plain, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain, fields, mkw["dt"])
    hold("rc_rhs", ("rhs",), [ps.rc_rhs_fused(*rc, dx, dy)],
         [ps.rc_rhs_plain(*rc, dx, dy)], TOL_F32_MOMENTUM)
    for bc_name, bc in (("lid", make_lid_bc(1.0)),
                        ("free_slip", free_slip_box_bc), ("noop", noop_bc)):
        hold("grad_correct", (f"a {bc_name}", f"b {bc_name}"),
             ps.grad_correct_fused(*gc, dx, dy, bc),
             ps.grad_correct_plain(*gc, dx, dy, bc), TOL_F32_MOMENTUM)
    hold("velocity_rhs", ("rhs_u", "rhs_v"),
         mr.velocity_rhs_blended_fused(*rhs), velocity_rhs_blended(*rhs),
         TOL_F32_MOMENTUM)
    worst["momentum_rk4"] = 0.0

    def hold_momentum(what, args, bc, kw):
        ref = momentum_core(*args, bc, **kw)
        out = mk.momentum_rk4_fused(*args, bc, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("u_new", "v_new"), out, ref):
            err, scale = max_errs(a, b)
            check_close(f"{tag} {what} {name}", err, scale, f64,
                        TOL_F32_MOMENTUM)
            worst["momentum_rk4"] = max(worst["momentum_rk4"], err)

    for bc_name, bc, eta_s in (("lid", make_lid_bc(1.0), cfg.eta_s),
                               ("free_slip", free_slip_box_bc, 0.0),
                               ("noop", noop_bc, cfg.eta_s)):
        args, kw = momentum_args(cfg, d, plain, eta_s)
        hold_momentum(f"momentum_rk4 {bc_name} eta_s={eta_s}", args, bc, kw)
    if not modes:
        return worst

    # the contact configuration's modes: two solids with the clamp, and
    # the force of contact and gravity
    cplain = contact_rmt_call(rb.rmt_block_plain, ccfg, cd)
    hold("rmt_block", [f"two solids {n}" for n in OUT_NAMES],
         contact_rmt_call(rb.rmt_block_fused, ccfg, cd), cplain)
    for eta_s in (0.0, 0.01):
        args, kw = contact_momentum_args(ccfg, cd, cplain, eta_s)
        hold_momentum(f"momentum_rk4 force free_slip eta_s={eta_s}", args,
                      free_slip_box_bc, kw)
    return worst


def time_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(N, device, reps=20):
    """Kernel and plain times at the flagship's N and float32, in turns
    (plain, kernel, kernel, plain); each reported time is the mean of its
    two turns."""
    cfg, d = kernel_inputs(N, torch.float32, device)
    plain_out = rmt_call(rb.rmt_block_plain, cfg, d)
    args, kw = momentum_args(cfg, d, plain_out, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain_out, args, kw["dt"])
    dx, dy = cfg.grid.dx, cfg.grid.dy
    bc = make_lid_bc(1.0)
    pairs = {
        "rmt_block": (lambda: rmt_call(rb.rmt_block_fused, cfg, d),
                      lambda: rmt_call(rb.rmt_block_plain, cfg, d)),
        "momentum_rk4": (lambda: mk.momentum_rk4_fused(*args, bc, **kw),
                         lambda: momentum_core(*args, bc, **kw)),
        "advext_block": (lambda: advext_call(rb.advext_block_fused, cfg, d),
                         lambda: advext_call(rb.advext_block_plain, cfg, d)),
        "extrapolate_fused": (
            lambda: extrap_call(ef.extrapolate_reference_map_fused, cfg, d),
            lambda: extrap_call(extrapolate_reference_map, cfg, d)),
        "rc_rhs": (lambda: ps.rc_rhs_fused(*rc, dx, dy),
                   lambda: ps.rc_rhs_plain(*rc, dx, dy)),
        "grad_correct": (lambda: ps.grad_correct_fused(*gc, dx, dy, bc),
                         lambda: ps.grad_correct_plain(*gc, dx, dy, bc)),
        "velocity_rhs": (lambda: mr.velocity_rhs_blended_fused(*rhs),
                         lambda: velocity_rhs_blended(*rhs)),
    }
    pargs, pkw = periodic_momentum_args(cfg, d, plain_out, cfg.eta_s, False)
    pairs["momentum_rk4_periodic"] = (
        lambda: mk.momentum_rk4_fused(*pargs, bcs.periodic_bc, **pkw),
        lambda: momentum_core(*pargs, bcs.periodic_bc, **pkw))
    ccfg, cd = contact_kernel_inputs(N, torch.float32, device)
    for row, (kern, ref, call) in mode_calls(cfg, d, ccfg, cd).items():
        pairs[row] = (lambda k=kern, c=call: c(k), lambda r=ref, c=call: c(r))
    times = {}
    for name, (kernel, plain) in pairs.items():
        p1 = time_ms(plain, reps)
        k1 = time_ms(kernel, reps)
        k2 = time_ms(kernel, reps)
        p2 = time_ms(plain, reps)
        times[name] = (0.5 * (k1 + k2), 0.5 * (p1 + p2))
        print(f"[timing] N={N} float32 {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")
    return times


def time_backward(N, device, times, reps=3):
    """{kernel: device ms of one call's backward through its Function} at
    N float32: the CUDA-event time of the wrapper's forward on inputs that
    require gradients plus ``torch.autograd.backward`` of its outputs (the
    plain twin's forward and autograd), less the kernel's forward time of
    ``time_kernels``."""
    cfg, d = kernel_inputs(N, torch.float32, device)
    plain_out = rmt_call(rb.rmt_block_plain, cfg, d)
    args, kw = momentum_args(cfg, d, plain_out, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain_out, args, kw["dt"])
    dx, dy = cfg.grid.dx, cfg.grid.dy
    bc = make_lid_bc(1.0)

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.detach().clone().requires_grad_(True)
        return x

    dd = {k: leaf(x) for k, x in d.items()}
    args, kw = [leaf(x) for x in args], {k: leaf(x) for k, x in kw.items()}
    rc, gc, rhs = ([leaf(x) for x in t] for t in (rc, gc, rhs))
    calls = {
        "rmt_block": lambda: rmt_call(rb.rmt_block_fused, cfg, dd),
        "momentum_rk4": lambda: mk.momentum_rk4_fused(*args, bc, **kw),
        "advext_block": lambda: advext_call(rb.advext_block_fused, cfg, dd),
        "extrapolate_fused": lambda: extrap_call(
            ef.extrapolate_reference_map_fused, cfg, dd),
        "rc_rhs": lambda: ps.rc_rhs_fused(*rc, dx, dy),
        "grad_correct": lambda: ps.grad_correct_fused(*gc, dx, dy, bc),
        "velocity_rhs": lambda: mr.velocity_rhs_blended_fused(*rhs),
    }
    out = {}
    for name, call in calls.items():
        def fwd_bwd(call=call):
            o = call()
            o = (o,) if isinstance(o, torch.Tensor) else tuple(o)
            torch.autograd.backward(o, [torch.ones_like(x) for x in o])

        ms = time_ms(fwd_bwd, reps)
        out[name] = ms - times[name][0]
        print(f"[backward] N={N} float32 {name}: forward and backward "
              f"through its Function {ms:.3f} ms (CUDA events, {reps} "
              f"calls), the backward (the plain twin's forward and "
              f"autograd) {out[name]:.3f} ms against the kernel's "
              f"{times[name][0]:.4f} ms forward")
    return out


def profile_groups(groups):
    """Run each (name, fn) of groups in order inside one torch.profiler
    session, with a short spin kernel before each group and after the last
    one; returns {name: the device-side events (kernels, copies) of its
    group}. One session for everything: on the card's machine the profiler
    saw no device work after a few sessions in one process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, fn in groups:
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = sum("spin_kernel" in e.name for e in events)
    if marks not in (len(groups), len(groups) + 1):
        raise AssertionError(f"torch.profiler saw {marks} of the "
                             f"{len(groups) + 1} group marks")
    out = {name: [] for name, _ in groups}
    k = len(groups) + 1 - marks  # 1 where the first mark was not recorded
    for e in events:
        if "spin_kernel" in e.name:
            k += 1
        elif 0 < k <= len(groups):
            out[groups[k - 1][0]].append(e)
    return out


def busy_us(events):
    return sum(e.time_range.elapsed_us() for e in events)


def kernel_calls(N, device):
    """{kernel: a call of its wrapper} on operands made at N float32."""
    cfg, d = kernel_inputs(N, torch.float32, device)
    plain_out = rmt_call(rb.rmt_block_plain, cfg, d)
    args, kw = momentum_args(cfg, d, plain_out, cfg.eta_s)
    rc, gc, rhs = stencil_args(cfg, d, plain_out, args, kw["dt"])
    dx, dy = cfg.grid.dx, cfg.grid.dy
    bc = make_lid_bc(1.0)
    far = dict(d, X1s=torch.full_like(d["X1s"], 5.0),
               X2s=torch.full_like(d["X2s"], 5.0))
    far["phis"] = d["disc"](far["X1s"], far["X2s"])
    contact = {}
    if HAS_CONTACT:
        ccfg, cd = contact_kernel_inputs(N, torch.float32, device)
        cplain = contact_rmt_call(rb.rmt_block_plain, ccfg, cd)
        cargs, ckw = contact_momentum_args(ccfg, cd, cplain, 0.0)
        contact = {
            "rmt_block, two solids": lambda: contact_rmt_call(
                rb.rmt_block_fused, ccfg, cd),
            "momentum_rk4, force": lambda: mk.momentum_rk4_fused(
                *cargs, free_slip_box_bc, **ckw),
        }
    periodic = {}
    if HAS_PERIODIC:
        from pyrmt_tpu_torch.ops.poisson import (
            precompute_poisson_eigenvalues_periodic,
            solve_poisson_fft,
        )

        pargs, pkw = periodic_momentum_args(cfg, d, plain_out, cfg.eta_s,
                                            False)
        eig = precompute_poisson_eigenvalues_periodic(N, N, dx, dy,
                                                      torch.float32, device)
        rhs_fft = 1e3 * overlap(d["p_corr"])
        periodic = {
            "momentum_rk4_periodic": lambda: mk.momentum_rk4_fused(
                *pargs, bcs.periodic_bc, **pkw),
            "solve_poisson_fft": lambda: solve_poisson_fft(rhs_fft, eig),
        }
    modes = {}
    if HAS_BICUBIC:
        ccfg, cd = contact_kernel_inputs(N, torch.float32, device)
        modes = {row: (lambda k=kern, c=call: c(k)) for row, (kern, _, call)
                 in mode_calls(cfg, d, ccfg, cd).items()}
    if HAS_OFFSETS and 2 * N == OFFSET_N:
        modes.update({row: kern for row, (kern, _) in
                      offset_slab_calls(device).items()})
    return {
        "rmt_block": lambda: rmt_call(rb.rmt_block_fused, cfg, d),
        # the map far from the disc everywhere: every tile takes the skip
        "rmt_block, every tile skipping": lambda: rmt_call(
            rb.rmt_block_fused, cfg, far),
        "momentum_rk4": lambda: mk.momentum_rk4_fused(*args, bc, **kw),
        "advext_block": lambda: advext_call(rb.advext_block_fused, cfg, d),
        "extrapolate_fused": lambda: extrap_call(
            ef.extrapolate_reference_map_fused, cfg, d),
        "rc_rhs": lambda: ps.rc_rhs_fused(*rc, dx, dy),
        "grad_correct": lambda: ps.grad_correct_fused(*gc, dx, dy, bc),
        "velocity_rhs": lambda: mr.velocity_rhs_blended_fused(*rhs),
        # the map and phi far from the disc everywhere: every tile skips
        "advext_block, every tile skipping": lambda: advext_call(
            rb.advext_block_fused, cfg, far),
        # phi > 0 everywhere, no known cell: every tile copies
        "extrapolate_fused, every tile skipping": lambda: extrap_call(
            ef.extrapolate_reference_map_fused, cfg, far),
        **contact,
        **periodic,
        **modes,
    }


def step_groups(device, steps=20, warmup=10):
    """(name, fn) groups of `steps` steps each at N=1024 float32: the
    flagship, with the projection's stencil kernels, with both opt-in
    switches, the split tier (area fix + PDE reinit), the contact
    configuration, the bicubic and band modes, the capillary drop and the
    density contrast, the general tier's three configurations, the
    flagship on the periodic box and the pure-fluid lid cavity (on the RK4
    kernel and with momentum_method='xla'), each after warm-up steps."""
    groups = []
    kw = dict(dtype=torch.float32, device=device)
    flag = ((FLAGSHIP_DISC,), make_lid_bc(1.0),
            lambda cfg: make_init_state(cfg, (FLAGSHIP_DISC,), **kw))
    configs = [
        ("flagship", flagship(1024), *flag),
        ("flagship proj", flagship(1024, projection_method="pallas"), *flag),
        ("flagship rhs", flagship(1024, **BOTH_SWITCHES), *flag),
        ("split", flagship(1024, phi_area_fix=True, reinit_method="pde"),
         *flag)]
    if HAS_CONTACT:
        configs.append((
            "contact", contact_config(1024), CONTACT_DISCS, free_slip_box_bc,
            lambda cfg: contact_state(cfg, CONTACT_DISCS, **kw)))
    if HAS_BICUBIC:
        configs += [(name, flagship(1024, **over), *flag)
                    for name, over in NEW_CONFIGS.items()]
    if HAS_ST:
        for name in ST_CONFIGS:
            cfg, bc, shapes, state = st_case(name, 1024, **kw)
            configs.append((name, cfg, shapes, bc, lambda cfg, s=state: s))
    if HAS_GENERAL:
        configs += [(f"general {name}", flagship(1024, **over), *flag)
                    for name, over in GENERAL_CONFIGS.items()]
    if HAS_PERIODIC:
        configs.append((
            "periodic", flagship(1024, bc_type="periodic"), (FLAGSHIP_DISC,),
            bcs.periodic_bc, lambda cfg: periodic_state(cfg, **kw)))
        for tag, over in (("lid fluid", {}),
                          ("lid fluid xla", dict(momentum_method="xla"))):
            cfg, bc, state = fluid_case("lid", 1024, **kw, **over)
            configs.append((tag, cfg, (), bc, lambda cfg, s=state: s))
    for name, cfg, discs, bc, init in configs:
        step = make_step(cfg, bc, discs, **kw)
        box = [init(cfg)]

        def run(step=step, box=box, n=steps):
            for _ in range(n):
                box[0], _ = step(box[0], 8.0)

        run(n=warmup)
        groups.append((name, run))
    return groups


def profile_all(device, sizes=(1024, 4096), reps=20):
    """One profiler session: each kernel's wrapper once (its device kernels
    per call) and reps times (its device time per call) at each size, and
    the step groups. Returns ({N: {kernel: (device us per call,
    device kernels per call)}}, {step group: (kernels per step, copies
    per step, device-busy ms per step, extrapolate_fused's device kernels
    per step, their device ms per step)})."""
    groups, calls_at = [], {}
    for N in sizes:
        calls = calls_at[N] = kernel_calls(N, device)
        for name, fn in calls.items():
            fn()  # builds and warms up
            groups.append(((N, name, "one"), fn))
            groups.append(((N, name, "reps"),
                           lambda f=fn: [f() for _ in range(reps)]))
    steps = step_groups(device)
    ev = profile_groups(groups + steps)
    kern = {N: {} for N in sizes}
    own_kernel = dict(OWN_KERNEL, **{row: part for row, (_, part)
                                     in OFFSET_ROWS.items()})
    for N in sizes:
        for name in calls_at[N]:
            one, many = ev[(N, name, "one")], ev[(N, name, "reps")]
            extra = ""
            if name in own_kernel:
                own = own_kernel[name]
                others = sum(own not in e.name for e in one)
                one = [e for e in one if own in e.name]
                many = [e for e in many if own in e.name]
                extra = (f" (its wrapper also ran {others} PyTorch kernels "
                         f"or copies per call, not counted)")
            kern[N][name] = (busy_us(many) / reps, len(one))
            b, by = bound_us(name, N)
            us = kern[N][name][0]
            print(f"[profile] N={N} float32 {name}: {us:.2f} us of device "
                  f"time per call (torch.profiler, {reps} calls), "
                  f"{len(one)} device kernels per call, {len(many) / reps:g} "
                  f"over the reps{extra}; bound {b:.2f} us ({by}), "
                  f"{100 * b / us:.0f}% of it")
    step_prof = {}
    for name, _ in steps:
        e = ev[name]
        copies = sum(x.name.startswith(("Memcpy", "Memset")) for x in e)
        extrap = [x for x in e if EXTRAP_KERNEL in x.name]
        step_prof[name] = ((len(e) - copies) / 20, copies / 20,
                           busy_us(e) / 20 / 1e3, len(extrap) / 20,
                           busy_us(extrap) / 20 / 1e3)
    return kern, step_prof


def profile_line(prof, wall, steps):
    kernels, copies, busy = prof[:3]
    ms = 1e3 * wall / steps
    return (f"profile: {kernels:g} kernels + {copies:g} copies per step, "
            f"device busy {busy:.3f} ms/step (torch.profiler, 20 steps), "
            f"idle share {1 - busy / ms:.2f} of the timed {ms:.3f} ms/step")


def reset_counts():
    rb.launches = rb.advext_launches = mk.launches = ef.launches = 0
    ps.rc_rhs_launches = ps.grad_correct_launches = mr.launches = 0
    mk.periodic_launches = 0


def counts():
    return {"rmt_block": rb.launches, "momentum_rk4": mk.launches,
            "momentum_rk4_periodic": mk.periodic_launches,
            "advext_block": rb.advext_launches,
            "extrapolate_fused": ef.launches,
            "rc_rhs": ps.rc_rhs_launches,
            "grad_correct": ps.grad_correct_launches,
            "velocity_rhs": mr.launches}


def expected_launches(**launches):
    """The launch counts of a run: the named ones, 0 for the rest."""
    return {name: launches.get(name, 0) for name in KERNELS}


def step_without_sync(step, state, t_end):
    """One step under PyTorch's sync debug mode, which raises on a call
    that waits for the card. The variable-density CG's stopping test is
    the one read allowed (``ops.poisson._host_read``, once every
    ``CG_READ_EVERY`` iterations, counted in ``poisson.cg_host_reads``):
    the mode is lifted around it alone."""
    host_read = poisson._host_read

    def allowed_read(flag):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return host_read(flag)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    poisson._host_read = allowed_read
    try:
        return step(state, t_end)
    finally:
        poisson._host_read = host_read
        torch.cuda.set_sync_debug_mode("default")


def run_flagship(N, device, warmup, steps, **overrides):
    """make_init_state, then run_timed. Returns (cfg, state, aux, launches,
    seconds, sum of dts, t before the timed steps)."""
    cfg = flagship(N, **overrides)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (FLAGSHIP_DISC,), dtype=torch.float32,
                     device=device)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), dtype=torch.float32,
                            device=device)
    return (cfg, *run_timed(step, state, device, warmup, steps))


def run_timed(step, state, device, warmup, steps, t_end=8.0, stats=None):
    """Warm-up steps, one step that must not synchronise with the host,
    then timed steps with the launch counts reset just before. Returns
    (state, aux, launches, seconds, sum of dts, t before the timed
    steps); with variable density ``stats`` (a dict) receives the CG's
    iterations and host reads per timed step."""
    for _ in range(warmup):
        state, aux = step(state, t_end)
    state, aux = step_without_sync(step, state, t_end)
    t0 = state.t.double()
    dt_sum = torch.zeros((), dtype=torch.float64, device=device)
    cg_sum = torch.zeros((), dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    reset_counts()
    poisson.cg_host_reads = 0
    wall = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, t_end)
        dt_sum += aux["dt"].double()
        if "cg_iters" in aux:
            cg_sum += aux["cg_iters"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    if stats is not None:
        stats.update(cg_iters=int(cg_sum) / steps,
                     host_reads=poisson.cg_host_reads / steps)
    return state, aux, counts(), wall, dt_sum, t0


def run_collision(N, device, t_end=0.6, chunk=500):
    """The head-on collision at N float32 from t = 0 to t_end, in chunks of
    steps with one host read of t after each: the least distance of the
    two solids' centroids (the phi <= 0 cells) and the least J, over every
    active step (a no-op step's aux is its discarded trial step), kept on
    the card. Returns (gap, min J, steps, seconds, launches)."""
    cfg = contact_config(N)
    kw = dict(dtype=torch.float32, device=device)
    step = make_step(cfg, free_slip_box_bc, CONTACT_DISCS, **kw)
    state = contact_state(cfg, CONTACT_DISCS, **kw)
    X, _ = cfg.grid.coords(**kw)
    inf = torch.full((), math.inf, **kw)
    gap, min_J = inf, inf
    n = 0
    reset_counts()
    wall = time.perf_counter()
    while float(state.t) < t_end and n < 100 * chunk:
        for _ in range(chunk):
            state, aux = step(state, t_end)
            m = (aux["phis"] <= 0.0).to(torch.float32)
            cx = (m * X).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)
            active = aux["dt"] > 0.0
            gap = torch.minimum(gap, torch.where(active, cx[1] - cx[0], inf))
            min_J = torch.minimum(min_J, torch.where(active, aux["J"].min(),
                                                     inf))
        n += chunk
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    if not float(state.t) >= t_end * (1 - 1e-6):
        raise AssertionError(f"the collision reached t = {float(state.t)}")
    for name in ("u", "v", "p", "X1", "X2"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"collision: state.{name} is not finite")
    if bool(diverged(state)):
        raise AssertionError("collision: the run diverged")
    return float(gap), float(min_J), int(state.step), wall, counts()


def check_state(state, aux, what):
    """Finite, not diverged, min J over the solid in (0.5, 2) (None with
    no solid)."""
    for name in ("u", "v", "p", "X1", "X2"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{what}: state.{name} is not finite")
    if bool(diverged(state)):
        raise AssertionError(f"{what}: the run diverged")
    if aux["J"].numel() == 0:
        return None
    min_J = float(aux["J"][aux["phis"] <= 0.0].min())
    if not 0.5 < min_J < 2.0:
        raise AssertionError(f"{what}: min J over the solid is {min_J}")
    return min_J


def check_run(what, state, aux, launches, expect, dt_sum, t0):
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, expected {expect}")
    min_J = check_state(state, aux, what)
    advanced = float(state.t.double() - t0)
    if not abs(advanced - float(dt_sum)) <= 1e-4 * max(advanced, 1e-6):
        raise AssertionError(
            f"{what}: t advanced by {advanced}, the dts sum to "
            f"{float(dt_sum)}")
    return min_J, advanced


def run_rebase(N, device, chunk=50, post_steps=20):
    """The rebasing runner at full width: one pre-rebase step under sync
    debug, one chunk, a rebase forced on the solid, post-rebase steps."""
    cfg = flagship(N, map_rebase_minj=0.5)
    g = cfg.grid
    bc = make_lid_bc(1.0)
    kw = dict(dtype=torch.float32, device=device)
    runner = make_rebase_runner(cfg, bc, (FLAGSHIP_DISC,), chunk, **kw)
    state = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)
    t_end = 8.0
    state, _ = step_without_sync(runner.pre_step, state, t_end)
    state, _ = runner(state, t_end)
    if runner.post:
        raise AssertionError("the pre-rebase chunk triggered a rebase")
    min_J_pre = float(runner.min_J(state)[0])

    phi = FLAGSHIP_DISC(state.X1[0], state.X2[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    reinitialize_phi_fsm(phi, g.dx, g.dy)
    torch.cuda.synchronize()
    fsm_s = time.perf_counter() - t

    phis0_before = state.phis0.clone()
    reset_counts()
    t = time.perf_counter()
    state = runner.rebase(state, [True])
    torch.cuda.synchronize()
    rebase_s = time.perf_counter() - t
    rebase_counts = counts()
    if rebase_counts["extrapolate_fused"] != 1 or not runner.post:
        raise AssertionError(f"the forced rebase launched {rebase_counts}")
    if torch.equal(state.phis0, phis0_before):
        raise AssertionError("the rebase left phis0 as it was")
    J = solid_cauchy_stress(state.X1[0], state.X2[0], g.dx, g.dy, cfg.mu_s,
                            cfg.kappa, state.phis0[0])[3]
    inner = state.phis0[0] < -3.0 * g.dx
    J_err = float((J[inner] - 1.0).abs().max())
    if not J_err <= 1e-4:
        raise AssertionError(f"J after the rebase is {J_err} off 1")

    reset_counts()
    fired = []
    t = time.perf_counter()
    for _ in range(post_steps):
        state, aux = runner.post_step(state, t_end)
        fired.append(aux["rebased"])
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t
    post_counts = counts()
    if bool(torch.stack(fired).any()) or post_counts["extrapolate_fused"]:
        raise AssertionError(f"a post-rebase step rebased: {post_counts}")
    if post_counts["advext_block"] != post_steps:
        raise AssertionError(f"post-rebase launches {post_counts}")
    min_J_post = check_state(state, aux, "post-rebase")
    return dict(min_J_pre=min_J_pre, fsm_s=fsm_s, rebase_s=rebase_s,
                J_err=J_err, min_J_post=min_J_post, post_s=post_s,
                launches=rebase_counts["extrapolate_fused"])


def compare_paths(N, device, steps=3, contact=False, case=None, bc=None,
                  shapes=None, solid=None, min_cells=None, **overrides):
    """A few float64 steps through the kernels and through the plain
    versions from the same state: the flagship with overrides (and ``bc``
    or ``shapes`` in place of its own), or with ``contact`` the contact
    configuration with the touching discs (the contact force acts from the
    first step; or ``shapes``), or the ``case`` 'periodic' (the flagship
    on the periodic box with bench.py --periodic's seed), 'lid' or 'tg'
    (no solid: ``fluid_case``), 'capillary' (``capillary_config`` with
    ``shapes``, a swirl) or 'density' (the density-contrast disc); returns
    the max-abs differences, the kernel path's launches and its step's
    paths. ``solid`` is the solid block's path the step must take;
    ``min_cells`` a displacement (max |u| dt / dx, in cells) that some
    step's backtrace must pass."""
    kw = dict(dtype=torch.float64, device=device)
    if contact:
        cfg = contact_config(N, **overrides)
        bc, discs = free_slip_box_bc, shapes or TOUCHING_DISCS
        s_k = contact_state(cfg, discs, **kw)
    elif case == "capillary":
        cfg = capillary_config(N, **overrides)
        bc, discs = free_slip_box_bc, shapes
        s_k = swirl_state(cfg, discs, **kw)
    elif case == "density":
        from pyrmt_tpu_torch import validation

        cfg = dataclasses.replace(validation.density_contrast_config(N),
                                  **overrides)
        bc, discs = free_slip_box_bc, (validation.DENSITY_DISC,)
        s_k = make_init_state(cfg, discs, **kw)
    elif case == "periodic":
        cfg = flagship(N, bc_type="periodic", **overrides)
        bc, discs = bcs.periodic_bc, (FLAGSHIP_DISC,)
        s_k = periodic_state(cfg, **kw)
    elif case is not None:
        cfg, bc, s_k = fluid_case(case, N, **kw, **overrides)
        discs = ()
    else:
        cfg = flagship(N, **overrides)
        bc, discs = bc or make_lid_bc(1.0), shapes or (FLAGSHIP_DISC,)
        s_k = make_init_state(cfg, discs, **kw)
        rng = np.random.default_rng(1)
        x = np.linspace(0.0, 1.0, N)
        X, Y = np.meshgrid(x, x)
        a, b = rng.standard_normal(2)
        s_k.u = torch.tensor(
            0.3 * a * np.sin(np.pi * X) * np.sin(np.pi * Y), **kw)
        s_k.v = torch.tensor(
            0.3 * b * np.sin(2 * np.pi * X) * np.sin(np.pi * Y), **kw)
    s_p = s_k
    step_k = make_step(cfg, bc, discs, **kw)
    step_p = make_step(cfg, bc, discs, **kw, **PLAIN_IMPLS)
    if solid is not None and step_k.paths["solid"] != solid:
        raise AssertionError(f"paths {overrides}: {step_k.paths}")
    reset_counts()
    cells = 0.0
    for _ in range(steps):
        u_max = torch.maximum(s_k.u.abs().max(), s_k.v.abs().max())
        s_k, aux = step_k(s_k, 8.0)
        s_p, _ = step_p(s_p, 8.0)
        cells = max(cells, float(u_max * aux["dt"]) / cfg.grid.dx)
    torch.cuda.synchronize()
    if min_cells is not None and not cells > min_cells:
        raise AssertionError(f"paths {overrides}: the backtrace moved "
                             f"{cells:.3f} cells, not more than {min_cells}")
    if contact:
        from pyrmt_tpu_torch.physics import external_forces

        f = external_forces(aux["phis"], None, cfg.grid.dx, cfg.grid.dy,
                            gamma=0.0, k_rep=cfg.k_rep, w_c=cfg.w_c,
                            w_t=cfg.w_t)
        if not float(f[0].abs().max()) > 0.0:
            raise AssertionError("the contact force did not act")
    errs = {k: float((getattr(s_k, k) - getattr(s_p, k)).abs().max())
            for k in ("u", "v", "p", "X1", "X2", "phis0")
            if getattr(s_k, k).numel()}
    if not all(e <= 1e-10 for e in errs.values()):
        raise AssertionError(f"kernel path vs plain path {case} {overrides}: "
                             f"{errs}")
    if case in ("periodic", "lid", "tg") and not float(
            s_k.u.abs().max()) > 0.1:
        raise AssertionError(f"paths {case}: the flow did not move")
    return errs, {k: n for k, n in counts().items() if n}, step_k.paths


def st_gates(device):
    """The JAX package's surface-tension and density-contrast gates on the
    card, with its predicates and sizes (tests/test_validation_gates.py):
    Laplace's law for the static drop at N=48 float64, 1200 steps, the
    cell CSF within 1.5e-2 and the balanced CSF with kappa* strictly
    closer; the heavy disc (ratio 10) at N=48 float64 to t = 0.25 sinking,
    with at most 100 CG iterations a step and the relative divergence
    below 0.2."""
    from pyrmt_tpu_torch import validation

    f64 = torch.float64
    reset_counts()
    csf = validation.laplace_drop(N=48, gamma=0.1, R=0.25, n_steps=1200,
                                  dtype=f64, device=device)
    bal = validation.laplace_drop(N=48, gamma=0.1, R=0.25, n_steps=1200,
                                  st_method="balanced", kappa_interface=True,
                                  dtype=f64, device=device)
    rk4 = counts()["momentum_rk4"]
    print(f"[gates] Laplace static drop N=48 float64, 1200 steps each: "
          f"cell CSF dp {csf['dp']:.6f} against gamma/R {csf['target']:g} "
          f"(rel err {csf['rel_err']:.4e} < 1.5e-2, {csf['wall_s']:.3f} s), "
          f"balanced CSF + kappa* dp {bal['dp']:.6f} (rel err "
          f"{bal['rel_err']:.4e}, below the cell CSF's; {bal['wall_s']:.3f} "
          f"s); max spurious |u| {csf['max_u']:.3e} / {bal['max_u']:.3e}; "
          f"momentum_rk4 launches {rk4}")
    if not (csf["rel_err"] < 1.5e-2 and bal["rel_err"] < csf["rel_err"]
            and rk4 == 2400):
        raise AssertionError(f"Laplace gate: {csf} {bal}")
    reset_counts()
    poisson.cg_host_reads = 0
    _, dens = validation.density_contrast(N=48, rho_ratio=10.0, t_end=0.25,
                                          dtype=f64, device=device)
    launches = counts()
    print(f"[gates] density contrast (ratio 10) N=48 float64 to t=0.25: "
          f"{dens['steps']} steps in {dens['wall_s']:.3f} s; final vc "
          f"{dens['vc_final']:.5f} (< 0: sinks), CG iterations max "
          f"{dens['cg_iters_max']:g} (< 100), mean {dens['cg_iters_mean']:.2f}"
          f"; max_div_rel {dens['max_div_rel']:.4f} (< 0.2); early "
          f"acceleration {dens['accel_early']:.4f} against the added-mass "
          f"{dens['accel_added_mass']:.4f}; min J {dens['minJ']:.4f}; "
          f"{poisson.cg_host_reads / dens['steps']:.2f} CG host reads per "
          f"step; launches rmt_block {launches['rmt_block']}, momentum_rk4 "
          f"{launches['momentum_rk4']}")
    if not (dens["vc_final"] < 0 and dens["cg_iters_max"] < 100
            and dens["max_div_rel"] < 0.2
            and launches["rmt_block"] == launches["momentum_rk4"]
            == dens["steps"]):
        raise AssertionError(f"density-contrast gate: {dens} {launches}")


def print_paths(what, path_errs, path_launches, paths):
    print(f"[paths] N=128 float64 {what}, 3 steps kernel path vs plain "
          f"path: " + ", ".join(f"{k} {e:.2e}" for k, e in path_errs.items())
          + f"; kernel path launches {path_launches}; paths {paths}")


# phase 7's surface-tension, variable-density and fault cases: {line:
# compare_paths keywords}
ST_PATHS = {
    "cell CSF, fd curvature (disc)": dict(
        case="capillary", shapes=(FLAGSHIP_DISC,), st_method="csf"),
    "balanced CSF, kappa* (disc)": dict(
        case="capillary", shapes=(FLAGSHIP_DISC,), st_kappa_interface=True),
    "balanced CSF, hf curvature, st_hf_smooth=2 (disc)": dict(
        case="capillary", shapes=(FLAGSHIP_DISC,), st_curvature="hf",
        st_hf_smooth=2),
    "capillary ellipse (fused tier)": dict(
        case="capillary", shapes=(ELLIPSE,) if HAS_ST else ()),
    "capillary ellipse, phi_area_fix (split tier)": dict(
        case="capillary", shapes=(ELLIPSE,) if HAS_ST else (),
        phi_area_fix=True),
    "density contrast (variable_rho, gravity, free slip)": dict(
        case="density"),
    "contact, a disc and an ellipse": dict(
        contact=True, shapes=DISC_AND_ELLIPSE if HAS_ST else ()),
    "flagship, lid BC without kernel_spec (F1)": dict(
        bc=lid_without_spec, projection_method="pallas"),
    "flagship shape as a rounded square (F2)": dict(
        shapes=(rounded_square,)),
}


# phase 7's general-tier cases: {line: compare_paths keywords}
GENERAL_PATHS = {
    "flagship, scheme='weno5'": dict(scheme="weno5"),
    "flagship, scheme='central2'": dict(scheme="central2"),
    "flagship, sl_local=False, bilinear": dict(sl_local=False),
    "flagship, sl_local=False, bicubic": dict(sl_local=False,
                                              sl_interp="bicubic"),
    "flagship, CFL=1.5 (the map moves more than a cell a step)": dict(
        min_cells=1.0, **CFL_RECIPE),
    "weno5 + area fix + PDE reinit": dict(
        scheme="weno5", phi_area_fix=True, reinit_method="pde"),
    "weno5, contact (touching discs)": dict(contact=True, scheme="weno5"),
    "central2, periodic flagship": dict(case="periodic", scheme="central2"),
    "weno5, rebase every step": dict(scheme="weno5", map_rebase_minj=10.0),
}


# phase 13's [grad] lines: {line: (configuration, the traced scalar,
# the kernels each step launches)}; "case" picks one of phase 7's
# configurations
GRAD_CASES = {
    "flagship": (dict(), "mu_s", dict(rmt_block=1, momentum_rk4=1)),
    "flagship, projection_method='pallas'": (
        dict(projection_method="pallas"), "mu_s",
        dict(rmt_block=1, momentum_rk4=1, rc_rhs=1, grad_correct=1)),
    "area fix (split tier)": (dict(phi_area_fix=True), "mu_s",
                              dict(advext_block=1, momentum_rk4=1)),
    "central2 (general tier)": (dict(scheme="central2"), "mu_s",
                                dict(extrapolate_fused=1, momentum_rk4=1)),
    "opt-in RHS kernel (both switches)": (
        BOTH_SWITCHES, "mu_s",
        dict(rmt_block=1, velocity_rhs=4, rc_rhs=1, grad_correct=1)),
    "density contrast (variable_rho: the CG adjoint)": (
        dict(case="density"), "mu_s", dict(rmt_block=1, momentum_rk4=1)),
    "capillary drop (balanced CSF), gamma traced": (
        dict(case="capillary"), "gamma", dict(rmt_block=1, momentum_rk4=1)),
}
# relative bounds of phase 13: kernel path vs plain path (the same
# trajectory; only the order of autograd's sums can differ), and vs a
# central difference of the kernel path's loss
GRAD_TOL_PLAIN = 1e-12
GRAD_TOL_FD = 1e-5


def energy(s):
    return torch.sum(s.u ** 2 + s.v ** 2) + torch.sum(s.p ** 2)


def grad_setup(over, N, dtype, device):
    """(cfg, bc, shapes, state) of a [grad] line: the flagship with
    overrides, the density contrast or the capillary drop, each from a
    seeded swirl so that the velocity factor's derivative is not 0."""
    over = dict(over)
    case = over.pop("case", None)
    if case == "density":
        from pyrmt_tpu_torch import validation

        cfg = validation.density_contrast_config(N)
        bc, shapes, amp = free_slip_box_bc, (validation.DENSITY_DISC,), 0.05
    elif case == "capillary":
        cfg = capillary_config(N)
        bc, shapes, amp = free_slip_box_bc, (ELLIPSE,), 0.05
    else:
        cfg = flagship(N, **over)
        bc, shapes, amp = make_lid_bc(1.0), (FLAGSHIP_DISC,), 0.3
    return cfg, bc, shapes, swirl_state(cfg, shapes, dtype, device, amp=amp)


def rollout_loss(run, state, name, theta, scale, t_end=8.0):
    """energy after ``run(state', t_end, {name: theta})``, state' the
    state with its velocity times ``scale``."""
    s = dataclasses.replace(state, u=state.u * scale, v=state.v * scale)
    return energy(run(s, t_end, {name: theta}))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def grad_case(what, device, N=128, steps=3):
    """One [grad] line: d/d(theta) and d/d(velocity factor) of the energy
    after ``steps`` float64 steps through the kernels (their Functions),
    through the plain path, and by central differences of the kernel
    path's forward. Returns ({kernel: launches}, the kernel path's largest
    relative difference from the plain path's)."""
    from pyrmt_tpu_torch import make_rollout

    over, name, per_step = GRAD_CASES[what]
    f64 = torch.float64
    cfg, bc, shapes, state = grad_setup(over, N, f64, device)
    kw = dict(dtype=f64, device=device, traced_params=(name,))
    step_k = make_step(cfg, bc, shapes, **kw)
    step_p = make_step(cfg, bc, shapes, **kw, **PLAIN_IMPLS)
    theta0 = getattr(cfg, name)

    def run_of(step):
        def run(s, t_end, params):
            for _ in range(steps):
                s, _ = step(s, t_end, params)
            return s
        return run

    def grads(run):
        th = torch.tensor(theta0, dtype=f64, device=device,
                          requires_grad=True)
        sc = torch.tensor(1.0, dtype=f64, device=device, requires_grad=True)
        L = rollout_loss(run, state, name, th, sc)
        fwd = counts()
        g = torch.autograd.grad(L, (th, sc))
        return float(L.detach()), [float(x) for x in g], fwd, counts()

    reset_counts()
    L_k, g_k, fwd, bwd = grads(run_of(step_k))
    want = expected_launches(**{k: n * steps for k, n in per_step.items()})
    if fwd != want or bwd != fwd:
        raise AssertionError(f"[grad] {what}: launches {fwd} in the forward "
                             f"(expected {want}), {bwd} after the backward")
    L_p, g_p, _, _ = grads(run_of(step_p))
    fd = []
    with torch.no_grad():
        for i, h in ((0, 1e-4 * abs(theta0)), (1, 1e-5)):
            vals = []
            for sign in (1.0, -1.0):
                th = theta0 + sign * h if i == 0 else theta0
                sc = 1.0 + sign * h if i == 1 else 1.0
                vals.append(float(rollout_loss(
                    run_of(step_k), state, name,
                    torch.tensor(th, dtype=f64, device=device),
                    torch.tensor(sc, dtype=f64, device=device))))
            fd.append((vals[0] - vals[1]) / (2 * h))
    errs_p = [rel(a, b) for a, b in zip(g_k, g_p)]
    errs_fd = [rel(a, b) for a, b in zip(g_k, fd)]
    extra = ""
    if what == "flagship":
        # make_rollout's checkpoint: the recompute launches each step's
        # kernels again, the gradient is the same
        reset_counts()
        roll = make_rollout(step_k, steps, remat=True)
        L_r, g_r, fwd_r, bwd_r = grads(roll)
        errs_p += [rel(a, b) for a, b in zip(g_r, g_k)]
        twice = {k: 2 * n for k, n in fwd_r.items()}
        if fwd_r != want or bwd_r != twice or L_r != L_k:
            raise AssertionError(f"[grad] make_rollout: launches {fwd_r}, "
                                 f"{bwd_r} after the backward")
        extra = (f"; make_rollout(remat=True) the same gradient (rel "
                 f"{max(errs_p[2:]):.1e}), its backward's recompute "
                 f"launched {sum(fwd_r.values())} kernels again")
    ok = (all(math.isfinite(g) and g != 0.0 for g in g_k) and L_k == L_p
          and max(errs_p) <= GRAD_TOL_PLAIN and max(errs_fd) <= GRAD_TOL_FD)
    print(f"[grad] N={N} float64 {what}, {steps} steps, loss {L_k:.10g}: "
          f"d/d({name}) {g_k[0]:.12g} (plain path rel {errs_p[0]:.1e}, "
          f"central difference {fd[0]:.12g} rel {errs_fd[0]:.1e}), "
          f"d/d(velocity factor) {g_k[1]:.12g} (plain rel {errs_p[1]:.1e}, "
          f"central difference rel {errs_fd[1]:.1e}); forward launches "
          f"{ {k: n for k, n in fwd.items() if n} }, backward launches 0; "
          f"paths {step_k.paths}{extra}")
    if not ok:
        raise AssertionError(f"[grad] {what}: kernels {g_k}, plain {g_p}, "
                             f"central differences {fd}")
    return {k: n for k, n in fwd.items() if n}, max(errs_p)


def grad_full_width(device, card, N=1024, steps=10, warmup=20):
    """make_diff_rollout of the flagship at N float32 over ``steps`` steps
    with mu_s traced, from a state ``warmup`` steps into the lid-driven
    flow: the loss and its gradient are finite, equal the plain-forward
    rollout's (make_rollout over the plain path), and the forward and
    backward times and the peak memory."""
    from pyrmt_tpu_torch import (
        make_diff_rollout,
        make_diff_step,
        make_rollout,
    )

    f32 = torch.float32
    cfg = flagship(N)
    bc, shapes = make_lid_bc(1.0), (FLAGSHIP_DISC,)
    kw = dict(dtype=f32, device=device)
    state = make_init_state(cfg, shapes, **kw)
    warm = make_step(cfg, bc, shapes, **kw)
    for _ in range(warmup):
        state, _ = warm(state, 8.0)
    runs = {
        "kernels": make_diff_rollout(make_diff_step(
            cfg, bc, shapes, **kw, param_names=("mu_s",)), steps,
            with_params=True),
        "plain": make_rollout(make_step(cfg, bc, shapes, **kw,
                                        traced_params=("mu_s",),
                                        **PLAIN_IMPLS), steps)}
    out = {}
    for tag, run in runs.items():
        mu = torch.tensor(cfg.mu_s, dtype=f32, device=device,
                          requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t = time.perf_counter()
        L = rollout_loss(run, state, "mu_s", mu, 1.0) * cfg.grid.dx ** 2
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t
        fwd = counts()
        t = time.perf_counter()
        (g,) = torch.autograd.grad(L, mu)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t
        out[tag] = dict(loss=float(L), grad=float(g), fwd_ms=1e3 * t_fwd /
                        steps, bwd_ms=1e3 * t_bwd / steps,
                        peak_gib=(torch.cuda.max_memory_allocated() - base)
                        / 2 ** 30, fwd=fwd, bwd=counts())
    k, p = out["kernels"], out["plain"]
    err = rel(k["grad"], p["grad"])
    want = expected_launches(rmt_block=steps, momentum_rk4=steps)
    print(f"[grad] full width: make_diff_rollout of the flagship N={N} "
          f"float32, {steps} steps, mu_s traced, on '{card}': loss "
          f"{k['loss']:.7g}, dL/dmu_s {k['grad']:.7g} (the plain-forward "
          f"make_rollout's {p['grad']:.7g}, rel {err:.2e}); forward "
          f"{k['fwd_ms']:.3f} ms/step (the kernels, autograd off), backward "
          f"{k['bwd_ms']:.3f} ms/step (the plain twin's forward and "
          f"autograd), peak memory above the state {k['peak_gib']:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); the plain-forward rollout: "
          f"forward {p['fwd_ms']:.3f} ms/step, backward {p['bwd_ms']:.3f} "
          f"ms/step (its checkpoint's recompute and autograd), peak "
          f"{p['peak_gib']:.3f} GiB; launches {k['fwd']} forward, none in "
          f"the backward (host clock, synchronised)")
    if not (math.isfinite(k["loss"]) and math.isfinite(k["grad"])
            and k["grad"] != 0.0 and err <= GRAD_TOL_FD
            and k["fwd"] == want and k["bwd"] == want
            and not any(p["fwd"].values())):
        raise AssertionError(f"[grad] full width: {out}")
    return k


def inverse_problem(device, card, N=48, n_steps=60, mu_true=0.4,
                    mu_guess=1.2, adam_steps=2):
    """examples/differentiable_fsi.py on the card: a disc in a Taylor-Green
    vortex between free-slip walls, fixed_dt 1.5e-3, float64; the observed
    flow after ``n_steps`` steps at mu_true; from mu_guess, ``adam_steps``
    Adam steps (lr 0.15) on theta (mu_s = softplus(theta)), then at most 8
    of secant iteration on dL/dtheta, through make_diff_rollout with mu_s
    traced: at most 10 gradient evaluations in all. Returns the recovered
    mu_s."""
    from pyrmt_tpu_torch import make_diff_rollout, make_diff_step

    f64 = torch.float64
    cfg = RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=mu_true, mu_f=0.02,
                    rho_s=1.0, rho_f=1.0, fixed_dt=1.5e-3)
    disc = Disc(0.5, 0.5, 0.2)
    u0, v0 = tg_seed(cfg, f64, device)
    kw = dict(dtype=f64, device=device)
    state0 = make_init_state(cfg, (disc,), u0=u0, v0=v0, **kw)
    dstep = make_diff_step(cfg, free_slip_box_bc, (disc,), **kw,
                           param_names=("mu_s",))
    roll = make_diff_rollout(dstep, n_steps, with_params=True)
    area = cfg.grid.dx * cfg.grid.dy
    with torch.no_grad():
        obs = roll(state0, 1.0, {"mu_s": torch.tensor(mu_true, **kw)})

    def value_and_grad(theta):
        th = torch.tensor(theta, **kw, requires_grad=True)
        mu = torch.nn.functional.softplus(th)
        s = roll(state0, 1.0, {"mu_s": mu})
        L = torch.sum((s.u - obs.u) ** 2 + (s.v - obs.v) ** 2) * area
        (g,) = torch.autograd.grad(L, th)
        return float(L), float(mu), float(g)

    t0 = time.perf_counter()
    reset_counts()
    theta = math.log(math.expm1(mu_guess))
    m = v = 0.0
    b1, b2, lr, eps = 0.9, 0.999, 0.15, 1e-8
    trace = []
    for it in range(1, adam_steps + 1):  # Adam (optax's defaults, lr 0.15)
        L, mu, g = value_and_grad(theta)
        trace.append((mu, L))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        theta -= lr * (m / (1 - b1 ** it)) / (math.sqrt(v / (1 - b2 ** it))
                                              + eps)
    g_prev = theta_prev = None
    for _ in range(8):  # secant iteration on g(theta) = dL/dtheta
        L, mu, g = value_and_grad(theta)
        trace.append((mu, L))
        if g_prev is not None and g != g_prev:
            step = -g * (theta - theta_prev) / (g - g_prev)
        else:
            step = -0.05 * math.copysign(1.0, g)
        step = max(-0.5, min(0.5, step))
        theta_prev, g_prev = theta, g
        theta += step
        if abs(step) < 1e-10:
            break
    wall = time.perf_counter() - t0
    launches = counts()
    mu_final = float(torch.nn.functional.softplus(
        torch.tensor(theta, dtype=f64)))
    err = abs(mu_final - mu_true) / mu_true
    print(f"[inverse] examples/differentiable_fsi.py on '{card}': N={N} "
          f"float64, {n_steps} steps a rollout, mu_s from {mu_guess} to "
          f"{mu_final:.6f} (true {mu_true}, relative error {100 * err:.4f}% "
          f"< 1%) in {len(trace)} gradient evaluations, {wall:.3f} s; loss "
          f"{trace[0][1]:.3e} -> {trace[-1][1]:.3e}; launches {launches} "
          f"(one rollout's forward each, none in the backward)")
    if not (err < 0.01 and launches["rmt_block"] == n_steps * len(trace)):
        raise AssertionError(f"[inverse] mu_s {mu_final}: {trace}")
    return mu_final


def grad_step_without_sync(device):
    """One traced flagship step at N=1024 float32 with u, v and mu_s
    requiring gradients under sync-debug 'error': the kernels' Functions
    add no host read."""
    f32 = torch.float32
    cfg = flagship(1024)
    kw = dict(dtype=f32, device=device)
    step = make_step(cfg, make_lid_bc(1.0), (FLAGSHIP_DISC,), **kw,
                     traced_params=("mu_s",))
    s = make_init_state(cfg, (FLAGSHIP_DISC,), **kw)
    s, _ = step(s, 8.0, {"mu_s": torch.tensor(0.1, **kw)})
    s = dataclasses.replace(s, u=s.u.detach().requires_grad_(True),
                            v=s.v.detach().requires_grad_(True))
    mu = torch.tensor(0.1, **kw, requires_grad=True)
    out, _ = step_without_sync(lambda st, t: step(st, t, {"mu_s": mu}), s,
                               8.0)
    if out.u.grad_fn is None:
        raise AssertionError("the traced step lost its graph")
    (g,) = torch.autograd.grad(energy(out), mu)
    if not math.isfinite(float(g)):
        raise AssertionError(f"sync-debug grad step: {float(g)}")
    print(f"[grad] one traced flagship step N=1024 float32 with u, v and "
          f"mu_s requiring gradients ran under sync-debug 'error' (no host "
          f"read); its dE/dmu_s {float(g):.6g}")


def offset_halo(kernel):
    """The exchange halo of a kernel's sharded call: 4 num_layers + 4 of
    the flagship's 3 layers for the solid blocks, 8 for the RK4 kernel."""
    return 8 if kernel == "momentum_rk4" else 4 * 3 + 4


def as_outs(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def offset_cases(shape, dtype, device):
    """Phase 14a's cases on kernel_inputs' operands (and the contact
    configuration's): {name: (wrapper call, plain twin call, the whole
    fields a call takes first, the exchange halo)}, each call
    ``call(*fields, **offsets)``: rmt_block bilinear, bicubic (guarded),
    with two solids and the clamp, with the capillary drop's ellipse and
    with a disc beside an ellipse (the clamp; phase 3's ellipse operands),
    advext_block, momentum_rk4 under the lid and with the contact and
    gravity force under free slip."""
    cfg, d = kernel_inputs(shape, dtype, device)
    ccfg, cd = contact_kernel_inputs(shape, dtype, device)
    ecfg, ed = kernel_inputs(shape, dtype, device, disc=ELLIPSE)
    pcfg, pd = contact_kernel_inputs(shape, dtype, device,
                                     solids=DISC_AND_ELLIPSE)
    g = cfg.grid

    def rmt(fn, c, dd, solids, **mode):
        def call(u, v, X1s, X2s, **offs):
            return fn(u, v, X1s, X2s, dd["dt"], phi_inits=solids, dx=g.dx,
                      dy=g.dy, num_layers=c.num_layers, w_t=c.w_t,
                      params=dd["params"], **mode, **offs)
        return call

    def adv(fn):
        def call(u, v, X1s, X2s, phis, **offs):
            return fn(u, v, X1s, X2s, phis, d["dt"], dx=g.dx, dy=g.dy,
                      num_layers=cfg.num_layers, **offs)
        return call

    def mom(fn, bc, kw):
        def call(*f, **offs):
            force = (dict(f_ext_x=f[9], f_ext_y=f[10]) if len(f) > 9
                     else {})
            return fn(*f[:9], bc, **kw, **force, **offs)
        return call

    h_rmt, h_mom = offset_halo("rmt_block"), offset_halo("momentum_rk4")
    rmt_fields = [d["u"], d["v"], d["X1s"], d["X2s"]]
    plain = rmt_call(rb.rmt_block_plain, cfg, d)
    args, kw = momentum_args(cfg, d, plain, cfg.eta_s)
    cplain = contact_rmt_call(rb.rmt_block_plain, ccfg, cd)
    cargs, ckw = contact_momentum_args(ccfg, cd, cplain, 0.0)
    force = [ckw.pop("f_ext_x"), ckw.pop("f_ext_y")]
    solids = (d["disc"],)
    two = dict(stress_clamp=ccfg.two_solid_clamp)
    lid = make_lid_bc(1.0)
    pairs = (rb.rmt_block_fused, rb.rmt_block_plain)
    return {
        "rmt_block": (*(rmt(f, cfg, d, solids) for f in pairs), rmt_fields,
                      h_rmt),
        "rmt_block, bicubic": (*(rmt(f, cfg, d, solids, **sample_mode(cfg))
                                 for f in pairs), rmt_fields, h_rmt),
        "rmt_block, two solids": (
            *(rmt(f, ccfg, cd, cd["solids"], **two) for f in pairs),
            [cd["u"], cd["v"], cd["X1s"], cd["X2s"]], h_rmt),
        "rmt_block, ellipse": (
            *(rmt(f, ecfg, ed, (ELLIPSE,)) for f in pairs),
            [ed["u"], ed["v"], ed["X1s"], ed["X2s"]], h_rmt),
        "rmt_block, disc and ellipse": (
            *(rmt(f, pcfg, pd, pd["solids"],
                  stress_clamp=pcfg.two_solid_clamp) for f in pairs),
            [pd["u"], pd["v"], pd["X1s"], pd["X2s"]], h_rmt),
        "advext_block": (adv(rb.advext_block_fused),
                         adv(rb.advext_block_plain),
                         rmt_fields + [d["phis"]], h_rmt),
        "momentum_rk4": (mom(mk.momentum_rk4_fused, lid, kw),
                         mom(momentum_core, lid, kw), list(args), h_mom),
        "momentum_rk4, force": (
            mom(mk.momentum_rk4_fused, free_slip_box_bc, ckw),
            mom(momentum_core, free_slip_box_bc, ckw),
            list(cargs) + force, h_mom),
    }


def compare_offsets(shape, dtype, device, meshes=SHARD_MESHES):
    """Phase 14a: every case of ``offset_cases`` on every block of each
    of the ``meshes``, the block padded by its halo as the exchange pads it
    (zeros beyond the domain, ``parallel.sharding.slab_of``), through the
    wrapper with the block's offsets and through the plain twin with the
    same; the kernel's blocks stitched must equal the unsharded kernel bit
    for bit, and each slab (the cut's stale cells and the cells beyond the
    domain 0 in both) its plain twin's within the phase-3 bounds. Returns
    {case: (max-abs against the unsharded kernel, against the plain
    twin)}."""
    from pyrmt_tpu_torch.parallel.sharding import Mesh, slab_of

    f64 = dtype == torch.float64
    Ny, Nx = (shape, shape) if isinstance(shape, int) else shape
    tag = (f"N={Nx}" if Nx == Ny else f"{Ny}x{Nx}") + f" {str(dtype)[6:]}"
    worst = {}
    for name, (kern, plain, fields, halo) in offset_cases(
            shape, dtype, device).items():
        kernel = name.split(",")[0]
        tol = TOL_F32_MOMENTUM if kernel == "momentum_rk4" else TOL_F32_RMT
        whole = as_outs(kern(*fields))
        e_whole = e_plain = scale = 0.0
        for mesh in meshes:
            for iy in range(mesh[0]):
                for ix in range(mesh[1]):
                    slabs = [slab_of(f, mesh, (iy, ix), halo)
                             for f in fields]
                    offs = slabs[0][1]
                    ko = as_outs(kern(*(a for a, _ in slabs), **offs))
                    po = as_outs(plain(*(a for a, _ in slabs), **offs))
                    m = Mesh(mesh, (iy, ix))
                    rows, cols = m.block(Ny, Nx)
                    for k, p, w in zip(ko, po, whole):
                        e_whole = max(e_whole, float(
                            (m.unpad(k, halo) - w[..., rows, cols])
                            .abs().max()))
                        err, sc = max_errs(k, p)
                        e_plain, scale = max(e_plain, err), max(scale, sc)
        torch.cuda.synchronize()
        where = ", ".join(f"{a}x{b}" for a, b in meshes)
        print(f"[shard] {tag} {name} on the blocks of the {where} "
              f"mesh{'es' if len(meshes) > 1 else ''} with the offsets: "
              f"stitched against the unsharded kernel max-abs "
              f"{e_whole:.3e} (bit for bit expected); kernel against its "
              f"plain twin max-abs {e_plain:.3e} (max |plain| {scale:.3g})")
        if e_whole != 0.0:
            raise AssertionError(f"{tag} {name}: the stitched slabs differ "
                                 f"from the unsharded kernel by {e_whole}")
        check_close(f"{tag} {name} with offsets, kernel vs plain twin",
                    e_plain, scale, f64, tol)
        worst[name] = (e_whole, e_plain)
    return worst


def offset_slab_calls(device):
    """{OFFSET_ROWS row: (wrapper call, plain twin call)} on the (0, 0)
    block of the (2, 2) mesh of OFFSET_N float32 operands, padded by its
    halo, with its offsets: the offset instantiations' profile rows and
    times."""
    from pyrmt_tpu_torch.parallel.sharding import slab_of

    cases = offset_cases(OFFSET_N, torch.float32, device)
    out = {}
    for row, (case, _) in OFFSET_ROWS.items():
        kern, plain, fields, halo = cases[case]
        slabs = [slab_of(f, (2, 2), (0, 0), halo) for f in fields]
        args, offs = [a for a, _ in slabs], slabs[0][1]
        out[row] = (lambda k=kern, a=args, o=offs: k(*a, **o),
                    lambda p=plain, a=args, o=offs: p(*a, **o))
    return out


def time_offsets(device, reps=20):
    """{OFFSET_ROWS row: (kernel ms, plain ms)}: CUDA-event times of each
    offset instantiation and its plain twin on its slab, in turns."""
    times = {}
    for row, (kernel, plain) in offset_slab_calls(device).items():
        p1, k1, k2, p2 = (time_ms(f, reps) for f in
                          (plain, kernel, kernel, plain))
        times[row] = (0.5 * (k1 + k2), 0.5 * (p1 + p2))
        print(f"[timing] (2,2) block of N={OFFSET_N} float32 {row}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return times


def shard_case(kind, N, dtype, device):
    """(cfg, bc, shapes, initial state, t_end) of a phase 14b run: the
    flagship (at rest, the lid driving), a pure fluid in the lid cavity,
    the density contrast of phase 4e (ratio 10, g 1, CG tol 1e-6, the
    disc at rest), the capillary drop of phase 4e (the ellipse at rest,
    the balanced CSF, free slip) and its split-tier twin (the cell CSF
    with kappa* and the area fix), the split tier (the flagship with the
    area fix and PDE reinitialisation), the periodic flagship (bench.py
    --periodic: the Taylor-Green seed), the periodic Taylor-Green pure
    fluid, the 'fmm' reinitialisation, and the always-firing rebase of
    tests/test_rebase.py's sharded test (map_rebase_minj 10, a
    Taylor-Green swirl of 0.3, free slip, t_end 10)."""
    from pyrmt_tpu_torch import validation

    kw = dict(dtype=dtype, device=device)
    lid, disc = make_lid_bc(1.0), (FLAGSHIP_DISC,)
    if kind in ("flagship", "pure fluid", "split", "fmm"):
        over = {"split": dict(phi_area_fix=True, reinit_method="pde"),
                "fmm": dict(reinit_method="fmm")}.get(kind, {})
        cfg = flagship(N, **over)
        shapes = () if kind == "pure fluid" else disc
        return cfg, lid, shapes, make_init_state(cfg, shapes, **kw), 8.0
    if kind in ("density contrast", "capillary drop"):
        cfg, bc, shapes, state = st_case(kind, N, **kw)
        return cfg, bc, shapes, state, 8.0
    if kind == "capillary split":
        cfg = capillary_config(N, st_method="csf", st_kappa_interface=True,
                               phi_area_fix=True)
        return (cfg, free_slip_box_bc, (ELLIPSE,),
                make_init_state(cfg, (ELLIPSE,), **kw), 8.0)
    if kind == "periodic":
        cfg = flagship(N, bc_type="periodic")
        return cfg, bcs.periodic_bc, disc, periodic_state(cfg, **kw), 8.0
    if kind == "periodic TG":
        cfg, bc, state = fluid_case("tg", N, **kw)
        return cfg, bc, (), state, 8.0
    cfg = flagship(N, mu_s=0.05, eta_s=0.0, CFL=0.3, map_rebase_minj=10.0)
    shapes = (Disc(0.5, 0.5, 0.22),)
    return (cfg, free_slip_box_bc, shapes,
            swirl_state(cfg, shapes, dtype, device, amp=0.3), 10.0)


# phase 14b's runs: (what, kind, N, dtype, mesh, untimed steps, timed
# steps); the float32 runs at N=2048 on (2, 2), each beside a float64
# single-process run
SHARD_RUNS = (
    [("N=2048 float32 (2,2)", "flagship", 2048, torch.float32, (2, 2), 2,
      18)]
    + [(f"N=2048 float32 (2,2) {kind}", kind, 2048, torch.float32, (2, 2),
        0, 10) for kind in ("density contrast", "split", "periodic",
                            "capillary drop")]
    + [(f"N=256 float64 ({a},{b})" + ("" if kind == "flagship" else
                                        f" {kind}"), kind, 256,
        torch.float64, (a, b), 0, 3)
       for kind, meshes in (("flagship", ((2, 2), (4, 1))),
                            ("pure fluid", ((2, 2),)),
                            ("density contrast", ((2, 2), (4, 1))),
                            ("split", ((2, 2), (4, 1))),
                            ("periodic TG", ((2, 2), (4, 1))),
                            ("capillary drop", ((2, 2), (4, 1))),
                            ("capillary split", ((2, 2),)))
       for a, b in meshes]
    + [(f"N=128 float64 (2,2) {kind}", kind, 128, torch.float64, (2, 2),
        0, 3) for kind in ("fmm", "rebase")])
SPLIT_KINDS = ("split", "fmm", "rebase", "capillary split")


def shard_launches(what, kind, steps, launches):
    """Raise unless each rank launched the offset instantiation of each
    kernel of its step once a step and no other: rmt_block's on the fused
    tier, advext_block's on the split tier, momentum_rk4's under walls
    (the periodic box's momentum is the plain stage loop, as in JAX), and
    extrapolate_fused's unsharded kernel once a rebase."""
    solid = kind not in ("pure fluid", "periodic TG")
    want = {"rmt_block.offset_launches":
            steps if solid and kind not in SPLIT_KINDS else 0,
            "rmt_block.advext_offset_launches":
            steps if kind in SPLIT_KINDS else 0,
            "momentum_rk4.offset_launches":
            0 if kind.startswith("periodic") else steps,
            "extrapolate_fused.launches": steps if kind == "rebase" else 0}
    for rank, n in enumerate(launches):
        got = {k: n.get(k, 0) for k in want}
        others = {k: v for k, v in n.items() if k not in want and v}
        if got != want or others:
            raise AssertionError(f"[shard] {what}: rank {rank} launched "
                                 f"{n}, not {want} in {steps} steps")


def sharded_runs(device, card):
    """Phase 14b: the sharded step in one gloo world of SHARD_RANKS
    processes on the one card (parallel.launch.run_world; gloo: the card
    cannot host an NCCL world of more than one rank, so the halo and the
    gathers go through host copies) against the single-process
    ``make_step`` over the same steps, from the same state: each run of
    SHARD_RUNS, float32 within TOL_F32_RMT of max(1, |field|), float64
    within 1e-10 (u, v, p) and 1e-11 (X1, X2: JAX's sharding tolerances);
    the CG's iterations of each step beside the single process's (equal
    in float64, within one in float32); every rank launching each kernel
    of its step's path once a step (``shard_launches``). Beside each
    float32 run a float64 single-process run from the same state: how far
    each float32 step lies from it. Returns the runs' summaries."""
    from pyrmt_tpu_torch.io import state_from_numpy, state_to_numpy
    from pyrmt_tpu_torch.parallel.launch import run_world

    cases, starts = [], []
    for what, kind, N, dtype, mesh, warm, steps in SHARD_RUNS:
        cfg, bc, shapes, state, t_end = shard_case(kind, N, dtype, device)
        state0 = state_to_numpy(state)
        starts.append((cfg, bc, shapes, state0, t_end))
        cases.append(dict(cfg=cfg, velocity_bc=bc, phi_inits=shapes,
                          steps=steps, warmup=warm, dtype=dtype,
                          device=torch.device(device).type, mesh_shape=mesh,
                          t_end=t_end, state0=state0))
    t0 = time.perf_counter()
    results = run_world(SHARD_RANKS, "pyrmt_tpu_torch.parallel.launch:"
                        "run_sharded", dict(cases=cases), backend="gloo",
                        timeout=900.0)[0]
    world_s = time.perf_counter() - t0
    fields = ("u", "v", "p", "X1", "X2")
    summary = {}
    for (what, kind, N, dtype, mesh, warm, steps), (cfg, bc, shapes, state0,
                                                    t_end), r in zip(
            SHARD_RUNS, starts, results):
        f64 = dtype == torch.float64
        refs = {}
        for ref_dtype in (dtype,) if f64 else (dtype, torch.float64):
            kw = dict(dtype=ref_dtype, device=device)
            step = make_step(cfg, bc, shapes, **kw)
            ref = state_from_numpy(state0, **kw)
            iters = []
            for n in range(warm + steps):
                ref, aux = step(ref, t_end)
                if n >= warm and "cg_iters" in aux:
                    iters.append(int(aux["cg_iters"]))
            refs[ref_dtype] = ({k: getattr(ref, k).cpu().numpy()
                                for k in fields}, iters)
        want, iters = refs[dtype]
        errs, bounds = {}, {}
        for k in fields:
            if r["state"][k].shape != want[k].shape:
                raise AssertionError(f"[shard] {what}: {k} gathered as "
                                     f"{r['state'][k].shape}, not "
                                     f"{want[k].shape}")
            err = float(np.abs(r["state"][k] - want[k]).max(initial=0.0))
            scale = float(np.abs(want[k]).max(initial=0.0))
            bound = ((1e-11 if k in ("X1", "X2") else 1e-10) if f64
                     else TOL_F32_RMT * max(1.0, scale))
            errs[k], bounds[k] = err, (bound, scale)
            if not err <= bound:
                raise AssertionError(f"[shard] {what}: {k} differs from the "
                                     f"single-process step by {err:.3e} > "
                                     f"{bound:.3g}")
        shard_launches(what, kind, steps, r["launches"])
        if not r["finite"]:
            raise AssertionError(f"[shard] {what}: not finite")
        extra = ""
        if r["cg_iters"] is not None:
            worst = max(abs(a - b) for a, b in zip(r["cg_iters"], iters))
            if worst > (0 if f64 else 1):
                raise AssertionError(f"[shard] {what}: CG iterations "
                                     f"{r['cg_iters']} against the single "
                                     f"process's {iters}")
            extra += (f"; CG iterations a step {r['cg_iters']}, the single "
                      f"process's {iters}")
        if r["rebased"] is not None:
            if r["rebased"] != [[True]] * steps:
                raise AssertionError(f"[shard] {what}: rebased "
                                     f"{r['rebased']}, not on every step")
            extra += f"; rebased on each of the {steps} steps"
        if kind == "capillary drop":
            extra += ("; rmt_block's ellipse offset instantiation "
                      + "/".join(str(n["rmt_block.offset_launches"])
                                 for n in r["launches"])
                      + " and momentum_rk4's force offset instantiation "
                      + "/".join(str(n["momentum_rk4.offset_launches"])
                                 for n in r["launches"])
                      + f" launches over the ranks in {steps} steps")
        if kind in SPLIT_KINDS:
            extra += ("; advext_block's offset instantiation "
                      + "/".join(str(n["rmt_block.advext_offset_launches"])
                                 for n in r["launches"])
                      + f" launches over the ranks in {steps} steps")
        vs64 = {}
        if not f64:
            want64 = refs[torch.float64][0]
            vs64 = {k: (float(np.abs(r["state"][k] - want64[k]).max(
                        initial=0.0)), float(np.abs(want[k] - want64[k]).max(
                            initial=0.0))) for k in fields}
            extra += ("; against a float64 single-process step, the "
                      "sharded / single-process float32 max-abs: "
                      + ", ".join(f"{k} {a:.3e} / {b:.3e}"
                                  for k, (a, b) in vs64.items()))
            if refs[torch.float64][1]:
                extra += f" (its CG iterations {refs[torch.float64][1]})"
        ms = r["ms_per_step"]
        print(f"[shard] {what}: {SHARD_RANKS} processes sharing one card "
              f"({card}), a correctness run, not a scaling number; "
              f"{steps} timed steps after {warm}, wall "
              f"{min(ms):.1f}-{max(ms):.1f} ms/step over the ranks; "
              f"max-abs against the single-process step: "
              + ", ".join(f"{k} {e:.3e} of its bound {bounds[k][0]:.3g} "
                          f"(max |{k}| {bounds[k][1]:.4g}), "
                          f"{e / bounds[k][0]:.3g} of it"
                          for k, e in errs.items())
              + extra + f"; paths {r['paths']}")
        summary[what] = dict(errs=errs, bounds=bounds, ms_per_step=ms,
                             paths=r["paths"], launches=r["launches"],
                             steps=steps, vs_float64=vs64,
                             cg_iters=r["cg_iters"])
    print(f"[shard] the world of {SHARD_RANKS} ranks took {world_s:.1f} s "
          f"(start-up, the {len(SHARD_RUNS)} runs, the gathers)")
    return summary


def phase14(device, card):
    """Phase 14: the offset instantiations against the unsharded kernel and
    their plain twins (14a) on the blocks of every SHARD_MESHES mesh at
    N=256 float64 and N=1024 float32, and on the blocks of the (2, 2) mesh
    of OFFSET_N float32 that phase 14b's flagship gives each rank; their
    times; the sharded step (14b). Returns ({offset_cases case: (max-abs
    stitched against unsharded, against the plain twin)}, time_offsets'
    times, sharded_runs' summary)."""
    offset_errs = {}
    for shape, dtype, meshes in ((256, torch.float64, SHARD_MESHES),
                                 (1024, torch.float32, SHARD_MESHES),
                                 (OFFSET_N, torch.float32, ((2, 2),))):
        for case, e in compare_offsets(shape, dtype, device,
                                       meshes).items():
            prev = offset_errs.get(case, (0.0, 0.0))
            offset_errs[case] = tuple(map(max, prev, e))
    return offset_errs, time_offsets(device), sharded_runs(device, card)


def main() -> int:
    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phase_s = []  # (phase, host clock at its start)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    card = nvidia_smi_line()
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc[-1]}' card '{card}'")

    phase_s.append(("2", time.perf_counter()))
    # 2. build
    t = time.perf_counter()
    _build.load_all(SOURCES)
    print(f"[build] {len(SOURCES)} CUDA sources built side by side for "
          f"sm_90a in {time.perf_counter() - t:.1f} s into "
          f"{_build.build_dir()}")
    for name in SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for entry, line in ptxas_lines(log.read_text()):
                print(f"[build] {name}: {entry}: {line}")
    if PROFILE_ONLY:
        prof, step_prof = profile_all(device)
        print(json.dumps({"profile": {
            name: {f"N{N}": {"device_us": prof[N][name][0],
                             "device_launches_per_call": prof[N][name][1],
                             "bound_us": bound_us(name, N)[0]}
                   for N in prof if name in prof[N]}
            for name in prof[1024]},
            "steps": {name: dict(zip(("kernels", "copies", "busy_ms",
                                      "extrap_kernels", "extrap_busy_ms"), p))
                      for name, p in step_prof.items()},
            "root": PORT_ROOT}))
        print(card)
        return 0

    phase_s.append(("3", time.perf_counter()))
    # 3. kernel vs plain on the card
    errs = {}
    f32, f64 = torch.float32, torch.float64
    for shape, dtype, disc in (
            (256, f64, FLAGSHIP_DISC), (256, f32, FLAGSHIP_DISC),
            (256, f64, EDGE_DISC), (256, f32, EDGE_DISC),
            ((203, 301), f64, FLAGSHIP_DISC), ((203, 301), f32, FLAGSHIP_DISC),
            ((9, 300), f64, FLAGSHIP_DISC), ((33, 49), f32, FLAGSHIP_DISC),
            (1024, f32, FLAGSHIP_DISC), (4096, f32, FLAGSHIP_DISC)):
        # at N=4096 the seven kernels alone: their modes' N=1024 rows hold
        # the same code
        for name, e in compare_kernels(shape, dtype, device, disc,
                                       modes=shape != 4096).items():
            errs[name] = max(errs.get(name, 0.0), e)
    errs["momentum_rk4_periodic"] = 0.0
    for shape in (256, 65, 129, (203, 301), (9, 300), (33, 49)):
        for dtype in (f64, f32):
            errs["momentum_rk4_periodic"] = max(
                errs["momentum_rk4_periodic"],
                compare_periodic(shape, dtype, device))
    errs["momentum_rk4_periodic"] = max(
        errs["momentum_rk4_periodic"], compare_periodic(1024, f32, device))
    # extrapolate_fused on the general tier's maps
    general_s = {"maps": time.perf_counter()}
    errs["extrapolate_fused, general maps"] = 0.0
    for shape, dtype in ((256, f64), (256, f32), ((203, 301), f64),
                         ((203, 301), f32), (1024, f32)):
        errs["extrapolate_fused, general maps"] = max(
            errs["extrapolate_fused, general maps"],
            compare_general_extrap(shape, dtype, device))
    general_s["maps"] = time.perf_counter() - general_s["maps"]
    times = time_kernels(1024, device)
    backward_ms = time_backward(1024, device, times)
    prof, step_prof = profile_all(device)
    for name in (*KERNELS, *CONTACT_MODES, *MODES):
        want = DEVICE_KERNELS.get(MODES.get(name, name), 1)
        if prof[1024][name][1] != want or prof[4096][name][1] != want:
            raise AssertionError(
                f"one {name} call ran {prof[1024][name][1]:g} device "
                f"kernels at N=1024, {prof[4096][name][1]:g} at N=4096; "
                f"expected {want}")

    phase_s.append(("4-4f", time.perf_counter()))
    # 4. the flagship slice (fused tier)
    steps = 500
    _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
        1024, device, warmup=50, steps=steps)
    min_J, advanced = check_run(
        "flagship", state, aux, launches,
        expected_launches(rmt_block=steps, momentum_rk4=steps), dt_sum, t0)
    flagship_rate = steps / wall
    print(f"[slice] flagship N=1024 float32: {steps} steps in {wall:.3f} s = "
          f"{flagship_rate:.1f} steps/s, {1e3 * wall / steps:.3f} ms/step "
          f"(host clock, synchronised) on '{card}'; launches {launches}; "
          f"t advanced {advanced:.6f}; min J over the solid {min_J:.4f}; "
          + profile_line(step_prof["flagship"], wall, steps))
    main_launches = dict(launches)

    # 4b. the projection's stencil kernels; 4c. and the one-RHS kernel
    steps = 200
    for tag, overrides, per_step, reported in (
            ("proj", dict(projection_method="pallas"),
             dict(rmt_block=1, momentum_rk4=1, rc_rhs=1, grad_correct=1),
             ("rc_rhs", "grad_correct")),
            ("rhs", BOTH_SWITCHES,
             dict(rmt_block=1, velocity_rhs=4, rc_rhs=1, grad_correct=1),
             ("velocity_rhs",))):
        _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
            1024, device, warmup=20, steps=steps, **overrides)
        expected = expected_launches(**{k: n * steps
                                        for k, n in per_step.items()})
        min_J, advanced = check_run(f"flagship {overrides}", state, aux,
                                    launches, expected, dt_sum, t0)
        print(f"[{tag}] flagship {overrides} N=1024 float32: {steps} steps "
              f"in {wall:.3f} s = {steps / wall:.1f} steps/s, "
              f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
              f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
              f"launches {launches}; t advanced {advanced:.6f}; min J over "
              f"the solid {min_J:.4f}; " + profile_line(
                  step_prof[f"flagship {tag}"], wall, steps))
        for name in reported:
            main_launches[name] = launches[name]

    # 4d. the flagship with the bicubic sample and with the band-mode stress
    mode_launches = {}
    for tag, overrides in NEW_CONFIGS.items():
        _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
            1024, device, warmup=20, steps=steps, **overrides)
        min_J, advanced = check_run(
            tag, state, aux, launches,
            expected_launches(rmt_block=steps, momentum_rk4=steps), dt_sum,
            t0)
        mode_launches[tag] = launches["rmt_block"]
        print(f"[modes] {tag} {overrides} N=1024 float32: {steps} steps in "
              f"{wall:.3f} s = {steps / wall:.1f} steps/s, "
              f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
              f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
              f"launches {launches}; t advanced {advanced:.6f}; min J over "
              f"the solid {min_J:.4f}; " + profile_line(step_prof[tag], wall,
                                                       steps))

    # 4e. the coupled capillary drop and the density-contrast disc
    st_launches = {}
    for tag in ST_CONFIGS if HAS_ST else ():
        cfg, bc, shapes, state = st_case(tag, 1024, torch.float32, device)
        step = make_step(cfg, bc, shapes, dtype=torch.float32, device=device)
        stats = {}
        state, aux, launches, wall, dt_sum, t0 = run_timed(
            step, state, device, warmup=20, steps=steps, stats=stats)
        min_J, advanced = check_run(
            tag, state, aux, launches,
            expected_launches(rmt_block=steps, momentum_rk4=steps), dt_sum,
            t0)
        st_launches[tag] = launches
        what = (f"ellipse a={ELLIPSE.a:.3g} b={ELLIPSE.b:.3g}, gamma "
                f"{cfg.gamma}, {cfg.st_method} CSF"
                if tag == "capillary drop" else
                f"rho_s/rho_f {cfg.rho_s / cfg.rho_f:g}, g_y {cfg.g_y}, "
                f"variable_rho, cg_tol {cfg.cg_tol:g}")
        cg = (f"CG {stats['cg_iters']:.2f} iterations and "
              f"{stats['host_reads']:.2f} host reads per step; "
              if cfg.variable_rho else "")
        print(f"[st] {tag} ({what}, free slip) N=1024 float32: {steps} "
              f"steps in {wall:.3f} s = {steps / wall:.1f} steps/s, "
              f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
              f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
              f"launches {launches}; paths {step.paths}; t advanced "
              f"{advanced:.6f}; min J over the solid {min_J:.4f}; {cg}"
              + profile_line(step_prof[tag], wall, steps))

    # 4f. the general tier: WENO5, central2 and the gather path as plain
    # ops, each solid's extrapolation in extrapolate_fused
    steps = 100
    general = {}
    general_s["4f"] = time.perf_counter()
    for tag, overrides in GENERAL_CONFIGS.items():
        _, state, aux, launches, wall, dt_sum, t0 = run_flagship(
            1024, device, warmup=10, steps=steps, **overrides)
        min_J, advanced = check_run(
            f"general {tag}", state, aux, launches,
            expected_launches(extrapolate_fused=steps, momentum_rk4=steps),
            dt_sum, t0)
        prof_row = step_prof[f"general {tag}"]
        general[tag] = dict(launches=launches["extrapolate_fused"],
                            steps_per_s=steps / wall,
                            device_kernels_per_step=prof_row[3],
                            device_share=prof_row[4] / prof_row[2])
        print(f"[general] flagship {overrides} N=1024 float32: {steps} steps "
              f"in {wall:.3f} s = {steps / wall:.1f} steps/s, "
              f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
              f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
              f"launches {launches}; t advanced {advanced:.6f}; min J over "
              f"the solid {min_J:.4f}; extrapolate_fused {prof_row[3]:g} "
              f"device kernels and {1e3 * prof_row[4]:.2f} us per step, "
              f"{prof_row[4] / prof_row[2]:.4f} of the device-busy time; "
              + profile_line(prof_row, wall, steps))
    general_s["4f"] = time.perf_counter() - general_s["4f"]

    phase_s.append(("5", time.perf_counter()))
    # 5. the split tier at full width
    steps = 200
    cfg, state, aux, launches, wall, dt_sum, t0 = run_flagship(
        1024, device, warmup=20, steps=steps, phi_area_fix=True,
        reinit_method="pde")
    min_J, advanced = check_run(
        "split tier", state, aux, launches,
        expected_launches(momentum_rk4=steps, advext_block=steps), dt_sum, t0)
    g = cfg.grid
    X, Y = g.coords(dtype=torch.float32, device=device)
    target = float(smoothed_solid_area(FLAGSHIP_DISC(X, Y), g.dx, g.dy,
                                       cfg.w_t))
    area = float(smoothed_solid_area(aux["phis"][0], g.dx, g.dy, cfg.w_t))
    if not abs(area - target) <= 1e-4 * target:
        raise AssertionError(f"area {area} drifted from {target}")
    print(f"[split] flagship + area fix + PDE reinit N=1024 float32: "
          f"{steps} steps in {wall:.3f} s = {steps / wall:.1f} steps/s, "
          f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised) on "
          f"'{card}'; launches {launches}; t advanced {advanced:.6f}; "
          f"min J {min_J:.4f}; solid area {area:.7g} vs target {target:.7g}; "
          + profile_line(step_prof["split"], wall, steps))
    main_launches["advext_block"] = launches["advext_block"]

    phase_s.append(("6", time.perf_counter()))
    # 6. rebasing at full width
    rebase = run_rebase(1024, device)
    print(f"[rebase] flagship map_rebase_minj=0.5 N=1024 float32: 51 "
          f"pre-rebase steps (min J {rebase['min_J_pre']:.4f}); fast-sweeping "
          f"redistance {rebase['fsm_s']:.3f} s, whole forced rebase "
          f"{rebase['rebase_s']:.3f} s (host clock) on '{card}'; |J - 1| "
          f"inside {rebase['J_err']:.2e}; 20 post-rebase steps in "
          f"{rebase['post_s']:.3f} s ({1e3 * rebase['post_s'] / 20:.3f} "
          f"ms/step), none rebased, min J {rebase['min_J_post']:.4f}")

    phase_s.append(("7", time.perf_counter()))
    # 7. kernel path vs plain path
    mode_paths = {}
    for what, overrides in (
            ("flagship", {}),
            ("area fix + PDE reinit",
             dict(phi_area_fix=True, reinit_method="pde")),
            ("rebase every step", dict(map_rebase_minj=10.0)),
            ("flagship + both opt-in switches", BOTH_SWITCHES),
            ("area fix + PDE reinit + projection stencils",
             dict(phi_area_fix=True, reinit_method="pde",
                  projection_method="pallas"))):
        print_paths(what, *compare_paths(128, device, **overrides))
    for what, overrides in (
            ("contact (touching discs)", dict(contact=True)),
            ("contact + gravity, split tier (area fix)",
             dict(contact=True, g_y=-1.0, rho_s=1.2, phi_area_fix=True)),
            ("periodic flagship (bench.py --periodic)",
             dict(case="periodic")),
            ("lid-driven cavity, no solid", dict(case="lid")),
            ("periodic Taylor-Green, no solid", dict(case="tg")),
            ("flagship, bicubic sample (bench.py --bicubic)",
             dict(sl_interp="bicubic")),
            ("flagship, band-mode stress, num_layers=4",
             dict(stress_band=True, num_layers=4)),
            ("area fix, bicubic sample (split tier)",
             dict(phi_area_fix=True, sl_interp="bicubic")),
            ("periodic flagship, bicubic sample",
             dict(case="periodic", sl_interp="bicubic")),
            # the modes no timed phase runs: raw bicubic on both tiers, two
            # solids with the bicubic sample
            ("flagship, raw bicubic sample",
             dict(sl_interp="bicubic", sl_band_guard=0.0)),
            ("area fix, raw bicubic sample",
             dict(phi_area_fix=True, sl_interp="bicubic", sl_band_guard=0.0)),
            ("contact, bicubic sample",
             dict(contact=True, sl_interp="bicubic"))):
        path_errs, path_launches, paths = compare_paths(128, device,
                                                        **overrides)
        mode_paths[what] = path_launches
        print_paths(what, path_errs, path_launches, paths)
    if HAS_ST:
        for what, overrides in ST_PATHS.items():
            path_errs, path_launches, paths = compare_paths(
                128, device, **overrides)
            mode_paths[what] = path_launches
            print_paths(what, path_errs, path_launches, paths)
    general_s["paths"] = time.perf_counter()
    for what, overrides in GENERAL_PATHS.items():
        path_errs, path_launches, paths = compare_paths(
            128, device, solid="general", **overrides)
        mode_paths[what] = path_launches
        print_paths(what, path_errs, path_launches, paths)
    general_s["paths"] = time.perf_counter() - general_s["paths"]
    print(f"[general] wall seconds of the general tier's phases: "
          f"extrapolate_fused on its maps {general_s['maps']:.1f}, phase 4f "
          f"{general_s['4f']:.1f}, its [paths] lines {general_s['paths']:.1f}"
          f" (its profile groups run inside phase 3's one session)")

    phase_s.append(("8", time.perf_counter()))
    # 8. the contact configuration at full width
    steps = 200
    cfg = contact_config(1024)
    kw = dict(dtype=torch.float32, device=device)
    step = make_step(cfg, free_slip_box_bc, CONTACT_DISCS, **kw)
    state, aux, launches, wall, dt_sum, t0 = run_timed(
        step, contact_state(cfg, CONTACT_DISCS, **kw), device, warmup=20,
        steps=steps)
    min_J, advanced = check_run(
        "contact", state, aux, launches,
        expected_launches(rmt_block=steps, momentum_rk4=steps), dt_sum, t0)
    contact_launches = launches
    print(f"[contact] head-on collision (two discs, k_rep={cfg.k_rep}, "
          f"two_solid_clamp={cfg.two_solid_clamp}, free slip) N=1024 "
          f"float32: {steps} steps in {wall:.3f} s = {steps / wall:.1f} "
          f"steps/s, {1e3 * wall / steps:.3f} ms/step (host clock, "
          f"synchronised; phase 4's flagship {flagship_rate:.1f} steps/s) on "
          f"'{card}'; launches {launches}; t advanced {advanced:.6f}; min J "
          f"over the solids {min_J:.4f}; "
          + profile_line(step_prof["contact"], wall, steps))

    phase_s.append(("9", time.perf_counter()))
    # 9. the collision to t = 0.6: no pass-through, J in (0.5, 1)
    R = CONTACT_DISCS[0].R
    gap, coll_J, coll_steps, coll_wall, coll_launches = run_collision(
        256, device)
    print(f"[collision] N=256 float32 to t=0.6: {coll_steps} steps in "
          f"{coll_wall:.3f} s; least centroid distance {gap:.4f} (2R = "
          f"{2 * R:.2f}), least J {coll_J:.4f}; launches {coll_launches}")
    if not (gap > 2 * R and 0.5 < coll_J < 1.0):
        raise AssertionError(f"collision: gap {gap} (2R = {2 * R}), min J "
                             f"{coll_J} outside the gate")

    phase_s.append(("10", time.perf_counter()))
    # 10. the flagship on the doubly-periodic box
    from pyrmt_tpu_torch import validation
    from pyrmt_tpu_torch.sim import (
        periodic_seam_clearance_cells,
        solid_near_periodic_seam,
    )

    steps = 200
    cfg = flagship(1024, bc_type="periodic")
    step = make_step(cfg, bcs.periodic_bc, (FLAGSHIP_DISC,), **kw)
    state, aux, launches, wall, dt_sum, t0 = run_timed(
        step, periodic_state(cfg, **kw), device, warmup=20, steps=steps)
    min_J, advanced = check_run(
        "periodic flagship", state, aux, launches,
        expected_launches(rmt_block=steps, momentum_rk4_periodic=steps),
        dt_sum, t0)
    if bool(solid_near_periodic_seam(aux["phis"],
                                     periodic_seam_clearance_cells(cfg))):
        raise AssertionError("periodic flagship: the solid reached the seam")
    main_launches["momentum_rk4_periodic"] = launches["momentum_rk4_periodic"]
    print(f"[periodic] flagship on the doubly-periodic box (bench.py "
          f"--periodic's Taylor-Green seed) N=1024 float32: {steps} steps in "
          f"{wall:.3f} s = {steps / wall:.1f} steps/s, "
          f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronised; "
          f"phase 4's flagship {flagship_rate:.1f} steps/s) on '{card}'; "
          f"launches {launches}; t advanced {advanced:.6f}; min J over the "
          f"solid {min_J:.4f}; " + profile_line(step_prof["periodic"], wall,
                                                steps))

    phase_s.append(("11", time.perf_counter()))
    # 11. the pure-fluid lid cavity, on the RK4 kernel and with 'xla'
    fluid = {}
    for tag, over, expect in (
            ("lid fluid", {}, dict(momentum_rk4=steps)),
            ("lid fluid xla", dict(momentum_method="xla"), {})):
        cfg, bc, state = fluid_case("lid", 1024, **kw, **over)
        step = make_step(cfg, bc, (), **kw)
        state, aux, launches, wall, dt_sum, t0 = run_timed(
            step, state, device, warmup=20, steps=steps)
        check_run(tag, state, aux, launches, expected_launches(**expect),
                  dt_sum, t0)
        fluid[tag] = (steps / wall, launches["momentum_rk4"])
        print(f"[fluid] lid-driven cavity, no solid, {over or 'default'} "
              f"N=1024 float32: {steps} steps in {wall:.3f} s = "
              f"{steps / wall:.1f} steps/s, {1e3 * wall / steps:.3f} ms/step "
              f"(host clock, synchronised) on '{card}'; launches {launches}; "
              + profile_line(step_prof[tag], wall, steps))

    phase_s.append(("12", time.perf_counter()))
    # 12. the JAX package's solid-free gates, on the card
    reset_counts()
    rows, tg = validation.taylor_green_decay(N=65, nu=0.01, t_end=0.5,
                                             dtype=f64, device=device)
    tg_launches = counts()["momentum_rk4_periodic"]
    print(f"[gates] periodic Taylor-Green N=65 float64 to t=0.5: "
          f"{tg['steps']} steps in {tg['wall_s']:.3f} s; stable "
          f"{tg['stable']}, decay rate {tg['rate']:.6f} against "
          f"{tg['rate_exact']:.6f} (rel err {tg['rate_rel_err']:.3e} < 1e-2), "
          f"profile rel err {tg['profile_rel_err']:.3e} (< 5e-3), max|div| "
          f"{tg['maxdiv']:.3e} (< 1e-6); momentum_rk4 periodic launches "
          f"{tg_launches}")
    if not (tg["stable"] and tg["rate_rel_err"] < 1e-2
            and tg["profile_rel_err"] < 5e-3 and tg["maxdiv"] < 1e-6
            and tg_launches == tg["steps"]):
        raise AssertionError(f"Taylor-Green gate: {tg}")
    reset_counts()
    ghia = validation.lid_driven_cavity(
        Re=100.0, N=65, dtype=f64, device=device,
        ghia_csv=os.path.join(PORT_ROOT, "data", "plot_u_y_Ghia100.csv"))
    ghia_launches = counts()["momentum_rk4"]
    print(f"[gates] Ghia lid-driven cavity Re=100 N=65 float64: "
          f"{ghia['steps']} steps in {ghia['wall_s']:.3f} s to t = "
          f"{ghia['t']:.4f}, steady residual {ghia['residual']:.3e} (< 2e-5); "
          f"centreline RMS against Ghia {ghia['rms']:.4e} (< 5e-3); "
          f"momentum_rk4 launches {ghia_launches}")
    if not (ghia["steady"] and ghia["rms"] < 5e-3
            and ghia_launches == ghia["steps"]):
        raise AssertionError(f"Ghia gate: steps {ghia['steps']}, residual "
                             f"{ghia['residual']}, RMS {ghia.get('rms')}")
    if HAS_ST:
        st_gates(device)

    phase_s.append(("13", time.perf_counter()))
    # 13. gradients: the [grad] lines, the full width, the inverse problem
    grad_errs = {}
    for what in GRAD_CASES:
        fwd, err = grad_case(what, device)
        for name in fwd:
            grad_errs[name] = max(grad_errs.get(name, 0.0), err)
    grad_step_without_sync(device)
    full = grad_full_width(device, card)
    inverse_problem(device, card)

    phase_s.append(("14", time.perf_counter()))
    # 14. the sharding offsets, kernel by kernel (14a), and the sharded
    # step in a world of 4 ranks on the card (14b)
    offset_errs, offset_times, shard = phase14(device, card)

    phase_s.append(("end", time.perf_counter()))
    spans = ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1)
                      in zip(phase_s, phase_s[1:]))
    p14 = phase_s[-1][1] - phase_s[-2][1]
    print(f"[time] wall seconds per phase (host clock): {spans}; in all "
          f"{phase_s[-1][1] - phase_s[0][1]:.1f} from the build on; phase "
          f"14 {p14:.1f} s, {'within' if p14 <= 150.0 else 'past'} its aim "
          f"of 150 s")
    # the main path of extrapolate_fused is now the general tier's step
    main_launches["extrapolate_fused"] = general["weno5"]["launches"]
    gmaps = errs.pop("extrapolate_fused, general maps")
    errs["extrapolate_fused"] = max(errs["extrapolate_fused"], gmaps)
    kernels = []
    for name, (src, tpu) in KERNELS.items():
        bound, bound_by = bound_us(name, 1024)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": main_launches[name], "max_abs_err": errs[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": 1e-3 * bound, "bound_by": bound_by,
            "library_ms": None,  # no one PyTorch call computes any of them
            "device_us": prof[1024][name][0], "bound_us": bound,
            "device_launches_per_call": prof[1024][name][1],
            "device_us_N4096": prof[4096][name][0],
            "bound_us_N4096": bound_us(name, 4096)[0],
            # phase 13: the largest relative difference of a gradient
            # through the kernel's Function from the plain path's
            "grad_max_rel_err": grad_errs.get(name),
            # one call's backward at N=1024 float32: the plain twin's
            # forward and autograd
            "backward_ms": backward_ms.get(name)})
    entry = next(k for k in kernels if k["name"] == "extrapolate_fused")
    entry.update(launches_from="[general] weno5 (S = 1, 100 steps)",
                 rebase_launches=rebase["launches"],
                 general_maps_max_abs_err=gmaps,
                 general=general)
    entry = next(k for k in kernels if k["name"] == "momentum_rk4")
    entry["pure_fluid"] = {
        "launches": fluid["lid fluid"][1],
        "steps_per_s": fluid["lid fluid"][0],
        "xla_steps_per_s": fluid["lid fluid xla"][0]}
    for row, name in CONTACT_MODES.items():
        entry = next(k for k in kernels if k["name"] == name)
        entry["contact"] = {
            "mode": row.split(", ")[1], "launches": contact_launches[name],
            "device_us": prof[1024][row][0],
            "bound_us": bound_us(row, 1024)[0],
            "device_us_N4096": prof[4096][row][0],
            "bound_us_N4096": bound_us(row, 4096)[0]}
    # each solid block's modes: the entry itself is the flagship's (the
    # bilinear sample, the interior-mode stress); a mode's launches are
    # phase 4d's timed run's where it has one, else its [paths] run's
    mode_runs = {
        "rmt_block, bicubic": ("4d", mode_launches["flagship bicubic"]),
        "rmt_block, band": ("4d", mode_launches["flagship band"]),
        "rmt_block, raw bicubic": ("paths", mode_paths[
            "flagship, raw bicubic sample"]["rmt_block"]),
        "rmt_block, two solids bicubic": ("paths", mode_paths[
            "contact, bicubic sample"]["rmt_block"]),
        "advext_block, bicubic": ("paths", mode_paths[
            "area fix, bicubic sample (split tier)"]["advext_block"]),
        "advext_block, raw bicubic": ("paths", mode_paths[
            "area fix, raw bicubic sample"]["advext_block"])}
    if HAS_ST:
        mode_runs.update({
            "rmt_block, ellipse": ("4e", st_launches["capillary drop"][
                "rmt_block"]),
            "rmt_block, disc and ellipse": ("paths", mode_paths[
                "contact, a disc and an ellipse"]["rmt_block"])})
    for name, mode in (("rmt_block", "bilinear, interior stress"),
                       ("advext_block", "bilinear")):
        next(k for k in kernels if k["name"] == name)["mode"] = mode
    for row, name in MODES.items():
        entry = next(k for k in kernels if k["name"] == name)
        phase, n = mode_runs[row]
        entry.setdefault("modes", []).append({
            "mode": row.split(", ")[1], "launches": n,
            "launches_from": phase,
            "max_abs_err": errs[row], "ms": times[row][0],
            "plain_ms": times[row][1],
            "bound_ms": 1e-3 * bound_us(row, 1024)[0],
            "device_us": prof[1024][row][0],
            "device_us_N4096": prof[4096][row][0],
            "bound_us_N4096": bound_us(row, 4096)[0]})
    entry = next(k for k in kernels if k["name"] == "rmt_block")
    entry["checked_modes"] = {row.split(", ")[1]: errs[row]
                              for row in CHECKED if row in errs}
    # the offset instantiations: their launches on the main paths of the
    # sharded slices (phase 14b at N=2048 float32, all ranks: the flagship
    # for rmt_block and momentum_rk4, the capillary drop for rmt_block's
    # ellipse, the split tier for advext_block), their errors from phase
    # 14a (a kernel's row: over all its cases), their times on the (0, 0)
    # block of the (2, 2) mesh of N=2048 float32
    offset_runs = {"rmt_block, offsets": ("N=2048 float32 (2,2)",
                                          "rmt_block.offset_launches"),
                   "rmt_block, ellipse offsets": (
                       "N=2048 float32 (2,2) capillary drop",
                       "rmt_block.offset_launches"),
                   "momentum_rk4, offsets": ("N=2048 float32 (2,2)",
                                             "momentum_rk4.offset_launches"),
                   "advext_block, offsets": (
                       "N=2048 float32 (2,2) split",
                       "rmt_block.advext_offset_launches")}
    for row, (case, _) in OFFSET_ROWS.items():
        name = case.split(",")[0]
        entry = next(k for k in kernels if k["name"] == name)
        of_kernel = [e for c, e in offset_errs.items()
                     if c.split(",")[0] == name]
        stitched, vs_plain = (offset_errs[case] if case != name else
                              (max(e[0] for e in of_kernel),
                               max(e[1] for e in of_kernel)))
        run, key = offset_runs[row]
        entry.setdefault("modes", []).append({
            "mode": f"{row.split(', ')[1]}, the (0, 0) block of the (2, 2) "
                    f"mesh of N={OFFSET_N}",
            "launches": sum(n[key] for n in shard[run]["launches"]),
            "launches_from": f"14b {run} ({SHARD_RANKS} ranks, "
                             f"{shard[run]['steps']} timed steps)",
            "max_abs_err": vs_plain, "stitched_max_abs_err": stitched,
            "ms": offset_times[row][0], "plain_ms": offset_times[row][1],
            "bound_ms": 1e-3 * bound_us(row, OFFSET_N // 2)[0],
            "device_us": prof[1024][row][0]})
    print(json.dumps({"kernels": kernels, "grad_full_width": {
        k: full[k] for k in ("loss", "grad", "fwd_ms", "bwd_ms",
                             "peak_gib")}}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
