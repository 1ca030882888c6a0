"""The port's faults F1-F4 (ROADMAP §3), each held where it was wrong.

- F1: a velocity BC without a ``kernel_spec`` takes the plain RK4 stage
  loop (and, with ``projection_method='pallas'``, the plain projection
  stencils), as the JAX step takes XLA's where ``momentum_rk4_supported``
  and ``projection_stencils_supported`` are False; it steps to the result
  of the same BC with its spec. The kernels themselves keep raising.
- F2: a level set the fused tier's kernel does not evaluate (a torch
  callable that is neither a Disc nor an Ellipse, or more than 16 solids)
  takes the split tier, which gives ``rmt_block_plain``'s results.
- F3: the port stepping a state made by the JAX package under the 'cond'
  rebuild: phis0 within a few ulps of the port's seed reads as the seed,
  so three steps agree with JAX to 1e-12 (p to 1e-11); before, every
  solid read as rebased (u off by 1.2e-9).
- F4: ``make_run_chunk`` and ``make_rebase_runner`` take ``donate=`` as
  ``bench.py`` passes it.
The card's side of F1 and F2 is in tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.kernels import _build
from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_supported
from pyrmt_tpu_torch.kernels.rmt_block import (
    rmt_block_plain,
    rmt_block_supported,
)
from test_torch_split_step import (
    assert_trajectories_match,
    jax_config,
    trajectories,
)

torch.set_num_threads(1)
DEV = "cpu"
N = 48
KW = dict(dtype=torch.float64, device=DEV)
LID = pt.make_lid_bc(1.0)


def lid_without_spec(u, v):
    """The lid BC as a user would write it: no kernel_spec."""
    return LID(u, v)


def rounded_square(X1, X2):
    """A rounded square of half-width 0.15 about (0.55, 0.5), radius 0.05:
    a level set the fused tier's kernel does not evaluate."""
    qx = torch.clamp(torch.abs(X1 - 0.55) - 0.1, min=0.0)
    qy = torch.clamp(torch.abs(X2 - 0.5) - 0.1, min=0.0)
    inside = torch.clamp(torch.maximum(torch.abs(X1 - 0.55),
                                       torch.abs(X2 - 0.5)) - 0.1, max=0.0)
    return torch.sqrt(qx * qx + qy * qy) + inside - 0.05


def flagship(**over):
    return pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                        mu_f=0.01, **over)


def run(step, state, n=3):
    for _ in range(n):
        state, aux = step(state, 1.0)
    return state, aux


def assert_states_equal(a, b):
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("projection", ["auto", "pallas"])
def test_f1_bc_without_spec_takes_the_plain_blocks(projection):
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    cfg = flagship(projection_method=projection)
    assert momentum_rk4_supported(LID)
    assert not momentum_rk4_supported(lid_without_spec)
    step = pt.make_step(cfg, lid_without_spec, disc, **KW)
    assert step.paths["momentum"] == "stage loop"
    assert step.paths["projection"] == "stencils"
    ref = pt.make_step(cfg, LID, disc, **KW)
    assert ref.paths["momentum"] == "rk4 kernel"
    assert ref.paths["projection"] == ("stencil kernels"
                                       if projection == "pallas"
                                       else "stencils")
    s0 = pt.make_init_state(cfg, disc, **KW)
    assert_states_equal(run(step, s0)[0], run(ref, s0)[0])
    with pytest.raises(ValueError, match="kernel_spec"):
        _build.bc_operands("momentum_rk4", lid_without_spec)


def test_f2_other_level_sets_take_the_split_tier():
    cfg = flagship()
    assert not rmt_block_supported((rounded_square,))
    assert rmt_block_supported((pt.Ellipse(0.5, 0.5, 0.2, 0.15),))
    step = pt.make_step(cfg, LID, (rounded_square,), **KW)
    assert step.paths["solid"] == "split"
    ref = pt.make_step(cfg, LID, (rounded_square,),
                       rmt_block_impl=rmt_block_plain, **KW)
    assert ref.paths["solid"] == "fused"
    s0 = pt.make_init_state(cfg, (rounded_square,), **KW)
    (s, aux), (s_ref, aux_ref) = run(step, s0), run(ref, s0)
    assert_states_equal(s, s_ref)
    for k in ("phis", "J", "sxx", "rho_local"):
        assert torch.equal(aux[k], aux_ref[k]), k
    assert float(s.u.abs().max()) > 0.0


def test_f2_more_solids_than_the_kernel_takes():
    discs = tuple(pt.Disc(0.15 + 0.2 * (i % 4), 0.15 + 0.2 * (i // 4), 0.04)
                  for i in range(17))
    cfg = flagship(num_layers=3)
    assert not rmt_block_supported(discs)
    assert rmt_block_supported(discs[:16])
    assert pt.make_step(cfg, LID, discs, **KW).paths["solid"] == "split"
    assert pt.make_step(cfg, LID, discs[:16], **KW).paths["solid"] == "fused"


@pytest.mark.parametrize("minj", [1e-9, 10.0])
def test_f3_jax_made_state_steps_as_in_jax(minj):
    """tests/test_torch_rebase.py's recipe under the 'cond' rebuild, from
    the JAX package's make_init_state (its phis0 a few cells an ulp off
    the port's seed): no rebase fires (1e-9) or one fires every step
    (10), and the port follows JAX either way."""
    jcfg = jax_config(mu_s=0.02, map_rebase_minj=minj,
                      map_rebase_rebuild="cond")
    j_traj, t_traj = trajectories(jcfg)
    assert_trajectories_match(j_traj, t_traj)
    fired = [bool(aux["rebased"].any()) for _, aux in t_traj]
    assert fired == [minj == 10.0] * len(fired)


def test_f3_a_rebased_phis0_still_reads_as_rebased():
    """A phis0 moved by more than the seed tolerance in one cell takes the
    sampled rebuild; within it, the analytic one."""
    disc = pt.Disc(0.55, 0.5, 0.2)
    cfg = flagship(map_rebase_minj=1e-9)
    X, Y = cfg.grid.coords(**KW)
    seed = disc(X, Y)
    rebuild = pt.sim._make_rebuild(cfg, (disc,), X, Y, torch.float64)
    X1 = (X + 0.3 * cfg.grid.dx)[None]
    X2 = Y[None]
    analytic = disc(X1[0], X2[0])
    eps = torch.finfo(torch.float64).eps
    near = seed + eps * seed.abs()           # an ulp off: the seed
    far = seed.clone()
    far[10, 10] += 1e-9                      # a rebased field
    assert torch.equal(rebuild(X1, X2, near[None])[0], analytic)
    assert not torch.equal(rebuild(X1, X2, far[None])[0], analytic)


def test_f4_runners_take_donate():
    """bench.py's call shapes: make_run_chunk(step, n, donate=...) and
    make_rebase_runner(..., dtype=..., donate=...); the caller chains
    states, and the input state stays valid."""
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    cfg = flagship()
    step = pt.make_step(cfg, LID, disc, **KW)
    s0 = pt.make_init_state(cfg, disc, **KW)
    u0 = s0.u.clone()
    chunk = pt.make_run_chunk(step, 2, donate=True)
    s, t = chunk(s0, 1.0)
    assert int(s.step) == 2 and float(t) > 0.0 and torch.equal(s0.u, u0)
    rcfg = dataclasses.replace(cfg, map_rebase_minj=1e-9)
    runner = pt.make_rebase_runner(rcfg, LID, disc, 2, dtype=torch.float64,
                                   device=DEV, donate=True)
    s, _ = runner(pt.make_init_state(rcfg, disc, **KW), 1.0)
    assert int(s.step) == 2 and not runner.post
    np.testing.assert_array_equal(s.X1.shape, (1, N, N))
