"""Map rebasing in the port against ``pyrmt_tpu.sim``: the split-tier step
in each rebuild mode, and the chunked runner.

The recipe of tests/test_split_step.py (N=64 float64, the disc at
(0.55, 0.5) in the lid-driven cavity, a Taylor-Green start, 3 steps, the
JAX step on its XLA paths with jit disabled) with mu_s = 0.02 and
``map_rebase_minj`` 1e-9 (never fires) or 10 (fires on every step where the
mode lets the step trigger), in each of the 'cond', 'analytic' and
'sampled' rebuild modes. Tolerances: u, v, X1, X2 and phis0 to 1e-12, p to
1e-11, the ``rebased`` flags equal.

Each package starts from its own ``make_init_state`` (the two agree to
1e-13): the 'cond' rebuild asks whether phis0 still equals the seed
phi_init(X, Y) bit for bit, and torch's CPU sqrt rounds a few cells an ulp
off XLA's, so a state made by one package reads as rebased in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from test_torch_split_step import (
    ATOL,
    DISC,
    assert_trajectories_match,
    j_phi,
    jax_config,
    jax_init,
    jax_numpy,
    trajectories,
)
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card


@pytest.mark.parametrize("mode", ["cond", "analytic", "sampled"])
@pytest.mark.parametrize("minj", [1e-9, 10.0])
def test_rebasing_step_matches_jax(minj, mode):
    jcfg = jax_config(mu_s=0.02, map_rebase_minj=minj,
                      map_rebase_rebuild=mode)
    j_traj, t_traj = trajectories(jcfg, port_init=True)
    assert_trajectories_match(j_traj, t_traj)
    fired = [bool(aux["rebased"].any()) for _, aux in t_traj]
    assert fired == [minj == 10.0 and mode != "analytic"] * len(fired)


def test_init_state_seeds_phis0():
    jcfg = jax_config(map_rebase_minj=0.5)
    with jax.disable_jit():
        js = jax_numpy(jax_init(jcfg))
    X, Y = port_config(jcfg).grid.coords(dtype=torch.float64, device=DEV)
    ts = state_to_numpy(pt.make_init_state(
        port_config(jcfg), (pt.Disc(*DISC),),
        u0=0.4 * torch.sin(torch.pi * X) * torch.cos(torch.pi * Y),
        v0=-0.4 * torch.cos(torch.pi * X) * torch.sin(torch.pi * Y),
        dtype=torch.float64, device=DEV))
    assert ts["phis0"].shape == (1, 64, 64)
    for k in STATE_FIELDS:
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-13,
                                   err_msg=k)


def test_runner_matches_jax():
    """make_rebase_runner with 2-step chunks: the pre-phase chunk ends with
    min J < 10, so the runner rebases and switches; the next chunk runs the
    sampled step, which itself rebases every step."""
    jcfg = jax_config(mu_s=0.02, map_rebase_minj=10.0)
    with jax.disable_jit():
        jrun = jsim.make_rebase_runner(jcfg, j_lid_bc(1.0), (j_phi,), 2,
                                       dtype=jnp.float64)
        js = jax_init(jcfg)
        trun = pt.make_rebase_runner(port_config(jcfg), pt.make_lid_bc(1.0),
                                     (pt.Disc(*DISC),), 2,
                                     dtype=torch.float64, device=DEV)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        ts = pt.make_init_state(port_config(jcfg), (pt.Disc(*DISC),),
                                u0=ts.u, v0=ts.v, dtype=torch.float64,
                                device=DEV)
        phis0_start = ts.phis0.clone()
        for chunk in range(2):
            js, jt = jrun(js, jnp.asarray(1.0, jnp.float64))
            ts, tt = trun(ts, 1.0)
            jn, tn = jax_numpy(js), state_to_numpy(ts)
            for k, atol in ATOL.items():
                np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=atol,
                                           err_msg=f"chunk {chunk + 1}: {k}")
            assert float(tt) == float(jt)
            assert trun.post
            if chunk == 0:
                assert not torch.equal(ts.phis0, phis0_start)
    with pytest.raises(ValueError, match="map_rebase_minj"):
        pt.make_rebase_runner(port_config(jax_config()), pt.make_lid_bc(1.0),
                              (pt.Disc(*DISC),), 2, device=DEV)


def test_runner_rebase_resets_the_map():
    """``rebase`` on a solid puts back the extrapolated identity map over a
    redistanced base level set, J = 1 in the solid, and the post phase."""
    cfg = port_config(jax_config(mu_s=0.02, map_rebase_minj=0.5))
    disc = pt.Disc(*DISC)
    run = pt.make_rebase_runner(cfg, pt.make_lid_bc(1.0), (disc,), 3,
                                dtype=torch.float64, device=DEV)
    s = pt.make_init_state(cfg, (disc,), dtype=torch.float64, device=DEV)
    s, _ = run(s, 1.0)
    assert not run.post  # J ~ 1 > 0.5: no trigger
    s = run.rebase(s, [True])
    assert run.post
    X, Y = cfg.grid.coords(dtype=torch.float64, device=DEV)
    inner = s.phis0[0] < -2 * cfg.grid.dx
    assert torch.equal(s.X1[0][inner], X[inner])
    assert float((run.min_J(s) - 1.0).abs().max()) < 1e-12
