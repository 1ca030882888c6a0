"""Bicubic sampling on the split tier's block and through whole steps, in
the port against the JAX package.

- ``advext_block_plain`` with ``sl_interp='bicubic'`` against the JAX
  kernel ``advext_block_fused(..., interpret=True)`` at N=64 (the inputs of
  tests/test_torch_split.py with the maps bent by a smooth third of a cell,
  so that the bicubic sample differs from the bilinear one), band-guarded
  (3 dx) and raw: float64, 1e-13.
- Three float64 steps at N=64 of ``make_step`` against the JAX package's
  ``make_step`` on its XLA paths (the recipe of
  tests/test_torch_split_step.py: the disc at (0.55, 0.5) in the lid-driven
  cavity, a Taylor-Green start, the JAX step with jit disabled) with
  ``sl_interp='bicubic'`` and the default band guard of 3 cells: the
  flagship's physics on the fused tier, and the area fix on the split
  tier; and the flagship on the doubly-periodic box (``bench.py
  --periodic``'s seed, tests/test_torch_periodic.py) with bicubic. u, v, X1,
  X2 and phis0 to 1e-12, p to 1e-11, t to 1e-15, the aux phi and J to
  1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as jbcs
import pyrmt_tpu.kernels.rmt_block as jrb
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.rmt_block as rb
from pyrmt_tpu_torch.io import state_from_numpy, state_to_numpy
from test_torch_periodic import periodic_flagship
from test_torch_split import advext_case
from test_torch_split_step import (
    ATOL,
    assert_trajectories_match,
    jax_config,
    jax_numpy,
    trajectories,
)
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card


def bent_advext_case():
    """tests/test_torch_split.py's one-solid inputs with the maps bent by
    a third of a cell: on the identity map (linear inside the solid) the
    bicubic and bilinear samples agree."""
    u, v, X1s, X2s, phis, dt = advext_case(1)
    N = u.shape[0]
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    bend = (1.0 / (N - 1)) / 3 * np.sin(3 * np.pi * X) * np.sin(2 * np.pi * Y)
    return u, v, X1s + bend, X2s - bend.T, phis, dt


@pytest.mark.parametrize("guard", [3.0, None], ids=["guarded", "raw"])
def test_plain_bicubic_advext_matches_pallas_interpret(guard):
    u, v, X1s, X2s, phis, dt = bent_advext_case()
    dx = 1.0 / (u.shape[0] - 1)
    sl_guard = None if guard is None else guard * dx
    ref = jrb.advext_block_fused(
        *(jnp.asarray(a) for a in (u, v, X1s, X2s, phis)), jnp.asarray(dt),
        dx=dx, dy=dx, num_layers=3, sl_interp="bicubic", sl_guard=sl_guard,
        interpret=True)
    args = [torch.tensor(np.asarray(a)) for a in (u, v, X1s, X2s, phis, dt)]
    out = rb.advext_block_plain(*args, dx=dx, dy=dx, num_layers=3,
                                sl_interp="bicubic", sl_guard=sl_guard)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-13)
    bil = rb.advext_block_plain(*args, dx=dx, dy=dx, num_layers=3)
    assert float((out[0] - bil[0]).abs().max()) > 1e-8


CONFIGS = {
    # the flagship's solid (mu_s 0.1, eta_s 0.01) on the fused tier
    "fused": dict(mu_s=0.1, eta_s=0.01, sl_interp="bicubic"),
    "area_fix": dict(phi_area_fix=True, sl_interp="bicubic"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bicubic_step_matches_jax(name):
    jcfg = jax_config(**CONFIGS[name])
    tcfg = port_config(jcfg)
    assert pt.sim.rmt_block_fusible(tcfg, 1) == (name == "fused")
    assert pt.sim.sl_band_guard(tcfg) == 3.0 * tcfg.grid.dx
    j_traj, t_traj = trajectories(jcfg)
    assert_trajectories_match(j_traj, t_traj)
    assert not np.array_equal(t_traj[-1][0]["X1"], t_traj[0][0]["X1"])


def test_periodic_bicubic_step_matches_jax():
    jcfg, jphis, u0, v0 = periodic_flagship(64, sl_interp="bicubic")
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, jbcs.periodic_bc, jphis,
                               dtype=jnp.float64)
        js = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0,
                                  dtype=jnp.float64)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        tstep = pt.make_step(port_config(jcfg), pt.periodic_bc,
                             (pt.Disc(0.6, 0.5, 0.2),), dtype=torch.float64,
                             device=DEV)
        for n in range(3):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            jn, tn = jax_numpy(js), state_to_numpy(ts)
            for k, atol in ATOL.items():
                np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=atol,
                                           err_msg=f"step {n + 1}: {k}")
            np.testing.assert_allclose(taux["J"].numpy(), np.asarray(
                jaux["J"]), rtol=0, atol=1e-12, err_msg=f"step {n + 1}: J")
