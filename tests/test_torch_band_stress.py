"""The band-mode stress (``stress_band=True``) in the port against the JAX
package.

- ``rmt_block_plain`` with ``stress_w_cut = w_t`` and ``stress_clamp = 3``
  against the JAX kernel ``rmt_block_fused(..., interpret=True)`` at N=64:
  the flagship disc's map from make_init_state with a wave of a quarter of
  the domain on each component, so that det G leaves [1/3, 3] at both ends
  and the clamp bites. float64, 1e-13; J, the stresses and their blends
  1e-12 (they difference the extrapolated band's map, whose extrapolation
  the two packages agree on to 1e-12).
- Three float64 steps at N=64 against the JAX package's ``make_step`` on
  its XLA paths (the recipe of tests/test_torch_split_step.py, jit
  disabled): the flagship's physics with ``stress_band=True,
  num_layers=4`` (the setting of benchmarks/soft_disc_in_lid_driven.py) on
  the fused tier, and map rebasing on every step (the split tier) with
  ``stress_band``. u, v, X1, X2 and phis0 to 1e-12, p to 1e-11, t to
  1e-15, the aux phi and J to 1e-12.
- ``stress_mode`` makes the JAX step's choice for S in {0, 1, 2} with and
  without ``stress_band``, and the rebasing runner's least J follows it.
- The JAX step's two warnings: the band mode with too few layers, and the
  bicubic guard off the sub-cell backtrace (``sl_local=False``, the
  general tier), each fire from ``make_step`` in both packages with the
  same text.
"""
import dataclasses
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.kernels.rmt_block as jrb
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.rmt_block as rb
import pyrmt_tpu_torch.sim as tsim
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from test_torch_bicubic import NAMES, block_case
from test_torch_split_step import (
    DISC,
    assert_trajectories_match,
    j_phi,
    jax_config,
    trajectories,
)
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card


@pytest.fixture(scope="module")
def band_runs():
    """(JAX kernel in interpret mode, the port's plain version, the plain
    interior mode) outputs of the band-mode block, and the clamp's ends."""
    g, (jargs, jkw), (targs, tkw) = block_case(((0.6, 0.5, 0.2),))
    k = 2.0 * math.pi / 0.25
    X1, X2 = (np.asarray(a) for a in jargs[2:4])
    X1 = X1 + (0.8 / k) * np.sin(k * X1)
    X2 = X2 + (0.8 / k) * np.sin(k * X2)
    jargs = (*jargs[:2], jnp.asarray(X1), jnp.asarray(X2), jargs[4])
    targs = (*targs[:2], torch.tensor(X1), torch.tensor(X2), targs[4])
    w_t = jkw["w_t"]
    ref = jrb.rmt_block_fused(*jargs, **jkw, stress_w_cut=w_t,
                              stress_clamp=3.0, interpret=True)
    out = rb.rmt_block_plain(*targs, **tkw, stress_w_cut=w_t,
                             stress_clamp=3.0)
    interior = rb.rmt_block_plain(*targs, **tkw)
    return ([np.asarray(r) for r in ref], [o.numpy() for o in out],
            [o.numpy() for o in interior])


# J, the stresses and their blends: in band mode they difference the map
# over the extrapolated band too, where the two packages' extrapolations
# agree to 1e-12 (tests/test_torch_split.py), not only over the advected
# solid (one ulp of the map moves grad X by 32 ulps at N=64)
BAND_1E12 = {3, 4, 5, 6, 9, 10, 11}


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_plain_band_block_matches_pallas_interpret(band_runs, i):
    ref, out, _ = band_runs
    assert out[i].shape == ref[i].shape
    np.testing.assert_allclose(out[i], ref[i], rtol=0,
                               atol=1e-12 if i in BAND_1E12 else 1e-13,
                               err_msg=NAMES[i])


def test_band_block_clamps_and_reaches_past_the_solid(band_runs):
    """det G is clamped to [1/3, 3] (J in [1/3, 3]), and the band mode
    stresses fluid cells within w_t of the interface, which the interior
    mode leaves at 0."""
    _, out, interior = band_runs
    phi, sxx, J = out[2][0], out[3][0], out[6][0]
    assert J.min() == pytest.approx(1.0 / 3.0, rel=1e-12)
    assert J.max() == pytest.approx(3.0, rel=1e-12)
    ring = (phi > 0.0) & (sxx != 0.0)
    assert ring.any() and not (interior[3][0][ring] != 0.0).any()


BAND_CONFIGS = {
    # the flagship's solid with benchmarks/soft_disc_in_lid_driven.py's
    # band-mode setting, on the fused tier
    "fused": (dict(mu_s=0.1, eta_s=0.01, stress_band=True, num_layers=4),
              False),
    # a rebase on every step (the split tier), each package from its own
    # make_init_state (tests/test_torch_rebase.py)
    "rebase": (dict(mu_s=0.02, map_rebase_minj=10.0, stress_band=True,
                    num_layers=4), True),
}


@pytest.mark.parametrize("name", list(BAND_CONFIGS))
def test_band_step_matches_jax(name):
    overrides, port_init = BAND_CONFIGS[name]
    jcfg = jax_config(**overrides)
    tcfg = port_config(jcfg)
    assert tsim.rmt_block_fusible(tcfg, 1) == (name == "fused")
    assert tsim.stress_mode(tcfg, 1) == (tcfg.w_t, tcfg.detg_clamp)
    j_traj, t_traj = trajectories(jcfg, port_init=port_init)
    assert_trajectories_match(j_traj, t_traj)
    if name == "rebase":
        assert all(bool(aux["rebased"].any()) for _, aux in t_traj)


@pytest.mark.parametrize("S", [0, 1, 2])
@pytest.mark.parametrize("band", [False, True])
def test_stress_mode_is_the_jax_steps_choice(S, band):
    """pyrmt_tpu/sim.py:615-622: two solids or more take the interior
    stress with the two-solid clamp; otherwise stress_band picks the band
    mode (w_cut = w_t) with detg_clamp, else the unclamped interior
    stress."""
    cfg = pt.RMTConfig(grid=pt.Grid(32, 32, 1.0, 1.0), stress_band=band,
                       detg_clamp=2.5, two_solid_clamp=4.5)
    if S >= 2:
        want = (0.0, 4.5)
    else:
        want = (cfg.w_t, 2.5) if band else (0.0, 0.0)
    assert tsim.stress_mode(cfg, S) == want


def test_rebase_runner_least_j_follows_the_band_mode():
    """RebaseRunner.min_J takes the step's stress mode: with stress_band
    the band mode's J, clamped to [1/detg_clamp, detg_clamp]."""
    from pyrmt_tpu_torch.ops.stress import solid_cauchy_stress

    cfg = port_config(jax_config(mu_s=0.02, map_rebase_minj=0.5,
                                 stress_band=True, num_layers=4,
                                 detg_clamp=1.05))
    disc = pt.Disc(*DISC)
    kw = dict(dtype=torch.float64, device=DEV)
    run = pt.make_rebase_runner(cfg, pt.make_lid_bc(1.0), (disc,), 2, **kw)
    s = pt.make_init_state(cfg, (disc,), **kw)
    X, Y = cfg.grid.coords(**kw)
    s.X1 = s.X1 * (1.0 + 0.3 * torch.sin(7 * X))  # det G off 1, clamped
    phi = disc(s.X1[0], s.X2[0])
    J = solid_cauchy_stress(s.X1[0], s.X2[0], cfg.grid.dx, cfg.grid.dy,
                            cfg.mu_s, cfg.kappa, phi, w_cut=cfg.w_t,
                            detg_clamp=1.05)[3]
    want = float(torch.amin(torch.where(phi <= 0.0, J, float("inf"))))
    assert float(run.min_J(s)[0]) == want
    assert want == pytest.approx(1.0 / 1.05, rel=1e-12)


def test_band_warning_fires_as_in_jax():
    jcfg = jax_config(stress_band=True, num_layers=3)
    with pytest.warns(UserWarning, match="stress_band=True") as jrec:
        jsim.make_step(jcfg, j_lid_bc(1.0), (j_phi,), dtype=jnp.float64)
    with pytest.warns(UserWarning, match="stress_band=True") as trec:
        pt.make_step(port_config(jcfg), pt.make_lid_bc(1.0),
                     (pt.Disc(*DISC),), dtype=torch.float64, device=DEV)
    assert [str(w.message) for w in trec] == [str(w.message) for w in jrec]
    with warnings.catch_warnings():  # enough layers: no warning
        warnings.simplefilter("error")
        pt.make_step(port_config(dataclasses.replace(jcfg, num_layers=4)),
                     pt.make_lid_bc(1.0), (pt.Disc(*DISC),),
                     dtype=torch.float64, device=DEV)


def test_bicubic_guard_warning_as_in_jax():
    jcfg = jax_config(sl_interp="bicubic", sl_local=False)
    with pytest.warns(UserWarning, match="sl_interp='bicubic'") as jrec:
        jsim.make_step(jcfg, j_lid_bc(1.0), (j_phi,), dtype=jnp.float64)
    tcfg = port_config(jcfg)
    with pytest.warns(UserWarning, match="sl_interp='bicubic'") as trec:
        pt.make_step(tcfg, pt.make_lid_bc(1.0), (pt.Disc(*DISC),),
                     dtype=torch.float64, device=DEV)
    assert [str(w.message) for w in trec] == [str(w.message) for w in jrec]
    with warnings.catch_warnings():  # the sub-cell backtrace: no warning
        warnings.simplefilter("error")
        pt.make_step(dataclasses.replace(tcfg, sl_local=True),
                     pt.make_lid_bc(1.0), (pt.Disc(*DISC),),
                     dtype=torch.float64, device=DEV)
