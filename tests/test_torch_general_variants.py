"""More of the port's general tier against ``pyrmt_tpu.sim.make_step``,
on the recipe of tests/test_torch_general_step.py (N=48 float64, three
steps, the JAX step on its XLA paths with jit disabled, from the JAX
initial state; u, v, X1, X2 and phis0 to 1e-12, p to 1e-11, the aux
fields to 1e-12):

- ``scheme='weno5'`` with the area fix and PDE reinitialisation;
- ``scheme='weno5'`` on the contact configuration
  (benchmarks/two_disc_contact.py's, free slip) with two discs whose
  contact bands touch from the first step, moving towards each other;
- ``scheme='central2'`` on the doubly-periodic box (the flagship disc,
  bench.py --periodic's Taylor-Green seed);
- ``scheme='weno5'`` with map rebasing in 'cond' mode, firing on every
  step (``map_rebase_minj=10``), the rebased flags equal;
- ``scheme='central2'`` with the balanced-force CSF (gamma 0.1, the
  capillary drop's settings, free slip).

Then ``sl_local=False`` with CFL < 1 against the port's own fused tier
(the gather-free backtrace) to 1e-12, as tests/test_advect.py pins the two
JAX paths to each other.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.bcs import periodic_bc as j_periodic
from test_torch_general_step import (
    STEPS,
    assert_step_matches,
    jax_config,
    run_both,
    swirl,
)
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

FLAGSHIP_DISC = [(0.6, 0.5, 0.2)]
TOUCHING = [(0.38, 0.5, 0.14), (0.66, 0.5, 0.14)]
CONTACT = dict(mu_s=1.0, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=0.01,
               rho_f=1.0, w_c_cells=3.0, k_rep=2.0, two_solid_clamp=4.0)
CAPILLARY = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                 rho_f=1.0, gamma=0.1, st_method="balanced", CFL=0.4)
_RUNS = {}


def approach(jcfg, V0=0.15):
    """The contact discs' velocity, u0 = V0 (1 - H_a) - V0 (1 - H_b)
    (benchmarks/two_disc_contact.py:52-58), and v0 = 0."""
    from pyrmt_tpu.ops.stress import smoothed_heaviside

    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    H = [smoothed_heaviside(jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R,
                            jcfg.w_t) for x0, y0, R in TOUCHING]
    return j_free_slip(V0 * (1 - H[0]) - V0 * (1 - H[1]), 0 * X)


def case_args(case):
    """(JAX config, JAX BC, port BC, discs, u0, v0) of a case."""
    lid = (j_lid_bc(1.0), pt.make_lid_bc(1.0))
    if case == "weno5_areafix_reinit":
        jcfg = jax_config(scheme="weno5", phi_area_fix=True,
                          reinit_method="pde")
        return (jcfg, *lid, FLAGSHIP_DISC, *swirl(jcfg, 0.5))
    if case == "weno5_contact":
        jcfg = jax_config(scheme="weno5", **CONTACT)
        return (jcfg, j_free_slip, pt.free_slip_box_bc, TOUCHING,
                *approach(jcfg))
    if case == "central2_periodic":
        jcfg = jax_config(scheme="central2", bc_type="periodic")
        X, Y = jcfg.grid.coords(dtype=jnp.float64)
        u0 = 0.5 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
        v0 = -0.5 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
        return jcfg, j_periodic, pt.periodic_bc, FLAGSHIP_DISC, u0, v0
    if case == "weno5_rebase_cond":
        jcfg = jax_config(scheme="weno5", map_rebase_minj=10.0,
                          map_rebase_rebuild="cond")
        return (jcfg, *lid, FLAGSHIP_DISC, *swirl(jcfg, 0.5))
    jcfg = jax_config(scheme="central2", **CAPILLARY)
    return (jcfg, j_free_slip, pt.free_slip_box_bc, [(0.5, 0.5, 0.2)],
            *swirl(jcfg, 0.05))


CASES = ("weno5_areafix_reinit", "weno5_contact", "central2_periodic",
         "weno5_rebase_cond", "central2_balanced_csf")


def trajectories(case):
    if case not in _RUNS:
        _RUNS[case] = run_both(*case_args(case))
    return _RUNS[case]


@pytest.mark.parametrize("n", range(STEPS))
@pytest.mark.parametrize("case", CASES)
def test_step_matches_jax(case, n):
    tstep, traj, _ = trajectories(case)
    assert tstep.paths["solid"] == "general"
    assert_step_matches(traj, n, case)
    aux = traj[n + 1][3]
    if case == "weno5_rebase_cond":
        assert bool(aux["rebased"].all())
    if case == "central2_balanced_csf":
        assert tstep.paths["projection"] == "faces"
    if case == "central2_periodic":
        assert tstep.paths["projection"] == "fft"
    if case == "weno5_contact":
        from pyrmt_tpu_torch.physics import external_forces

        cfg = jax_config(**CONTACT)
        fx, _ = external_forces(aux["phis"], None, cfg.grid.dx, cfg.grid.dy,
                                gamma=0.0, k_rep=cfg.k_rep, w_c=cfg.w_c,
                                w_t=cfg.w_t)
        assert float(fx.abs().max()) > 0.0  # the contact force acts


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_gather_path_matches_the_fused_tier(interp):
    """``sl_local=False`` (the general tier's gather) against the default
    gather-free backtrace (the fused tier) at CFL < 1: 1e-12."""
    cfg = port_config(jax_config(sl_interp=interp))
    kw = dict(dtype=torch.float64, device=DEV)
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    fused = pt.make_step(cfg, pt.make_lid_bc(1.0), disc, **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        general = pt.make_step(dataclasses.replace(cfg, sl_local=False),
                               pt.make_lid_bc(1.0), disc, **kw)
    assert ["sl_interp='bicubic'" in str(w.message) for w in rec] == (
        [True] if interp == "bicubic" else [])
    assert (fused.paths["solid"], general.paths["solid"]) == (
        "fused", "general")
    X, Y = cfg.grid.coords(**kw)
    s = pt.make_init_state(
        cfg, disc, u0=0.5 * torch.sin(np.pi * X) * torch.cos(np.pi * Y),
        v0=-0.5 * torch.cos(np.pi * X) * torch.sin(np.pi * Y), **kw)
    s_f = s_g = s
    for _ in range(STEPS):
        s_f, a_f = fused(s_f, 1.0)
        s_g, a_g = general(s_g, 1.0)
        for k, atol in (("u", 1e-12), ("v", 1e-12), ("X1", 1e-12),
                        ("X2", 1e-12), ("p", 1e-11)):
            err = float((getattr(s_g, k) - getattr(s_f, k)).abs().max())
            assert err <= atol, (k, err)
        for k in ("phis", "J", "rho_local"):
            assert float((a_g[k] - a_f[k]).abs().max()) <= 1e-12, k



def test_exports_the_jax_names():
    """The advection and momentum-step names of the JAX package's public
    surface, and pyRMT's aliases of them."""
    import pyrmt_tpu as pj

    for name in ("advect_central2_rk3", "advect_reference_map",
                 "advect_reference_map_multi", "advect_semilagrangian_rk4",
                 "advect_semilagrangian_rk4_multi", "advect_weno5_rk3",
                 "momentum_step_rk4", "momentum_step_rk4_2solids",
                 "velocity_RK4", "advect_semi_lagrangian_rk4"):
        assert name in pt.__all__ and hasattr(pj, name), name
    assert pt.velocity_RK4 is pt.momentum_step_rk4
    assert pt.advect_semi_lagrangian_rk4 is pt.advect_semilagrangian_rk4
