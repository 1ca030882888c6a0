"""More of the general tier, sharded: the configurations of
tests/test_torch_general_variants.py at N=64 float64, on the recipe of
tests/test_torch_sharding_general.py (one gloo world of 8 CPU processes,
3 steps from the JAX package's initial state, held to
``pyrmt_tpu.sim.make_step`` on its XLA paths with jit disabled, its
fast-sweeping redistance jitted alone, at 1e-10 in u, v, p and 1e-11 in
X1, X2):

- ``scheme='weno5'`` with the area fix and PDE reinitialisation, on the
  (2, 4) mesh;
- ``scheme='weno5'`` on the contact configuration
  (benchmarks/two_disc_contact.py's, free slip) with two discs whose
  contact bands touch from the first step, on the (4, 1) mesh;
- ``scheme='central2'`` on the doubly-periodic box (the flagship disc, a
  Taylor-Green seed), on the (2, 4) mesh: the advection's and the
  extrapolation's halo beyond the domain is zeros, not the wrap halo;
- ``scheme='weno5'`` with map rebasing in 'cond' mode, firing on every
  step (``map_rebase_minj=10``), on the (4, 1) mesh;
- ``scheme='central2'`` with the balanced-force CSF (gamma 0.1, the
  capillary drop's settings, free slip), on the (2, 4) mesh.

~80 s alone on 8 CPU cores.
"""
import jax.numpy as jnp
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.bcs import periodic_bc as j_periodic
from test_torch_general_step import swirl
from test_torch_general_variants import CAPILLARY, CONTACT, TOUCHING, approach
from test_torch_sharding_general import (
    FLAGSHIP_DISC,
    STEPS,
    assert_general_paths,
    assert_matches_jax,
    jax_config,
    run_cases,
)

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

# case: mesh
CASES = {"weno5_areafix_reinit": (2, 4), "weno5_contact": (4, 1),
         "central2_periodic": (2, 4), "weno5_rebase_cond": (4, 1),
         "central2_balanced_csf": (2, 4)}


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


@pytest.fixture(scope="module")
def runs():
    return run_cases({name: (*case_args(name), mesh)
                      for name, mesh in CASES.items()})


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_general_variant_matches_jax_single_device(runs, name):
    assert_matches_jax(*runs, name, CASES[name])


def test_sharded_general_variant_paths(runs):
    """The general tier on every rank; the balanced CSF's forces on their
    halo slabs and its faces into the projection; the periodic box's FFT
    solve and momentum stage loop; the contact step's RK4 update."""
    _, port = runs
    assert_general_paths(port, CASES)
    paths = {name: port[name]["paths"] for name in CASES}
    assert paths["central2_balanced_csf"]["forces"].startswith(
        "surface tension (balanced CSF")
    assert paths["central2_balanced_csf"]["projection"] == (
        "stencils and face forces on halo slabs, distributed DCT")
    assert paths["central2_periodic"]["projection"] == (
        "wrap-padded stencils, distributed FFT")
    assert paths["central2_periodic"]["momentum"] == (
        "stage loop on wrap-padded slabs")
    assert paths["weno5_contact"]["momentum"] == (
        "rk4 plain twin on slabs with offsets")


def test_sharded_general_rebase_fires_on_every_step(runs):
    """The least J is a min over the ranks: every step rebases, as in
    JAX's single-device step."""
    jax_runs, port = runs
    assert port["weno5_rebase_cond"]["rebased"] == [[True]] * STEPS
    assert all(bool(a["rebased"].all())
               for a in jax_runs["weno5_rebase_cond"][2])
