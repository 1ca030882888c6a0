"""The port's pure-fluid step (no solid) against the JAX package's.

``make_step(phi_inits=())`` is the pure-fluid solver in both packages: no
solid block, the blends at S = 0 (no solid stress, Hf = 1, rho = rho_f)
into the RK4 update. 3 float64 steps of the lid-driven cavity
(``benchmarks/lid_driven_cavity.py``'s Re = 100 configuration, N=64) and
of the doubly-periodic Taylor-Green vortex
(``benchmarks/periodic_taylor_green.py``, N=65), from the same initial
state, the JAX step on its XLA paths with jit disabled: u, v to 1e-12, p to
1e-11, t to 1e-15, the empty stacks and the aux alike. Gravity leaves a
pure fluid at rest (tests/test_sim.py's case). The port's own Taylor-Green
gate at N=65 float64 to t = 0.5 holds the JAX gate's predicates
(tests/test_validation_gates.py: stable, decay-rate error < 1e-2, profile
error < 5e-3, divergence < 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as jbcs
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from pyrmt_tpu_torch.validation import taylor_green_decay
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

ATOL = {"u": 1e-12, "v": 1e-12, "p": 1e-11, "t": 1e-15, "step": 0}


def jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def lid_case():
    """benchmarks/lid_driven_cavity.py at Re = 100, N=64: the lid BC
    applied to the zero initial velocity."""
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=64, Ny=64, Lx=1.0, Ly=1.0),
                          mu_f=0.01, rho_f=1.0, CFL=0.2, dt_min_cap=1e-2,
                          bc_type="neumann", dct_method="fft")
    jbc = jbcs.make_lid_bc(1.0)
    js = jsim.make_init_state(jcfg, (), dtype=jnp.float64)
    u0, v0 = jbc(js.u, js.v)
    return jcfg, jbc, pt.make_lid_bc(1.0), dataclasses.replace(js, u=u0,
                                                              v=v0)


def tg_case():
    """benchmarks/periodic_taylor_green.py at N=65 with no solid."""
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=65, Ny=65, Lx=1.0, Ly=1.0),
                          mu_s=0.0, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                          bc_type="periodic", num_layers=3, CFL=0.3,
                          dt_min_cap=1e-3)
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    u0 = 0.5 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v0 = -0.5 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    js = jsim.make_init_state(jcfg, (), u0=u0, v0=v0, dtype=jnp.float64)
    return jcfg, jbcs.periodic_bc, pt.periodic_bc, js


@pytest.fixture(scope="module", params=["lid", "taylor_green"])
def runs(request):
    jcfg, jbc, tbc, js = (lid_case if request.param == "lid" else tg_case)()
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, jbc, (), dtype=jnp.float64)
        tcfg = port_config(jcfg)
        tstep = pt.make_step(tcfg, tbc, (), dtype=torch.float64, device=DEV)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        traj = []
        for _ in range(3):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            traj.append((jax_numpy(js), {k: np.asarray(v)
                                         for k, v in jaux.items()},
                         state_to_numpy(ts),
                         {k: v.numpy() for k, v in taux.items()}))
    return request.param, traj


@pytest.mark.parametrize("n", range(3))
def test_pure_fluid_step_matches_jax(runs, n):
    case, traj = runs
    js, jaux, ts, taux = traj[n]
    for k, atol in ATOL.items():
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                   err_msg=f"{case} step {n + 1}: {k}")
    for k in ("X1", "X2", "phis0"):
        assert ts[k].shape == js[k].shape == (0, *js["u"].shape), k
    for k in ("phis", "J", "sxx", "sxy", "syy"):
        assert taux[k].shape == jaux[k].shape, k
    np.testing.assert_allclose(taux["rho_local"], jaux["rho_local"], rtol=0,
                               atol=0)
    np.testing.assert_allclose(float(taux["dt"]), float(jaux["dt"]), rtol=0,
                               atol=1e-15)
    assert float(np.abs(ts["u"]).max()) > 0.1  # the flow moves


@pytest.mark.parametrize("bc_type", ["neumann", "periodic"])
def test_gravity_leaves_a_pure_fluid_at_rest(bc_type):
    """(rho_local - rho_f) g is 0 with no solid: the state stays at 0."""
    cfg = pt.RMTConfig(grid=pt.Grid(33, 33, 1.0, 1.0), mu_f=0.01, rho_f=1.0,
                       g_y=-1.0, CFL=0.2, dt_min_cap=1e-3, bc_type=bc_type)
    bc = pt.free_slip_box_bc if bc_type == "neumann" else pt.periodic_bc
    step = pt.make_step(cfg, bc, (), dtype=torch.float64, device=DEV)
    state = pt.make_init_state(cfg, (), dtype=torch.float64, device=DEV)
    for _ in range(3):
        state, _ = step(state, 10.0)
    assert float(state.u.abs().max()) == 0.0
    assert float(state.v.abs().max()) == 0.0
    assert int(state.step) == 3


@pytest.mark.parametrize("override", [
    dict(momentum_method="xla"), dict(eta_s=0.01),
    dict(momentum_method="xla", use_pallas_rhs=True),
    dict(projection_method="pallas")])
def test_pure_fluid_options_take_the_same_path(override):
    """On the CPU every momentum and projection option of the pure-fluid
    step computes the same update: the plain versions, with the constant
    blends (the Kelvin-Voigt mask is 0 with no solid)."""
    cfg = pt.RMTConfig(grid=pt.Grid(24, 24, 1.0, 1.0), mu_f=0.01,
                       CFL=0.2, dt_min_cap=1e-2)
    kw = dict(dtype=torch.float64, device=DEV)
    bc = pt.make_lid_bc(1.0)
    s = pt.make_init_state(cfg, (), **kw)
    a = b = dataclasses.replace(s, u=bc(s.u, s.v)[0])
    step_a = pt.make_step(cfg, bc, (), **kw)
    step_b = pt.make_step(dataclasses.replace(cfg, **override), bc, (), **kw)
    for _ in range(2):
        a, aux_a = step_a(a, 1.0)
        b, aux_b = step_b(b, 1.0)
    for k in ("u", "v", "p", "t"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert aux_a["J"].shape == (0, 24, 24)


def test_taylor_green_gate_on_the_cpu():
    """The JAX package's periodic Taylor-Green gate
    (tests/test_validation_gates.py:92-106) through the port's step."""
    rows, s = taylor_green_decay(N=65, nu=0.01, t_end=0.5,
                                 dtype=torch.float64, device=DEV)
    assert s["stable"]
    assert s["rate_rel_err"] < 1e-2, s
    assert s["profile_rel_err"] < 5e-3, s
    assert s["maxdiv"] < 1e-6, s
    assert len(rows) == 5 and rows[-1]["t"] == pytest.approx(0.5)
