"""The port's split-tier step against ``pyrmt_tpu.sim.make_step``.

The recipe of tests/test_pallas.py's split-tier tests: N=64 in float64, a
soft disc at (0.55, 0.5) in the lid-driven cavity, a Taylor-Green initial
velocity, 3 steps. JAX builds its step on the XLA paths (the twins its
Pallas kernels are pinned to); the port starts from ``state_from_numpy`` of
the same initial state. The JAX step runs with jit disabled: compiling it
takes 30-50 s per configuration on the CPU, running it op by op a few
seconds. Per step u, v, X1, X2 and phis0 agree to 1e-12, p to 1e-11, t to
1e-15, the step count exactly, and the aux phi and J to 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
STEPS = 3
ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "phis0": 1e-12,
        "p": 1e-11, "t": 1e-15, "step": 0}
DISC = (0.55, 0.5, 0.2)


def j_phi(X, Y):
    x0, y0, R = DISC
    return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R


def jax_config(**overrides):
    """The split-tier recipe config on the JAX package's XLA paths."""
    kw = dict(mu_s=0.05, rho_s=1.0, mu_f=0.01, rho_f=1.0, num_layers=3,
              CFL=0.2, dt_min_cap=1e-3, rmt_method="xla",
              momentum_method="xla", extrap_method="xla", dct_method="fft")
    kw.update(overrides)
    return jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), **kw)


def jax_init(jcfg):
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    u0 = 0.4 * jnp.sin(jnp.pi * X) * jnp.cos(jnp.pi * Y)
    v0 = -0.4 * jnp.cos(jnp.pi * X) * jnp.sin(jnp.pi * Y)
    return jsim.make_init_state(jcfg, (j_phi,), u0=u0, v0=v0,
                                dtype=jnp.float64)


def jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def aux_numpy(aux):
    return {k: np.asarray(v) for k, v in aux.items()}


def trajectories(jcfg, steps=STEPS, port_init=False):
    """Both packages' states and aux after each of ``steps`` steps, from
    the JAX initial state, or with ``port_init`` from the port's own
    ``make_init_state`` with the same velocity."""
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, j_lid_bc(1.0), (j_phi,),
                               dtype=jnp.float64)
        js = jax_init(jcfg)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        tcfg = port_config(jcfg)
        if port_init:
            ts = pt.make_init_state(tcfg, (pt.Disc(*DISC),), u0=ts.u,
                                    v0=ts.v, dtype=torch.float64, device=DEV)
        tstep = pt.make_step(tcfg, pt.make_lid_bc(1.0),
                             (pt.Disc(*DISC),), dtype=torch.float64,
                             device=DEV)
        j_traj, t_traj = [], []
        for _ in range(steps):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            j_traj.append((jax_numpy(js), aux_numpy(jaux)))
            t_traj.append((state_to_numpy(ts), aux_numpy(taux)))
    return j_traj, t_traj


def assert_trajectories_match(j_traj, t_traj):
    for n, ((js, jaux), (ts, taux)) in enumerate(zip(j_traj, t_traj)):
        for k, atol in ATOL.items():
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                       err_msg=f"step {n + 1}: {k}")
        for k in ("phis", "J"):
            np.testing.assert_allclose(taux[k], jaux[k], rtol=0, atol=1e-12,
                                       err_msg=f"step {n + 1}: aux {k}")
        if "rebased" in jaux:
            assert np.array_equal(taux["rebased"], jaux["rebased"]), n


CONFIGS = {
    "area_fix": dict(phi_area_fix=True),
    "pde": dict(reinit_method="pde", reinit_iters=5),
    "fmm": dict(reinit_method="fmm"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_matches_jax(name):
    jcfg = jax_config(**CONFIGS[name])
    assert pt.sim.rmt_block_split_eligible(port_config(jcfg), 1)
    j_traj, t_traj = trajectories(jcfg)
    assert_trajectories_match(j_traj, t_traj)
    # the steps moved the disc
    assert not np.array_equal(t_traj[-1][0]["X1"], t_traj[0][0]["X1"])


def test_area_fix_holds_the_area():
    """With the area fix the smoothed solid area of the step's phi stays at
    its t=0 value to Newton precision; without it, it drifts."""
    from pyrmt_tpu_torch.ops.levelset import smoothed_solid_area

    cfg = port_config(jax_config(phi_area_fix=True))
    g = cfg.grid
    disc = pt.Disc(*DISC)
    X, Y = g.coords(dtype=torch.float64, device=DEV)
    target = float(smoothed_solid_area(disc(X, Y), g.dx, g.dy, cfg.w_t))
    kw = dict(dtype=torch.float64, device=DEV)
    misses = []
    for c in (cfg, dataclasses.replace(cfg, phi_area_fix=False,
                                       reinit_method="pde")):
        step = pt.make_step(c, pt.make_lid_bc(1.0), (disc,), **kw)
        s = pt.make_init_state(c, (disc,), u0=0.4 * torch.sin(torch.pi * X),
                               **kw)
        for _ in range(5):
            s, aux = step(s, 1.0)
        misses.append(abs(float(smoothed_solid_area(aux["phis"][0], g.dx,
                                                    g.dy, c.w_t)) - target))
    assert misses[0] < 1e-10 * target < misses[1]


def test_split_tier_takes_any_level_set():
    """The split tier evaluates phi_init only in plain ops, so a shape
    without kernel_spec runs (an ellipse); the fused tier's kernel needs a
    Disc on the card, as before."""
    def ellipse(X1, X2):
        return torch.sqrt(((X1 - 0.5) / 1.3) ** 2 + (X2 - 0.5) ** 2) - 0.15

    cfg = pt.RMTConfig(grid=pt.Grid(32, 32, 1.0, 1.0), mu_s=0.1, mu_f=0.01,
                       reinit_method="pde")
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (ellipse,),
                        dtype=torch.float64, device=DEV)
    s = pt.make_init_state(cfg, (ellipse,), dtype=torch.float64, device=DEV)
    for _ in range(2):
        s, aux = step(s, 1.0)
    assert not bool(pt.diverged(s)) and int(s.step) == 2
