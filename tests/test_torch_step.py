"""The ported slice against ``pyrmt_tpu.sim.make_step``.

The flagship (``__graft_entry__._flagship``) at N=64 in float64: JAX builds
its step on the XLA paths (the twins its Pallas kernels are pinned to), the
port starts from ``state_from_numpy`` of the same initial state, and the two
run 5 steps, the 4th clipped by t_end and the 5th a no-op. u, v, X1, X2
agree to 1e-12, p to 1e-11, t to 1e-15 and the step count exactly. On the
no-op step only the state is compared: the port's aux reflects the trial
step, as on the JAX fused path, and the JAX XLA path's does not.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from __graft_entry__ import _flagship
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
DISC = pt.Disc(0.6, 0.5, 0.2)
ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "p": 1e-11,
        "t": 1e-15, "step": 0}


def port_config(jcfg):
    """The port's RMTConfig from the JAX config's field values."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "grid"}
    g = jcfg.grid
    return pt.RMTConfig(grid=pt.Grid(g.Nx, g.Ny, g.Lx, g.Ly), **fields)


def jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


@pytest.fixture(scope="module")
def runs():
    """Both packages' 5-step trajectories; the JAX step compiles once."""
    jcfg, jbc, jphis = _flagship(N, jnp.float64)
    jcfg = dataclasses.replace(jcfg, rmt_method="xla", momentum_method="xla",
                               extrap_method="xla", dct_method="fft")
    jstep = jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64)
    js = jsim.make_init_state(jcfg, jphis, dtype=jnp.float64)
    tcfg = port_config(jcfg)
    tstep = pt.make_step(tcfg, pt.make_lid_bc(1.0), (DISC,),
                         dtype=torch.float64, device=DEV)
    ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
    j_traj, t_traj = [], []
    t_end = 1.0
    for n in range(5):
        if n == 3:  # clip the 4th step at 40% of the previous dt
            t_end = float(js.t) + 0.4 * float(j_traj[-1][1]["dt"])
        js, jaux = jstep(js, jnp.asarray(t_end, jnp.float64))
        ts, taux = tstep(ts, t_end)
        j_traj.append((jax_numpy(js), {k: np.asarray(v)
                                       for k, v in jaux.items()}))
        t_traj.append((state_to_numpy(ts), taux))
    return jcfg, tcfg, j_traj, t_traj


@pytest.mark.parametrize("n", range(5))
def test_step_matches_jax(runs, n):
    _, _, j_traj, t_traj = runs
    (js, jaux), (ts, taux) = j_traj[n], t_traj[n]
    for k, atol in ATOL.items():
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                   err_msg=f"step {n + 1}: {k}")
    np.testing.assert_allclose(float(taux["dt"]), float(jaux["dt"]), rtol=0,
                               atol=1e-15)
    if n < 4:  # aux on active steps only
        for k in ("phis", "J", "sxx", "sxy", "syy", "rho_local"):
            np.testing.assert_allclose(taux[k].numpy(), jaux[k], rtol=0,
                                       atol=1e-12, err_msg=f"aux {k}")


def test_clipped_and_noop_steps(runs):
    _, _, j_traj, t_traj = runs
    s3, s4, s5 = (t_traj[n][0] for n in (2, 3, 4))
    dt3 = float(t_traj[2][1]["dt"])
    np.testing.assert_allclose(float(t_traj[3][1]["dt"]), 0.4 * dt3,
                               rtol=1e-12)
    assert int(s4["step"]) == 4 and int(s5["step"]) == 4
    assert float(t_traj[4][1]["dt"]) == 0.0
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert np.array_equal(s5[k], s4[k]), k  # frozen exactly
    assert not np.array_equal(s4["u"], s3["u"])


def test_init_state_matches_jax(runs):
    jcfg, tcfg, _, _ = runs
    js = jsim.make_init_state(jcfg, _flagship(N, jnp.float64)[2],
                              dtype=jnp.float64)
    ts = state_to_numpy(pt.make_init_state(tcfg, (DISC,),
                                           dtype=torch.float64, device=DEV))
    for k in STATE_FIELDS:
        np.testing.assert_allclose(ts[k], np.asarray(getattr(js, k)),
                                   rtol=0, atol=1e-13, err_msg=k)


def test_run_chunk_and_run_until():
    cfg = pt.RMTConfig(grid=pt.Grid(32, 32, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,),
                        dtype=torch.float64, device=DEV)
    s0 = pt.make_init_state(cfg, (DISC,), dtype=torch.float64, device=DEV)
    s = s0
    for _ in range(3):
        s, _ = step(s, 1.0)
    chunk, t = pt.make_run_chunk(step, 3)(s0, 1.0)
    assert torch.equal(chunk.u, s.u) and torch.equal(t, s.t)
    t_end = float(s.t)
    s_u, div = pt.run_until(step, s0, t_end)
    assert not div and float(s_u.t) == t_end and int(s_u.step) == 3
    assert not bool(pt.diverged(s_u))
    s_u.u[3, 3] = float("nan")
    assert bool(pt.diverged(s_u))


def test_fixed_dt():
    cfg = pt.RMTConfig(grid=pt.Grid(32, 32, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, fixed_dt=1e-4)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,),
                        dtype=torch.float64, device=DEV)
    s, aux = step(pt.make_init_state(cfg, (DISC,), dtype=torch.float64,
                                     device=DEV), 1.0)
    assert float(aux["dt"]) == 1e-4 and float(s.t) == 1e-4


# reinitialisation, the area fix, rebasing, the opt-in RHS and projection
# kernels, gravity, the periodic box, bicubic sampling, the band-mode
# stress, surface tension and variable density came into the slice: their
# entries hold them with a feature still outside it
@pytest.mark.parametrize("override", [
    dict(scheme="weno5"),
    dict(bc_type="periodic", sl_interp="bicubic", gamma=0.1, CFL=1.5),
    dict(reinit_method="pde", sl_local=False),
    dict(sl_interp="bicubic", sl_local=False),
    dict(gamma=0.1, st_method="balanced", sl_local=False),
    dict(g_y=-1.0, bc_type="periodic", variable_rho=True, scheme="weno5"),
    dict(variable_rho=True, CFL=1.5),
    dict(stress_band=True, variable_rho=True, scheme="weno5"),
    dict(phi_area_fix=True, sl_interp="bicubic", gamma=0.1, sl_local=False),
    dict(map_rebase_minj=0.5, bc_type="periodic", stress_band=True,
         scheme="weno5"),
    dict(CFL=1.5),
    dict(momentum_method="xla", use_pallas_rhs=True, gamma=0.1, CFL=1.5),
    dict(projection_method="pallas", variable_rho=True, scheme="weno5"),
    dict(dct_precision="default"),
])
def test_configs_outside_the_slice_raise(override):
    cfg = pt.RMTConfig(grid=pt.Grid(16, 16, 1.0, 1.0), **override)
    err = ValueError if "dct_precision" in override else NotImplementedError
    with pytest.raises(err):
        pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), device=DEV)


def test_bad_configs_raise():
    g = pt.Grid(16, 16, 1.0, 1.0)
    with pytest.raises(TypeError):
        pt.RMTConfig(grid=g, not_a_field=1.0)
    for bad in (dict(rmt_method="fast"), dict(reinit_method="bogus"),
                dict(map_rebase_minj=0.5, map_rebase_rebuild="bogus"),
                dict(st_method="bogus"), dict(st_curvature="bogus"),
                dict(bc_type="dirichlet")):
        with pytest.raises(ValueError):
            pt.make_step(pt.RMTConfig(grid=g, **bad), pt.make_lid_bc(1.0),
                         (DISC,), device=DEV)
    with pytest.raises(ValueError):  # 1 layer cannot cover the blend band
        pt.make_step(pt.RMTConfig(grid=g, num_layers=1), pt.make_lid_bc(1.0),
                     (DISC,), device=DEV)
    # no solid is the pure-fluid step (it was modules item 18)
    step = pt.make_step(pt.RMTConfig(grid=g, mu_f=0.01), pt.make_lid_bc(1.0),
                        (), dtype=torch.float64, device=DEV)
    s, aux = step(pt.make_init_state(pt.RMTConfig(grid=g), (),
                                     dtype=torch.float64, device=DEV), 1.0)
    assert aux["J"].shape == (0, 16, 16) and float(s.u.abs().max()) > 0.0


@pytest.mark.parametrize("bad", [dict(st_method="bogus"),
                                 dict(st_curvature="bogus")],
                         ids=["st_method", "st_curvature"])
def test_bad_surface_tension_options_raise_as_in_jax(bad):
    """An unknown surface-tension option raises ValueError in both packages,
    with surface tension off (gamma = 0) too."""
    jcfg, jbc, jphis = _flagship(16, jnp.float64)
    jcfg = dataclasses.replace(jcfg, gamma=0.0, **bad)
    with pytest.raises(ValueError):
        jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64)
    with pytest.raises(ValueError):
        pt.make_step(port_config(jcfg), pt.make_lid_bc(1.0), (DISC,),
                     dtype=torch.float64, device=DEV)
