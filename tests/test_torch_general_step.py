"""The port's general tier (WENO5, central2, the semi-Lagrangian gather
path) against ``pyrmt_tpu.sim.make_step``.

N=48 in float64, the flagship disc (0.6, 0.5, R 0.2) in the lid-driven
cavity with a swirl u = A sin(pi x) cos(pi y), v = -A cos(pi x) sin(pi y)
added, so that the map moves from the first step. JAX builds its step on
its XLA paths (its unfused tier, which the port's general tier follows op
for op) and runs it with jit disabled; the port starts from
``state_from_numpy`` of the JAX initial state. Three steps each of
``scheme='weno5'``, ``scheme='central2'``, ``sl_local=False`` bilinear and
bicubic (both packages warn alike) and CFL = 1.5 (mu_f 1e-4, mu_s 0.01,
kappa 1, eta_s 0, dt_min_cap 1: the backtrace leaves the 3x3 neighbourhood,
max |u| dt / dx > 1 on the steps compared), then a no-op step past t_end.
Per step u, v, X1, X2 agree to 1e-12, p to 1e-11, t to 1e-15, the step
count exactly, and the aux fields (phis, J, the stresses, rho_local) to
1e-12, on the no-op step too: the general tier freezes the maps before
its rebuild, as the JAX unfused step does. More configurations are in
tests/test_torch_general_variants.py.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import state_from_numpy, state_to_numpy
from test_torch_step import jax_numpy, port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 48
STEPS = 3
ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "phis0": 1e-12,
        "p": 1e-11, "t": 1e-15, "step": 0}
AUX = ("phis", "J", "sxx", "sxy", "syy", "rho_local")
FLAGSHIP = dict(mu_s=0.1, eta_s=0.01, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                num_layers=3, CFL=0.2, dt_min_cap=1e-3)
# CFL >= 1 that the caps let through: dt ~ 1.49 dx from the solid's P-wave
# limit, so |u| = 1 moves the map 1.49 cells a step
CFL_RECIPE = dict(CFL=1.5, mu_f=1e-4, mu_s=0.01, kappa=1.0, eta_s=0.0,
                  dt_min_cap=1.0)
CASES = {
    "weno5": (dict(scheme="weno5"), 0.5),
    "central2": (dict(scheme="central2"), 0.5),
    "gather_bilinear": (dict(sl_local=False), 0.5),
    "gather_bicubic": (dict(sl_local=False, sl_interp="bicubic"), 0.5),
    "cfl_1.5": (CFL_RECIPE, 1.0),
}
_RUNS = {}


def j_disc(x0, y0, R):
    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R
    return phi


def jax_config(n=N, **overrides):
    """A configuration on the JAX package's XLA paths."""
    kw = dict(FLAGSHIP, rmt_method="xla", momentum_method="xla",
              extrap_method="xla", dct_method="fft")
    kw.update(overrides)
    return jsim.RMTConfig(grid=JGrid(Nx=n, Ny=n, Lx=1.0, Ly=1.0), **kw)


def swirl(jcfg, amp):
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    return (amp * jnp.sin(jnp.pi * X) * jnp.cos(jnp.pi * Y),
            -amp * jnp.cos(jnp.pi * X) * jnp.sin(jnp.pi * Y))


def run_both(jcfg, jbc, tbc, discs, u0, v0, steps=STEPS, noop=False):
    """Both packages' (state, aux) after each step, from the JAX initial
    state (the first entry: that state, no aux); with ``noop`` one more
    step with t_end at the current t. Also the port's step and the
    warnings each package's make_step gave."""
    with jax.disable_jit(), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        jstep = jsim.make_step(jcfg, jbc, tuple(j_disc(*d) for d in discs),
                               dtype=jnp.float64)
        n_j = len(rec)
        tstep = pt.make_step(port_config(jcfg), tbc,
                             tuple(pt.Disc(*d) for d in discs),
                             dtype=torch.float64, device=DEV)
        warned = ([str(w.message) for w in rec[:n_j]],
                  [str(w.message) for w in rec[n_j:]])
        js = jsim.make_init_state(jcfg, tuple(j_disc(*d) for d in discs),
                                  u0=u0, v0=v0, dtype=jnp.float64)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        traj = [(jax_numpy(js), None, state_to_numpy(ts), None)]
        for n in range(steps + int(noop)):
            t_end = float(js.t) if n == steps else 1.0
            js, jaux = jstep(js, jnp.asarray(t_end, jnp.float64))
            ts, taux = tstep(ts, t_end)
            traj.append((jax_numpy(js), {k: np.asarray(v)
                                         for k, v in jaux.items()},
                         state_to_numpy(ts), taux))
    return tstep, traj, warned


def assert_step_matches(traj, n, what):
    """Step n + 1 (traj[n + 1]) of both packages agrees."""
    js, jaux, ts, taux = traj[n + 1]
    for k, atol in ATOL.items():
        if k in js and np.asarray(js[k]).size:
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                       err_msg=f"{what} step {n + 1}: {k}")
    np.testing.assert_allclose(float(taux["dt"]), float(jaux["dt"]), rtol=0,
                               atol=1e-15)
    assert set(taux) == set(jaux), what
    for k in AUX:
        np.testing.assert_allclose(taux[k].numpy(), jaux[k], rtol=0,
                                   atol=1e-12, err_msg=f"{what} aux {k}")
    if "rebased" in jaux:
        assert np.array_equal(taux["rebased"].numpy(), jaux["rebased"])


def trajectories(case):
    if case not in _RUNS:
        over, amp = CASES[case]
        jcfg = jax_config(**over)
        _RUNS[case] = run_both(jcfg, j_lid_bc(1.0), pt.make_lid_bc(1.0),
                               [(0.6, 0.5, 0.2)], *swirl(jcfg, amp),
                               noop=case == "weno5")
    return _RUNS[case]


@pytest.mark.parametrize("n", range(STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case, n):
    tstep, traj, _ = trajectories(case)
    assert tstep.paths["solid"] == "general"
    assert_step_matches(traj, n, case)
    before, (_, _, after, aux) = traj[n][2], traj[n + 1]
    assert not np.array_equal(after["X1"], before["X1"]), "no motion"
    # the largest displacement of the step's backtrace, in cells
    cells = float(np.abs(before["u"]).max()) * float(aux["dt"]) * (N - 1)
    assert (cells > 1.0) == (case == "cfl_1.5"), cells


def test_noop_step_matches_jax():
    """The step past t_end: the state frozen exactly, and the aux fields
    those of the unchanged maps, as in the JAX unfused step."""
    _, traj, _ = trajectories("weno5")
    assert_step_matches(traj, STEPS, "weno5 no-op")
    last, noop = traj[STEPS][2], traj[STEPS + 1][2]
    assert float(traj[STEPS + 1][3]["dt"]) == 0.0
    for k in ("u", "v", "p", "X1", "X2", "t", "step"):
        assert np.array_equal(noop[k], last[k]), k


def test_bicubic_gather_warns_as_jax():
    _, _, (jwarn, twarn) = trajectories("gather_bicubic")
    assert len(jwarn) == 1 and "sl_interp='bicubic'" in jwarn[0]
    assert twarn == jwarn


def test_unknown_scheme_raises_as_jax():
    """JAX raises at its first step (when jit traces), the port at
    make_step: the same class and message; with no solid neither
    advects, and neither raises."""
    jcfg = jax_config(n=16, scheme="upwind")
    jstep = jsim.make_step(jcfg, j_lid_bc(1.0), (j_disc(0.6, 0.5, 0.2),),
                           dtype=jnp.float64)
    js = jsim.make_init_state(jcfg, (j_disc(0.6, 0.5, 0.2),),
                              dtype=jnp.float64)
    with pytest.raises(ValueError) as jerr:
        jstep(js, jnp.asarray(1.0, jnp.float64))
    with pytest.raises(ValueError) as terr:
        pt.make_step(port_config(jcfg), pt.make_lid_bc(1.0),
                     (pt.Disc(0.6, 0.5, 0.2),), dtype=torch.float64,
                     device=DEV)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)
    step = pt.make_step(port_config(jcfg), pt.make_lid_bc(1.0), (),
                        dtype=torch.float64, device=DEV)
    assert step.paths["solid"] == "none"


def test_paths_of_the_general_tier():
    """Every configuration the gather-free backtrace does not take runs the
    general tier, whatever else it sets; the others keep their tiers."""
    g = pt.Grid(16, 16, 1.0, 1.0)
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    for over, solid in ((dict(scheme="weno5"), "general"),
                        (dict(scheme="central2", phi_area_fix=True),
                         "general"),
                        (dict(sl_local=False, map_rebase_minj=0.5),
                         "general"),
                        (dict(CFL=1.0), "general"),
                        (dict(CFL=0.99), "fused"),
                        (dict(CFL=0.99, reinit_method="pde"), "split")):
        step = pt.make_step(pt.RMTConfig(grid=g, **over), pt.make_lid_bc(1.0),
                            disc, dtype=torch.float64, device=DEV)
        assert step.paths == {"solid": solid, "momentum": "rk4 kernel",
                              "projection": "stencils"}, over


def test_runners_run_the_general_tier():
    """make_rebase_runner (2-step chunks; the pre-phase chunk ends with
    min J < 10, so the runner rebases and switches) against the JAX
    package's on WENO5, and make_run_chunk against 3 steps."""
    jcfg = jax_config(scheme="weno5", mu_s=0.02, map_rebase_minj=10.0)
    jphi = (j_disc(0.6, 0.5, 0.2),)
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    kw = dict(dtype=torch.float64, device=DEV)
    with jax.disable_jit():
        jrun = jsim.make_rebase_runner(jcfg, j_lid_bc(1.0), jphi, 2,
                                       dtype=jnp.float64)
        js = jsim.make_init_state(jcfg, jphi, *swirl(jcfg, 0.5),
                                  dtype=jnp.float64)
        trun = pt.make_rebase_runner(port_config(jcfg), pt.make_lid_bc(1.0),
                                     disc, 2, **kw)
        assert trun.pre_step.paths["solid"] == "general"
        ts = state_from_numpy(jax_numpy(js), **kw)
        for chunk in range(2):
            js, jt = jrun(js, jnp.asarray(1.0, jnp.float64))
            ts, tt = trun(ts, 1.0)
            jn, tn = jax_numpy(js), state_to_numpy(ts)
            for k, atol in ATOL.items():
                np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=atol,
                                           err_msg=f"chunk {chunk + 1}: {k}")
            assert float(tt) == float(jt) and trun.post
    step = pt.make_step(port_config(jax_config(scheme="weno5")),
                        pt.make_lid_bc(1.0), disc, **kw)
    s = s0 = state_from_numpy(jax_numpy(js), **kw)
    for _ in range(3):
        s, _ = step(s, 1.0)
    chunk, t = pt.make_run_chunk(step, 3, donate=True)(s0, 1.0)
    assert torch.equal(chunk.X1, s.X1) and torch.equal(chunk.u, s.u)
    assert torch.equal(t, s.t)
