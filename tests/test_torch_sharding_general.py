"""The general tier, sharded: ``make_sharded_step`` against ``pyrmt_tpu``'s
single-device step.

The configurations of tests/test_torch_general_step.py at N=64 float64:
``scheme='weno5'``, ``scheme='central2'``, the gather path
(``sl_local=False``) bilinear and bicubic, and CFL = 1.5 (a backtrace
longer than a cell), each from the JAX package's initial state with the
swirl of that file (the flagship disc in the lid-driven cavity). They run
in one gloo world of 8 CPU processes
(``pyrmt_tpu_torch.parallel.launch.run_world``), on the (2, 4) and (4, 1)
meshes, whose blocks hold the step's largest halo (16 cells), and are
held to ``pyrmt_tpu.sim.make_step`` on its XLA paths with jit disabled
over 3 steps: 1e-10 in u, v, p and 1e-11 in X1, X2, the sharded step's
tolerances. tests/test_torch_sharding_general_variants.py runs the
general tier's other configurations.

~60 s alone on 8 CPU cores.
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
from pyrmt_tpu_torch.parallel.launch import run_world
from test_torch_general_step import CFL_RECIPE, FLAGSHIP, j_disc, swirl
from test_torch_sharding_gspmd import compiled_loops
from test_torch_step import jax_numpy, port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
STEPS = 3
TOL = {"u": 1e-10, "v": 1e-10, "p": 1e-10, "X1": 1e-11, "X2": 1e-11}
XLA = dict(rmt_method="xla", momentum_method="xla", extrap_method="xla",
           dct_method="fft")
FLAGSHIP_DISC = [(0.6, 0.5, 0.2)]
# case: (flagship overrides, swirl amplitude, mesh)
CASES = {
    "weno5": (dict(scheme="weno5"), 0.5, (2, 4)),
    "central2": (dict(scheme="central2"), 0.5, (4, 1)),
    "gather_bilinear": (dict(sl_local=False), 0.5, (2, 4)),
    "gather_bicubic": (dict(sl_local=False, sl_interp="bicubic"), 0.5,
                       (4, 1)),
    "cfl_1.5": (CFL_RECIPE, 1.0, (2, 4)),
}


def jax_config(**overrides):
    """A configuration at N on the JAX package's XLA paths."""
    return jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0),
                          **dict(FLAGSHIP, **XLA, **overrides))


def run_cases(cases):
    """{name: (JAX config, JAX BC, port BC, discs, u0, v0, mesh)}: JAX's
    single-device runs (its initial and final states, each step's aux)
    and the port's sharded runs of every case in one world of 8 ranks."""
    jax_runs, port_cases = {}, []
    with jax.disable_jit(), compiled_loops(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bicubic gather's warning
        for name, (jcfg, jbc, tbc, discs, u0, v0, mesh) in cases.items():
            jphis = tuple(j_disc(*d) for d in discs)
            s = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0,
                                     dtype=jnp.float64)
            step = jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64)
            s0, auxes = jax_numpy(s), []
            for _ in range(STEPS):
                s, aux = step(s, jnp.asarray(1.0, jnp.float64))
                auxes.append({k: np.asarray(v) for k, v in aux.items()
                              if k in ("dt", "rebased")})
            jax_runs[name] = (s0, jax_numpy(s), auxes)
            port_cases.append(dict(
                cfg=port_config(jcfg), velocity_bc=tbc,
                phi_inits=tuple(pt.Disc(*d) for d in discs), steps=STEPS,
                dtype=torch.float64, device=DEV, mesh_shape=mesh,
                state0=s0, t_end=1.0))
    port = run_world(8, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                     dict(cases=port_cases), backend="gloo")[0]
    return jax_runs, dict(zip(cases, port))


def assert_matches_jax(jax_runs, port, name, mesh):
    r, (s0, want, _) = port[name], jax_runs[name]
    assert tuple(r["mesh"]) == mesh
    assert r["finite"]
    for k, tol in TOL.items():
        assert r["state"][k].shape == want[k].shape, k
        err = np.abs(r["state"][k] - want[k]).max(initial=0.0)
        assert err <= tol, (k, err)
    assert float(r["state"]["t"]) == pytest.approx(float(want["t"]),
                                                   abs=1e-15)
    assert int(r["state"]["step"]) == int(want["step"]) == STEPS
    # the maps moved
    assert float(np.abs(r["state"]["X1"] - s0["X1"]).max()) > 1e-4


def assert_general_paths(port, names):
    """The general tier on every rank: the scheme, extrapolate_fused's
    plain twin on slabs with offsets on a CPU state (no kernel launch),
    the RK4 plain twin on slabs with offsets (walls) or the stage loop on
    wrap-padded slabs (the periodic box)."""
    for name in names:
        r = port[name]
        paths = r["paths"]
        assert paths["solid"].startswith("general, "), name
        assert paths["solid"].endswith(
            ", extrapolate_fused plain twin on slabs with offsets"), name
        assert paths["momentum"] in (
            "rk4 plain twin on slabs with offsets",
            "stage loop on wrap-padded slabs"), name
        assert paths["halo"] == "direct"
        assert paths["mesh"] == "{}x{} gloo".format(*r["mesh"])
        for rank in r["launches"]:
            assert not any(rank.values()), (name, rank)


@pytest.fixture(scope="module")
def runs():
    cases = {}
    for name, (over, amp, mesh) in CASES.items():
        jcfg = jax_config(**over)
        cases[name] = (jcfg, j_lid_bc(1.0), pt.make_lid_bc(1.0),
                       FLAGSHIP_DISC, *swirl(jcfg, amp), mesh)
    return run_cases(cases)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_general_tier_matches_jax_single_device(runs, name):
    assert_matches_jax(*runs, name, CASES[name][2])


def test_sharded_general_paths(runs):
    """Each case names its scheme; CFL 1.5 takes the gather path with a
    backtrace longer than a cell."""
    jax_runs, port = runs
    assert_general_paths(port, CASES)
    for name, scheme in (("weno5", "weno5"), ("central2", "central2"),
                         ("gather_bilinear", "semilagrangian bilinear"),
                         ("gather_bicubic", "semilagrangian bicubic"),
                         ("cfl_1.5", "semilagrangian bilinear")):
        assert port[name]["paths"]["solid"].startswith(
            f"general, {scheme}"), name
    u0 = np.abs(jax_runs["cfl_1.5"][0]["u"]).max()
    dt = float(jax_runs["cfl_1.5"][2][0]["dt"])
    assert u0 * dt * (N - 1) > 1.0
