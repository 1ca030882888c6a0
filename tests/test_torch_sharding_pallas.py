"""The port's sharded step against ``pyrmt_tpu``'s sharded step on its
shard_map Pallas path (``make_sharded_step(..., rmt_method='pallas',
interpret=True)``: the fused kernels per shard with the sharding offsets,
interpret mode on the 8-device virtual CPU mesh) and its single-device
step, on the (4, 1) mesh of the flagship (blocks of 16 rows, the exchange
halo's width), as tests/test_sharding.py:67-104 runs it: 2 steps, u, v
and p to 1e-10, X1 and X2 to 1e-11 (the (2, 2) mesh:
tests/test_torch_sharding_pallas_2d.py, a file of its own so that the two
run side by side).

The port runs in a gloo world of 4 CPU ranks (``parallel.launch.
run_world``) on the solid-block and RK4 kernels' path (on a CPU state,
their plain twins with the sharding offsets). The JAX sharded step
compiles its interpret-mode kernels for ~70 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu.parallel import make_sharded_step as j_make_sharded_step
from pyrmt_tpu_torch.parallel.launch import run_world
from test_torch_step import jax_numpy, port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
FIELDS = dict(mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0, rho_s=1.0,
              num_layers=3, CFL=0.2, dt_min_cap=1e-3)
STEPS = 2


def j_disc(x0, y0, R):
    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R

    return phi


def pallas_runs(shape, disc):
    """(JAX single-device state, JAX sharded state, the port's result)
    after STEPS steps of the flagship with ``disc`` on a ``shape`` mesh."""
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), **FIELDS)
    phis = (j_disc(*disc),)
    step1 = jsim.make_step(jcfg, j_free_slip, phis, dtype=jnp.float64)
    s0 = jsim.make_init_state(jcfg, phis, dtype=jnp.float64)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(shape), ("gy", "gx"))
    stepN, shard = j_make_sharded_step(
        jcfg, j_free_slip, phis, mesh, dtype=jnp.float64,
        rmt_method="pallas", interpret=True)
    ref, sh = s0, shard(s0)
    for _ in range(STEPS):
        ref, _ = step1(ref, jnp.asarray(1.0))
        sh, _ = stepN(sh, jnp.asarray(1.0))
    case = dict(cfg=port_config(jcfg), velocity_bc=pt.free_slip_box_bc,
                phi_inits=(pt.Disc(*disc),), steps=STEPS, dtype=torch.float64,
                device=DEV, mesh_shape=shape, rmt_method="pallas",
                state0=jax_numpy(s0))
    port = run_world(4, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                     dict(cases=[case]), backend="gloo")[0][0]
    return ref, sh, port


def check_against(runs, shape, against):
    single, sharded, port = runs
    ref = sharded if against == "jax sharded pallas" else single
    assert tuple(port["mesh"]) == shape
    for k, tol in (("u", 1e-10), ("v", 1e-10), ("p", 1e-10), ("X1", 1e-11),
                   ("X2", 1e-11)):
        err = np.abs(port["state"][k] - np.asarray(getattr(ref, k)))
        assert err.max() <= tol, (k, err.max())


def check_paths(port, shape):
    """The port took the solid-block and RK4 kernels' sharded path (on a
    CPU state their twins with the offsets), the halo exchanged directly."""
    paths = port["paths"]
    assert paths["solid"] == "fused, kernel on slabs with offsets"
    assert paths["momentum"] == "rk4 kernel on slabs with offsets"
    assert paths["mesh"] == f"{shape[0]}x{shape[1]} gloo"
    assert paths["halo"] == "direct"


@pytest.fixture(scope="module")
def runs():
    return pallas_runs((4, 1), (0.5, 0.5, 0.2))


@pytest.mark.parametrize("against", ["jax sharded pallas", "jax single"])
def test_sharded_4x1_matches_jax(runs, against):
    check_against(runs, (4, 1), against)


def test_sharded_4x1_kernel_paths(runs):
    check_paths(runs[2], (4, 1))
