"""Multi-GPU domain decomposition: the port's sharded step against
``pyrmt_tpu``'s single-device step.

The port's ranks run in a gloo world of 8 CPU processes
(``pyrmt_tpu_torch.parallel.launch.run_world``: a fresh interpreter per
rank, which imports the port alone, and a ``file://`` rendezvous), all
cases of the (2, 4) mesh in one world; each starts from the JAX package's
initial state. Each case mirrors one of tests/test_sharding.py and is held
to ``pyrmt_tpu.sim.make_step`` over the same steps at that test's
tolerances (2 steps: u, v and p 1e-10, X1 and X2 1e-11; 12 steps: 1e-9 and
1e-10):

- the (2, 4) mesh with an off-centre disc (the solid-block kernel's path,
  ``rmt_method='pallas'``, which on a CPU state is its plain twin with the
  sharding offsets: blocks of 16 columns, the exchange halo's width);
- the bicubic sample on the default mesh of 8 ranks;
- two solids in contact on (2, 4), both ``rmt_method``s, the contact force
  active across the blocks' edges;
- a 12-step horizon on (2, 4);
- a pure fluid (no solid) on (2, 4), its empty stacks gathered back with
  the whole grid's shape.

Without a world: ``mesh_shape``'s factoring, the two ValueErrors of an
explicit 'pallas' (a mesh too tight for the halo, a configuration the
fused tier does not take) and the configurations that JAX shards by
GSPMD alone, which build on a mesh (test_torch_sharding_gspmd.py and
test_torch_sharding_st*.py run them). tests/test_torch_sharding_
pallas.py and test_torch_sharding_pallas_2d.py hold the (4, 1) and (2, 2)
meshes to JAX's sharded step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.parallel import Mesh, make_sharded_step, mesh_shape
from pyrmt_tpu_torch.parallel.launch import run_world
from test_torch_step import jax_numpy, port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
G = JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
FLAGSHIP = dict(mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0, rho_s=1.0,
                num_layers=3, CFL=0.2, dt_min_cap=1e-3)
CONTACT = dict(mu_s=1.0, rho_s=1.0, mu_f=0.01, rho_f=1.0, k_rep=2.0,
               w_c_cells=3.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
CONTACT_DISCS = ((0.38, 0.5, 0.14), (0.66, 0.5, 0.14))
# case: (config fields, discs, steps, mesh, rmt_method, contact velocity)
CASES = {
    "off-centre disc": (FLAGSHIP, ((0.35, 0.6, 0.2),), 2, (2, 4), "pallas",
                        False),
    "bicubic": (dict(FLAGSHIP, sl_interp="bicubic"), ((0.5, 0.5, 0.2),), 2,
                None, "pallas", False),
    "contact": (CONTACT, CONTACT_DISCS, 2, (2, 4), "pallas", True),
    "contact xla": (CONTACT, CONTACT_DISCS, 2, (2, 4), "xla", True),
    "horizon": (FLAGSHIP, ((0.42, 0.58, 0.2),), 12, (2, 4), "pallas",
                False),
    "pure fluid": (FLAGSHIP, (), 2, (2, 4), None, True),
}


def j_disc(x0, y0, R):
    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R

    return phi


def jax_case(fields, discs, steps, contact):
    """The JAX single-device run: (initial state, final state, aux)."""
    jcfg = jsim.RMTConfig(grid=G, **fields)
    phis = tuple(j_disc(*d) for d in discs)
    step = jsim.make_step(jcfg, j_free_slip, phis, dtype=jnp.float64)
    s = jsim.make_init_state(jcfg, phis, dtype=jnp.float64)
    if contact:  # approach velocities, as test_sharding.py gives them
        X, _ = G.coords(dtype=jnp.float64)
        s = dataclasses.replace(s, u=0.3 * jnp.tanh((0.52 - X) * 8.0))
    s0, aux = s, None
    for _ in range(steps):
        s, aux = step(s, jnp.asarray(1.0))
    return jcfg, s0, s, aux


@pytest.fixture(scope="module")
def runs():
    """The JAX runs and the port's sharded runs of every case, the latter
    in one world of 8 ranks."""
    jax_runs, cases = {}, []
    for name, (fields, discs, steps, mesh, method, contact) in CASES.items():
        jcfg, s0, s, aux = jax_case(fields, discs, steps, contact)
        jax_runs[name] = (s, aux)
        cases.append(dict(
            cfg=port_config(jcfg), velocity_bc=pt.free_slip_box_bc,
            phi_inits=tuple(pt.Disc(*d) for d in discs), steps=steps,
            dtype=torch.float64, device=DEV, mesh_shape=mesh,
            rmt_method=method, state0=jax_numpy(s0)))
    port = run_world(8, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                     dict(cases=cases), backend="gloo")[0]
    return jax_runs, dict(zip(CASES, port))


def check(port, jax_state, tol_up, tol_x):
    for k, tol in (("u", tol_up), ("v", tol_up), ("p", tol_up),
                   ("X1", tol_x), ("X2", tol_x)):
        want = np.asarray(getattr(jax_state, k))
        assert port["state"][k].shape == want.shape, k
        err = np.abs(port["state"][k] - want).max(initial=0.0)
        assert err <= tol, (k, err)
    assert float(port["state"]["t"]) == pytest.approx(
        float(jax_state.t), abs=1e-15)


@pytest.mark.parametrize("name", ["off-centre disc", "bicubic", "contact",
                                  "contact xla"])
def test_sharded_step_matches_jax_single_device(runs, name):
    jax_runs, port = runs
    r = port[name]
    expect_mesh = CASES[name][3] or mesh_shape(8)
    assert tuple(r["mesh"]) == expect_mesh
    check(r, jax_runs[name][0], 1e-10, 1e-11)


def test_sharded_paths_and_mesh(runs):
    _, port = runs
    paths = port["off-centre disc"]["paths"]
    assert paths["mesh"] == "2x4 gloo" and paths["halo"] == "direct"
    assert "slabs with offsets" in paths["solid"]
    assert "plain twin" in port["contact xla"]["paths"]["solid"]
    # the default mesh of 8 ranks is JAX's (2, 4)
    assert tuple(port["bicubic"]["mesh"]) == (2, 4)


def test_sharded_contact_force_is_active(runs):
    """The contact bands overlap across the blocks' edges (the assertion
    of tests/test_sharding.py's contact test), in both packages."""
    jax_runs, port = runs
    for phis in (np.asarray(jax_runs["contact"][1]["phis"]),
                 port["contact"]["state"]["phis"]):
        assert (np.abs(phis[0] - phis[1]) * 0.5 < 3 * G.dx)[
            (phis[0] <= 0) | (phis[1] <= 0)].any()


def test_sharded_pure_fluid_round_trip(runs):
    """A pure-fluid state (S = 0) cut into blocks, stepped and gathered:
    its empty stacks come back with the whole grid's shape (0, Ny, Nx),
    and the fields match JAX's single-device step."""
    jax_runs, port = runs
    r = port["pure fluid"]
    for k in ("X1", "X2", "phis"):
        assert r["state"][k].shape == (0, N, N), k
    check(r, jax_runs["pure fluid"][0], 1e-10, 1e-11)
    assert r["paths"]["solid"] == "none"
    assert "plain twin" in r["paths"]["momentum"]  # a CPU state


def test_sharded_long_horizon_matches_jax_single_device(runs):
    jax_runs, port = runs
    check(port["horizon"], jax_runs["horizon"][0], 1e-9, 1e-10)
    assert int(port["horizon"]["state"]["step"]) == 12


@pytest.mark.parametrize("n, shapes", [(8, ((2, 4), (4, 2))), (6, None),
                                       (4, ((2, 2),)), (1, ((1, 1),))])
def test_mesh_factorization(n, shapes):
    ry, rx = mesh_shape(n)
    assert ry * rx == n and ry <= rx
    if shapes is not None:
        assert (ry, rx) in shapes


def _cfg(**fields):
    return pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0),
                        **dict(dict(mu_s=0.1, rho_s=1.0, num_layers=3),
                               **fields))


def test_sharded_pallas_unsupported_mesh_raises():
    # 8-way row sharding: blocks of 8 rows < the exchange halo of 16
    with pytest.raises(ValueError):
        make_sharded_step(_cfg(), pt.free_slip_box_bc,
                          (pt.Disc(0.5, 0.5, 0.2),), Mesh((8, 1)),
                          dtype=torch.float64, rmt_method="pallas",
                          device=DEV)


def test_sharded_pallas_unfusible_config_raises():
    """An explicit 'pallas' fails loudly, as make_step's fusibility
    conditions do, for a configuration the fused tier does not take."""
    with pytest.raises(ValueError):
        make_sharded_step(_cfg(reinit_method="pde"), pt.free_slip_box_bc,
                          (pt.Disc(0.5, 0.5, 0.2),), Mesh((4, 1)),
                          dtype=torch.float64, rmt_method="pallas",
                          device=DEV)


@pytest.mark.parametrize("what", ["weno5", "central2", "surface tension",
                                  "traced_params"])
def test_gspmd_only_configuration_raises(what):
    """Every configuration that JAX shards by GSPMD alone now shards, the
    last of them surface tension on the periodic box ('surface tension',
    and 'central2': surface tension on the periodic box with central2):
    the step builds and names the forces' path, on ``force_halo`` slabs
    with the edge halo, and the periodic box's stage loop. ``traced_params``
    shards ('traced_params', and 'weno5': traced_params with WENO5): the
    step builds and names its adjoint collectives in ``paths['grad']``
    (tests/test_torch_sharding_grad*.py run its gradients).
    tests/test_torch_sharding_st_periodic.py runs surface tension on the
    periodic box against JAX; tests/test_torch_sharding_gspmd.py,
    tests/test_torch_sharding_st.py and tests/test_torch_sharding_general*.py
    run the others (surface tension on walls and the general tier among
    them)."""
    bc, shapes = pt.free_slip_box_bc, (pt.Disc(0.5, 0.5, 0.2),)
    cfg = {"weno5": _cfg(scheme="weno5"),
           "central2": _cfg(scheme="central2", gamma=0.1,
                            bc_type="periodic"),
           "surface tension": _cfg(gamma=0.1, bc_type="periodic"),
           "traced_params": _cfg()}[what]
    if what in ("surface tension", "central2"):
        bc = pt.periodic_bc
    if what in ("traced_params", "weno5"):
        step, _ = make_sharded_step(cfg, bc, shapes, Mesh((2, 4)),
                                    dtype=torch.float64, device=DEV,
                                    traced_params=("mu_s",))
        assert step.paths["grad"] == "adjoint collectives, direct"
        return
    step, _ = make_sharded_step(cfg, bc, shapes, Mesh((2, 4)),
                                dtype=torch.float64, device=DEV)
    assert step.paths["forces"] == (
        "surface tension (cell CSF, fd curvature) on 2-cell halo slabs")
    assert step.paths["momentum"] == "stage loop on wrap-padded slabs"


@pytest.mark.parametrize("over, scheme", [
    (dict(scheme="weno5"), "weno5"),
    (dict(scheme="central2", bc_type="periodic"), "central2"),
    (dict(sl_local=False, sl_interp="bicubic"),
     "semilagrangian bicubic, gathered fields"),
    (dict(CFL=1.5), "semilagrangian bilinear, gathered fields")])
def test_sharded_general_tier_builds_and_names_its_paths(over, scheme):
    """The general tier shards: the step builds on a mesh and names the
    tier, the scheme and extrapolate_fused's path (the plain twin on a CPU
    state)."""
    bc = pt.periodic_bc if over.get("bc_type") == "periodic" \
        else pt.free_slip_box_bc
    step, _ = make_sharded_step(_cfg(**over), bc, (pt.Disc(0.5, 0.5, 0.2),),
                                Mesh((2, 4)), dtype=torch.float64,
                                device=DEV)
    assert step.paths["solid"] == (
        f"general, {scheme}, extrapolate_fused plain twin on slabs with "
        "offsets")


def test_sharded_weno5_blocks_must_hold_its_reach():
    """With one extrapolation layer (a sharp blend, w_t 0, which one layer
    covers) the largest halo is WENO5's 9 cells (its three stages'
    reach): blocks of 8 rows raise, naming it; central2's 3 fit."""
    cfg = _cfg(scheme="weno5", num_layers=1, w_t_cells=0.0)
    with pytest.raises(ValueError, match="halo of 9 cells"):
        make_sharded_step(cfg, pt.free_slip_box_bc,
                          (pt.Disc(0.5, 0.5, 0.2),), Mesh((8, 1)),
                          dtype=torch.float64, device=DEV)
    make_sharded_step(dataclasses.replace(cfg, scheme="central2"),
                      pt.free_slip_box_bc, (pt.Disc(0.5, 0.5, 0.2),),
                      Mesh((8, 1)), dtype=torch.float64, device=DEV)
