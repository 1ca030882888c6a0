"""Gradients of the sharded step against one device and against JAX: the
whole step differentiated across the mesh (``parallel.sharding``'s loss
contract).

Each case runs 2 float64 steps from a swirl of amplitude ``amp`` and
differentiates the global loss, the sum over the ranks of sum(u^2 + v^2)
+ sum(p^2) on each rank's block, with respect to a factor ``scale`` on
the initial velocity and to the traced physics scalars
(``make_sharded_step(traced_params=...)``, each rank's copy through
``Mesh.replicate``). The port's ranks run in one gloo world of 4 CPU
processes (``parallel.launch.run_sharded_grads``), beside the JAX
gradients in this process. Each gradient is held to the port's
single-device step (1e-10 relative), is finite and nonzero (from rest,
the factor on the zero velocity has none), and at N=32 on the (2, 2)
mesh, from the JAX package's initial state, to ``jax.grad`` of
``pyrmt_tpu.sim.make_step(traced_params=...)`` (1e-9 relative; JAX's step
runs unjitted, ``step.__wrapped__``, as tests/test_torch_diff_cases.py
runs it, in 2 processes).

The cases at N=32 on (2, 2): the flagship on the fused tier
(``rmt_method='pallas'``: the offset twins on a CPU state); the flagship
from rest (the lid row's tied max speed across two blocks, the guarded
``_speed_max``); the density contrast (the sharded CG's implicit
adjoint); the split tier with the area fix and PDE reinitialisation; the
periodic flagship (the wrap halo, the overlap copy, the FFT strips); the
WENO5 general tier; the capillary drop on walls (the balanced CSF on
``force_halo`` slabs); two discs in contact. On (4, 1): WENO5 at N=48
with 2 extrapolation layers (its blocks of 12 rows hold the 12-cell
halo), from the port's initial state. Besides: ``make_rollout`` over the
sharded traced step equals its loop, and the loss on the gathered state
divided by the mesh's size equals the block loss.
"""
import dataclasses
import multiprocessing as mp
import threading
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.bcs import periodic_bc as j_periodic
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy
from pyrmt_tpu_torch.parallel.launch import block_energy, run_world

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
F64 = torch.float64

STEPS = 2
RTOL_PORT = 1e-10
RTOL_JAX = 1e-9
FLAGSHIP = dict(mu_s=0.1, eta_s=0.01, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                num_layers=3, CFL=0.2, dt_min_cap=1e-3)
# the adaptive dt with the fluid's CFL binding (the viscous limit above it)
FROM_REST = dict(FLAGSHIP, eta_s=0.0, mu_f=0.005, dt_min_cap=0.05)
DENSITY = dict(mu_s=1.0, rho_s=5.0, eta_s=0.0, mu_f=1e-3, rho_f=1.0,
               g_y=-1.0, variable_rho=True, cg_tol=1e-12, num_layers=3,
               CFL=0.2, dt_min_cap=1e-3)
CAPILLARY = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                 rho_f=1.0, gamma=0.1, w_t_cells=2.0, st_method="balanced",
                 num_layers=3, CFL=0.4, dt_min_cap=1e-3)
CONTACT = dict(mu_s=1.0, rho_s=1.0, mu_f=0.01, rho_f=1.0, k_rep=2.0,
               w_c_cells=3.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
DISC = (("disc", 0.6, 0.5, 0.2),)
# {case: (N, config, shapes, bc, swirl amplitude, traced, mesh, rmt_method)}
CASES = {
    "flagship": (32, FLAGSHIP, DISC, "lid", 0.3, ("mu_s",), (2, 2),
                 "pallas"),
    "flagship from rest": (32, FROM_REST, DISC, "lid", 0.0, ("mu_s",),
                           (2, 2), None),
    "density contrast": (32, DENSITY, (("disc", 0.5, 0.6, 0.15),),
                         "free_slip", 0.05, ("mu_s", "rho_s"), (2, 2), None),
    "split tier": (32, dict(FLAGSHIP, phi_area_fix=True,
                            reinit_method="pde"), DISC, "lid", 0.3,
                   ("mu_s",), (2, 2), None),
    "periodic": (32, dict(FLAGSHIP, bc_type="periodic"),
                 (("disc", 0.55, 0.5, 0.2),), "periodic", 0.3, ("mu_s",),
                 (2, 2), None),
    "weno5": (32, dict(FLAGSHIP, scheme="weno5"), DISC, "lid", 0.3,
              ("mu_s",), (2, 2), None),
    "capillary drop": (32, CAPILLARY,
                       (("ellipse", 0.5, 0.5, 0.23, 0.2 / 1.15),),
                       "free_slip", 0.05, ("mu_s", "gamma"), (2, 2), None),
    "contact": (32, CONTACT, (("disc", 0.36, 0.5, 0.13),
                              ("disc", 0.64, 0.5, 0.13)), "free_slip", 0.3,
                ("mu_s",), (2, 2), None),
    # the (4, 1) mesh: WENO5 with 2 extrapolation layers (a blend of one
    # cell) at N=48, whose blocks of 12 rows hold the 12-cell halo
    "weno5 (4, 1)": (48, dict(FLAGSHIP, scheme="weno5", num_layers=2,
                              w_t_cells=1.0), DISC, "lid", 0.3, ("mu_s",),
                     (4, 1), None),
}

# the cases also held to jax.grad, all at N=32: the JAX step, op by op,
# compiles its ops once per shape (~40 s), then runs a case in 5-20 s;
# JAX_WORKERS processes share the cases
JAX_CASES = tuple(name for name in CASES if CASES[name][0] == 32)
JAX_WORKERS = 2


def j_shape(kind, *p):
    if kind == "ellipse":
        from benchmarks.capillary_drop_coupled import make_ellipse_phi_init

        return make_ellipse_phi_init(*p)
    x0, y0, R = p

    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R

    return phi


def t_shape(kind, *p):
    return pt.Ellipse(*p) if kind == "ellipse" else pt.Disc(*p)


BCS = {"lid": (j_lid_bc(1.0), pt.make_lid_bc(1.0)),
       "free_slip": (j_free_slip, pt.free_slip_box_bc),
       "periodic": (j_periodic, pt.periodic_bc)}


def build(name):
    """(JAX config, its initial state, the port's config, its state as
    numpy arrays, the port's level sets and BC). The cases outside
    ``JAX_CASES`` start from the port's ``make_init_state`` (no JAX)."""
    N, over, shapes, bc, amp, _, _, _ = CASES[name]
    jcfg = jsim.RMTConfig(grid=JGrid(N, N, 1.0, 1.0), extrap_method="xla",
                          rmt_method="xla", momentum_method="xla",
                          dct_method="fft", **over)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "grid"}
    tcfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), **fields)
    t_shapes = tuple(t_shape(*s) for s in shapes)
    if name not in JAX_CASES:
        X, Y = tcfg.grid.coords(dtype=F64, device=DEV)
        ts = pt.make_init_state(
            tcfg, t_shapes, u0=amp * torch.sin(np.pi * X)
            * torch.cos(np.pi * Y), v0=-amp * torch.cos(np.pi * X)
            * torch.sin(np.pi * Y), dtype=F64, device=DEV)
        s0 = {k: getattr(ts, k).numpy() for k in STATE_FIELDS}
        return None, None, tcfg, s0, t_shapes, BCS[bc]
    X, Y = jcfg.grid.coords(jnp.float64)
    u0 = amp * jnp.sin(np.pi * X) * jnp.cos(np.pi * Y)
    v0 = -amp * jnp.cos(np.pi * X) * jnp.sin(np.pi * Y)
    with jax.disable_jit():  # op by op: a second, where compiling took 20
        js = jsim.make_init_state(jcfg, tuple(j_shape(*s) for s in shapes),
                                  u0=u0, v0=v0, dtype=jnp.float64)
    s0 = {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS}
    return jcfg, js, tcfg, s0, t_shapes, BCS[bc]


def jax_grads(name, jcfg, js):
    """jax.grad of the case's loss from the JAX state ``js``."""
    _, _, shapes, bc, _, names, _, _ = CASES[name]
    step = jsim.make_step(jcfg, BCS[bc][0], tuple(j_shape(*s) for s in
                                                  shapes),
                          dtype=jnp.float64,
                          traced_params=names).__wrapped__

    def loss(p):
        s = dataclasses.replace(js, u=js.u * p["scale"], v=js.v * p["scale"])
        for _ in range(STEPS):
            s = step(s, 1.0, {k: p[k] for k in names})[0]
        return jnp.sum(s.u ** 2 + s.v ** 2) + jnp.sum(s.p ** 2)

    vals = {k: jnp.asarray(getattr(jcfg, k), jnp.float64) for k in names}
    vals["scale"] = jnp.asarray(1.0, jnp.float64)
    return {k: float(v) for k, v in jax.grad(loss)(vals).items()}


def jax_worker(names, states):
    """A process of its own: ``jax_grads`` of each case of ``names`` from
    its JAX-made state (numpy arrays)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in names:
        N, over = CASES[name][:2]
        jcfg = jsim.RMTConfig(grid=JGrid(N, N, 1.0, 1.0),
                              extrap_method="xla", rmt_method="xla",
                              momentum_method="xla", dct_method="fft",
                              **over)
        js = jsim.SimState(**{k: jnp.asarray(v) for k, v in
                              states[name].items()})
        out[name] = jax_grads(name, jcfg, js)
    return out


def port_grads(name, tcfg, s0, shapes, bc, rollout=False):
    """The single-device port's loss and gradients."""
    names = CASES[name][5]
    step = pt.make_step(tcfg, bc, shapes, dtype=F64, device=DEV,
                        traced_params=names)
    leaves = {"scale": torch.ones((), dtype=F64)}
    leaves.update({k: torch.tensor(getattr(tcfg, k), dtype=F64)
                   for k in names})
    for x in leaves.values():
        x.requires_grad_(True)
    state = state_from_numpy(s0, dtype=F64, device=DEV)
    s = dataclasses.replace(state, u=state.u * leaves["scale"],
                            v=state.v * leaves["scale"])
    params = {k: leaves[k] for k in names}
    if rollout:
        s = pt.make_rollout(step, STEPS)(s, 1.0, params)
    else:
        for _ in range(STEPS):
            s = step(s, 1.0, params)[0]
    loss = block_energy(s)
    loss.backward()
    return loss.item(), {k: x.grad.item() for k, x in leaves.items()}


@pytest.fixture(scope="module")
def runs():
    """Every case's JAX gradients and single-device port gradients (this
    process), and the sharded ones (one world of 4 ranks, run beside
    them); besides, the flagship through ``make_rollout`` and with the
    gathered-state loss."""
    built = {name: build(name) for name in CASES}
    cases = []
    for name, (N, over, shapes, bc, amp, names, mesh, method) in \
            CASES.items():
        _, _, tcfg, s0, t_shapes, (_, tbc) = built[name]
        cases.append(dict(cfg=tcfg, velocity_bc=tbc, phi_inits=t_shapes,
                          steps=STEPS, dtype=F64, device=DEV,
                          mesh_shape=mesh, rmt_method=method, state0=s0,
                          traced_params=names))
    cases += [dict(cases[0], rollout=True), dict(cases[0], loss="gathered")]
    world = {}

    def run():
        try:
            world["out"] = run_world(
                4, "pyrmt_tpu_torch.parallel.launch:run_sharded_grads",
                dict(cases=cases), backend="gloo")[0]
        except Exception as e:  # raised below, in the test's thread
            world["out"] = e

    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    try:
        with ProcessPoolExecutor(JAX_WORKERS,
                                 mp_context=mp.get_context("spawn")) as pool:
            jobs = [pool.submit(jax_worker, JAX_CASES[k::JAX_WORKERS],
                                {n: built[n][3] for n in JAX_CASES})
                    for k in range(JAX_WORKERS)]
            port = {name: port_grads(name, *built[name][2:4],
                                     built[name][4], built[name][5][1])
                    for name in CASES}
            for job in jobs:
                ref.update(job.result())
    finally:
        thread.join()
    if isinstance(world["out"], Exception):
        raise world["out"]
    sharded = dict(zip(CASES, world["out"]))
    extra = dict(zip(("rollout", "gathered"), world["out"][len(CASES):]))
    return ref, port, sharded, extra


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_gradient_matches_one_device_and_jax(runs, name):
    ref, port, sharded, _ = runs
    r = sharded[name]
    assert tuple(r["mesh"]) == CASES[name][6]
    assert r["paths"]["grad"] == "adjoint collectives, direct"
    assert r["grad_spread"] == 0.0  # every rank's leaf holds the whole
    loss, want = port[name]
    assert r["loss"] == pytest.approx(loss, rel=1e-12)
    for k, g in r["grads"].items():
        assert np.isfinite(g), (name, k, g)
        if k == "scale" and CASES[name][4] == 0.0:
            # from rest the loss does not depend on a factor on zero
            assert g == want[k] == ref.get(name, want)[k] == 0.0
            continue
        assert abs(want[k]) > 0.0, (name, k)
        assert abs(g - want[k]) <= RTOL_PORT * abs(want[k]), \
            (name, k, g, want[k])
        if name in ref:
            assert abs(g - ref[name][k]) <= RTOL_JAX * abs(ref[name][k]), \
                (name, k, g, ref[name][k])


def test_sharded_rollout_gradient_equals_its_loop(runs):
    """``make_rollout`` (each step under ``torch.utils.checkpoint``: its
    recompute reruns the forward's collectives inside the backward, on
    every rank in the same order) over the sharded traced step gives the
    loop's gradient."""
    _, _, sharded, extra = runs
    loop, roll = sharded["flagship"], extra["rollout"]
    assert roll["loss"] == loop["loss"]
    for k, g in loop["grads"].items():
        assert abs(roll["grads"][k] - g) <= 1e-13 * abs(g), k


def test_gathered_loss_over_mesh_size_equals_block_loss(runs):
    """A loss on ``gather_state`` counts once per rank: divided by the
    mesh's size it is the block loss, and so is its gradient."""
    _, _, sharded, extra = runs
    blocks, gathered = sharded["flagship"], extra["gathered"]
    assert gathered["loss"] == pytest.approx(blocks["loss"], rel=1e-13)
    for k, g in blocks["grads"].items():
        assert abs(gathered["grads"][k] - g) <= 1e-12 * abs(g), k
