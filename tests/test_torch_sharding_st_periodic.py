"""Surface tension on the doubly-periodic box, sharded: ``make_sharded_step``
against ``pyrmt_tpu``'s single-device periodic step.

The capillary ellipse of ``benchmarks/capillary_drop_coupled.py`` with the
cell CSF (the balanced CSF needs walls) on the periodic box, N=32 float64,
3 steps from a Taylor-Green swirl of 0.05, on the (2, 1), (1, 2) and
(2, 2) meshes, one case per curvature (fd, kappa*, the smoothed height
function): the mesh's cuts run through the drop's interface. One more
case puts the interface 1.5 cells from the box's left edge on (2, 2):
there JAX computes the force with its one-sided stencils (the edge halo,
not the wrap), its force reaches the seam column, and the momentum's
stage loop needs it overlap-consistent. Its initial state comes from the
walls' ``make_init_state`` (the periodic one rejects a solid this close
to the seam; the step itself does not). The JAX step runs on its XLA
paths with jit disabled, in this process; the port's ranks in one gloo
world of 4 CPU processes (``parallel.launch.run_world``) beside it.
Tolerances: 1e-10 (u, v, p) and 1e-11 (X1, X2).

Besides: the sharded gradient (the ranks' summed block energies, with
respect to a factor on the initial velocity, mu_s and gamma, traced)
against the single-device port's, 1e-10 relative; at the edge case, the
force of the wrap halo differs from JAX's by far more than the tolerance
(the halo kind decides the answer there); the balanced CSF on the
periodic box still raises.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.io import state_from_numpy
from pyrmt_tpu_torch.parallel import Mesh, make_sharded_step
from pyrmt_tpu_torch.parallel.sharding import force_halo
from pyrmt_tpu_torch.parallel.launch import block_energy, run_world

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
F64 = torch.float64

N = 32
STEPS = 3
DX = 1.0 / (N - 1)
XLA = dict(rmt_method="xla", momentum_method="xla", extrap_method="xla",
           dct_method="fft")
# benchmarks/capillary_drop_coupled.py's configuration, the cell CSF, on
# the periodic box
CAPILLARY = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                 rho_f=1.0, gamma=0.1, w_t_cells=2.0, st_method="csf",
                 num_layers=3, CFL=0.4, dt_min_cap=1e-3, bc_type="periodic")
A, B = 0.2 * 1.15, 0.2 / 1.15
ELLIPSES = {"centre": (0.5, 0.5, A, B),
            # the left end of the interface 1.5 cells from x = 0
            "edge": (A + 1.5 * DX, 0.5, A, B)}
CURVATURES = {"fd": {}, "kstar": dict(st_kappa_interface=True),
              "hf": dict(st_curvature="hf", st_hf_smooth=2)}
MESHES = ((2, 1), (1, 2), (2, 2))
# case: (ellipse, curvature, mesh)
CASES = {f"{c} {m}": ("centre", c, m) for c in CURVATURES for m in MESHES}
CASES["fd at the edge (2, 2)"] = ("edge", "fd", (2, 2))
TOL = {"u": 1e-10, "v": 1e-10, "p": 1e-10, "X1": 1e-11, "X2": 1e-11}
GRAD_CASE = "kstar (2, 2)"
TRACED = ("mu_s", "gamma")
RTOL_GRAD = 1e-10


def configs(curvature):
    """(the JAX config, the port's)."""
    from pyrmt_tpu.grid import Grid as JGrid
    from pyrmt_tpu.sim import RMTConfig as JConfig
    from test_torch_step import port_config

    jcfg = JConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), **CAPILLARY,
                   **CURVATURES[curvature], **XLA)
    return jcfg, port_config(jcfg)


def jax_run(ellipse, curvature):
    """JAX's single-device periodic run: (its initial state, its final
    state), as numpy arrays."""
    import jax
    import jax.numpy as jnp

    import pyrmt_tpu.sim as jsim
    from benchmarks.capillary_drop_coupled import make_ellipse_phi_init
    from pyrmt_tpu.bcs import periodic_bc
    from test_torch_step import jax_numpy

    jcfg, _ = configs(curvature)
    phi = make_ellipse_phi_init(*ELLIPSES[ellipse])
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    u0 = 0.05 * jnp.sin(2 * np.pi * X) * jnp.cos(2 * np.pi * Y)
    v0 = -0.05 * jnp.cos(2 * np.pi * X) * jnp.sin(2 * np.pi * Y)
    with jax.disable_jit():
        # the walls' initial state: the same maps, without the periodic
        # box's seam check
        s = jsim.make_init_state(
            dataclasses.replace(jcfg, bc_type="neumann"), (phi,), u0=u0,
            v0=v0, dtype=jnp.float64)
        s0 = jax_numpy(s)
        step = jsim.make_step(jcfg, periodic_bc, (phi,), dtype=jnp.float64)
        for _ in range(STEPS):
            s, _ = step(s, jnp.asarray(1.0, jnp.float64))
    return s0, jax_numpy(s)


def port_grads(tcfg, s0, shapes):
    """The single-device port's loss and gradients of ``GRAD_CASE``."""
    step = pt.make_step(tcfg, pt.periodic_bc, shapes, dtype=F64, device=DEV,
                        traced_params=TRACED)
    leaves = {"scale": torch.ones((), dtype=F64)}
    leaves.update({k: torch.tensor(getattr(tcfg, k), dtype=F64)
                   for k in TRACED})
    for x in leaves.values():
        x.requires_grad_(True)
    state = state_from_numpy(s0, dtype=F64, device=DEV)
    s = dataclasses.replace(state, u=state.u * leaves["scale"],
                            v=state.v * leaves["scale"])
    for _ in range(STEPS):
        s = step(s, 1.0, {k: leaves[k] for k in TRACED})[0]
    loss = block_energy(s)
    loss.backward()
    return loss.item(), {k: x.grad.item() for k, x in leaves.items()}


@pytest.fixture(scope="module")
def runs():
    """JAX's single-device runs and the port's gradient on one device in
    this process; the sharded forward runs and the sharded gradient in
    two worlds of 4 ranks, beside them."""
    starts, ends = {}, {}
    for ellipse, curvature in {c[:2] for c in CASES.values()}:
        starts[ellipse, curvature], ends[ellipse, curvature] = jax_run(
            ellipse, curvature)
    cases = []
    for name, (ellipse, curvature, mesh) in CASES.items():
        cases.append(dict(
            cfg=configs(curvature)[1], velocity_bc=pt.periodic_bc,
            phi_inits=(pt.Ellipse(*ELLIPSES[ellipse]),), steps=STEPS,
            dtype=F64, device=DEV, mesh_shape=mesh,
            state0=starts[ellipse, curvature], t_end=1.0))
    grad_case = dict(cases[list(CASES).index(GRAD_CASE)],
                     traced_params=TRACED)
    worlds = {}

    def world(key, target, job):
        try:
            worlds[key] = run_world(4, target, job, backend="gloo")[0]
        except Exception as e:  # raised below, in the test's thread
            worlds[key] = e

    threads = [threading.Thread(target=world, args=(
        "forward", "pyrmt_tpu_torch.parallel.launch:run_sharded",
        dict(cases=cases))), threading.Thread(target=world, args=(
            "grad", "pyrmt_tpu_torch.parallel.launch:run_sharded_grads",
            dict(cases=[grad_case])))]
    for t in threads:
        t.start()
    try:
        single = port_grads(grad_case["cfg"], grad_case["state0"],
                            grad_case["phi_inits"])
    finally:
        for t in threads:
            t.join()
    for out in worlds.values():
        if isinstance(out, Exception):
            raise out
    sharded = dict(zip(CASES, worlds["forward"]))
    return ends, sharded, (single, worlds["grad"][0]), starts


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_periodic_surface_tension_matches_jax(runs, name):
    ends, sharded, _, _ = runs
    ellipse, curvature, mesh = CASES[name]
    r, want = sharded[name], ends[ellipse, curvature]
    assert tuple(r["mesh"]) == mesh
    assert r["finite"]
    for k, tol in TOL.items():
        assert r["state"][k].shape == want[k].shape, k
        err = np.abs(r["state"][k] - want[k]).max(initial=0.0)
        assert err <= tol, (k, err)
    assert float(r["state"]["t"]) == pytest.approx(float(want["t"]),
                                                   abs=1e-15)
    assert int(r["state"]["step"]) == int(want["step"]) == STEPS
    paths = r["paths"]
    csf = {"fd": "fd", "kstar": "fd", "hf": "hf"}[curvature]
    assert paths["forces"] == (
        f"surface tension (cell CSF, {csf} curvature) on "
        f"{force_halo(configs(curvature)[1])}-cell halo slabs")
    assert paths["momentum"] == "stage loop on wrap-padded slabs"
    assert paths["projection"] == "wrap-padded stencils, distributed FFT"
    assert paths["solid"] == "fused, plain twin on slabs with offsets"


def test_edge_case_force_reaches_the_seam_and_depends_on_the_halo(runs):
    """At the edge case the force is nonzero in column 0 (so the overlap
    column N - 1 must take it for the stage loop), and the force computed
    with a wrap halo (periodic stencils for the curvature) differs from the
    edge halo's, which JAX's step takes, by far more than the tolerance."""
    from pyrmt_tpu_torch.ops.fd import wrap_pad_x, wrap_pad_y
    from pyrmt_tpu_torch.physics import body_forces

    _, _, _, starts = runs
    _, tcfg = configs("fd")
    s0 = state_from_numpy(starts["edge", "fd"], dtype=F64, device=DEV)
    phis = pt.Ellipse(*ELLIPSES["edge"])(s0.X1, s0.X2)  # (1, N, N)
    kw = dict(dx=tcfg.grid.dx, dy=tcfg.grid.dy, gamma=tcfg.gamma, k_rep=0.0,
              w_c=tcfg.w_c, w_t=tcfg.w_t)
    fx, fy = body_forces(phis, None, **kw)
    assert float(fx[:, 0].abs().max()) > 1e-3
    h = 4
    wide = wrap_pad_y(wrap_pad_x(phis[0], h), h)[None]
    wx, wy = body_forces(wide, None, **kw)
    wx, wy = wx[h:-h, h:-h], wy[h:-h, h:-h]  # the domain's cells
    assert float(torch.maximum((wx - fx).abs().max(),
                               (wy - fy).abs().max())) > 1e-6


def test_sharded_periodic_gradient_matches_one_device(runs):
    """d/d(velocity factor), d/d(mu_s) and d/d(gamma) of the ranks' summed
    block energies through the sharded periodic capillary step equal the
    single-device step's (``parallel.sharding``'s loss contract)."""
    _, _, ((loss, want), r), _ = runs
    assert tuple(r["mesh"]) == CASES[GRAD_CASE][2]
    assert r["paths"]["grad"] == "adjoint collectives, direct"
    assert r["grad_spread"] == 0.0
    assert r["loss"] == pytest.approx(loss, rel=1e-12)
    assert set(r["grads"]) == {"scale", *TRACED}
    for k, g in r["grads"].items():
        assert np.isfinite(g) and abs(want[k]) > 0.0, (k, g, want[k])
        assert abs(g - want[k]) <= RTOL_GRAD * abs(want[k]), (k, g, want[k])


def test_sharded_periodic_balanced_csf_raises():
    """The balanced CSF needs the Neumann projection on the periodic box
    as on one device (JAX's make_step raises the same)."""
    _, tcfg = configs("fd")
    cfg = dataclasses.replace(tcfg, st_method="balanced")
    with pytest.raises(ValueError, match="neumann"):
        make_sharded_step(cfg, pt.periodic_bc,
                          (pt.Ellipse(*ELLIPSES["centre"]),), Mesh((2, 2)),
                          dtype=F64, device=DEV)
