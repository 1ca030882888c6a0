"""Surface tension on walls, sharded: ``make_sharded_step`` against
``pyrmt_tpu``'s single-device step.

All cases run in one gloo world of 8 CPU processes
(``pyrmt_tpu_torch.parallel.launch.run_world``), each from the JAX
package's initial state (a swirl, so that the interface moves from the
first step), and are held to ``pyrmt_tpu.sim.make_step`` over 3 float64
steps at N=64 (the JAX step on its XLA paths with jit disabled, its CG
jitted alone). The configurations are tests/test_torch_st_step.py's:

- the cell CSF (fd curvature), the balanced CSF with kappa*, the balanced
  CSF with the smoothed height function (``st_hf_smooth=2``): a disc on
  the (2, 4) mesh;
- the coupled capillary ellipse on the fused tier
  (``benchmarks/capillary_drop_coupled.py``) on the (4, 1) mesh;
- the ellipse with the area fix on the split tier (the cell CSF with
  kappa*) on the (2, 4) mesh;
- the balanced CSF with ``variable_rho`` (the CG, density ratio 4) on
  the (2, 4) mesh.

The sharded step's tolerances: 1e-10 in u, v, p and 1e-11 in X1, X2;
the CG 1e-8, its iteration count equal to JAX's on every step.
"""
import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.parallel import mesh_shape
from pyrmt_tpu_torch.parallel.launch import run_world

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
STEPS = 3
XLA = dict(rmt_method="xla", momentum_method="xla", extrap_method="xla",
           dct_method="fft")
# benchmarks/capillary_drop_coupled.py's configuration
CAPILLARY = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                 rho_f=1.0, gamma=0.1, w_t_cells=2.0, st_method="balanced",
                 num_layers=3, CFL=0.4, dt_min_cap=1e-3)
ELLIPSE = (0.5, 0.5, 0.2 * 1.15, 0.2 / 1.15)
DISC = (0.5, 0.5, 0.2)
TOL = {"u": 1e-10, "v": 1e-10, "p": 1e-10, "X1": 1e-11, "X2": 1e-11}
TOL_CG = {k: 1e-8 for k in TOL}
# case: (shape, configuration, mesh, tolerances)
CASES = {
    "csf_fd": ("disc", dict(CAPILLARY, st_method="csf"), (2, 4), TOL),
    "balanced_kstar": ("disc", dict(CAPILLARY, st_kappa_interface=True),
                       (2, 4), TOL),
    "balanced_hf_smooth2": ("disc", dict(CAPILLARY, st_curvature="hf",
                                         st_hf_smooth=2), (2, 4), TOL),
    "capillary_ellipse": ("ellipse", CAPILLARY, (4, 1), TOL),
    "split_csf_area_fix": ("ellipse", dict(CAPILLARY, st_method="csf",
                                           st_kappa_interface=True,
                                           phi_area_fix=True), (2, 4), TOL),
    "balanced_cg": ("disc", dict(CAPILLARY, rho_s=4.0, variable_rho=True,
                                 cg_tol=1e-10), (2, 4), TOL_CG),
}


def shapes(kind):
    """(the JAX level set, the port's)."""
    import jax.numpy as jnp

    from benchmarks.capillary_drop_coupled import make_ellipse_phi_init

    if kind == "ellipse":
        return make_ellipse_phi_init(*ELLIPSE), pt.Ellipse(*ELLIPSE)
    x0, y0, R = DISC
    return (lambda X, Y: jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R,
            pt.Disc(*DISC))


@pytest.fixture(scope="module")
def runs():
    """JAX's single-device run of each case (its initial state, its final
    state, each step's CG count) and the port's sharded runs, all in one
    world of 8 ranks."""
    import jax
    import jax.numpy as jnp

    import pyrmt_tpu.sim as jsim
    from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
    from pyrmt_tpu.grid import Grid as JGrid
    from test_torch_sharding_gspmd import compiled_loops
    from test_torch_step import jax_numpy, port_config

    jax_runs, cases = {}, []
    g = JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    X, Y = g.coords(dtype=jnp.float64)
    u0 = 0.05 * jnp.sin(np.pi * X) * jnp.cos(np.pi * Y)
    v0 = -0.05 * jnp.cos(np.pi * X) * jnp.sin(np.pi * Y)
    with jax.disable_jit(), compiled_loops():
        for name, (kind, over, mesh, _) in CASES.items():
            j_phi, t_phi = shapes(kind)
            jcfg = jsim.RMTConfig(grid=g, **over, **XLA)
            s = jsim.make_init_state(jcfg, (j_phi,), u0=u0, v0=v0,
                                     dtype=jnp.float64)
            step = jsim.make_step(jcfg, j_free_slip, (j_phi,),
                                  dtype=jnp.float64)
            s0, iters = jax_numpy(s), []
            for _ in range(STEPS):
                s, aux = step(s, jnp.asarray(1.0, jnp.float64))
                if "cg_iters" in aux:
                    iters.append(int(aux["cg_iters"]))
            jax_runs[name] = (jax_numpy(s), iters)
            cases.append(dict(
                cfg=port_config(jcfg), velocity_bc=pt.free_slip_box_bc,
                phi_inits=(t_phi,), steps=STEPS, dtype=torch.float64,
                device=DEV, mesh_shape=mesh, state0=s0, t_end=1.0))
    port = run_world(8, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                     dict(cases=cases), backend="gloo")[0]
    return jax_runs, dict(zip(CASES, port))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_surface_tension_matches_jax_single_device(runs, name):
    jax_runs, port = runs
    _, _, mesh, tols = CASES[name]
    r, want = port[name], jax_runs[name][0]
    assert tuple(r["mesh"]) == mesh
    assert r["finite"]
    for k, tol in tols.items():
        assert r["state"][k].shape == want[k].shape, k
        err = np.abs(r["state"][k] - want[k]).max(initial=0.0)
        assert err <= tol, (k, err)
    assert float(r["state"]["t"]) == pytest.approx(float(want["t"]),
                                                   abs=1e-15)
    assert int(r["state"]["step"]) == int(want["step"]) == STEPS
    # the interface moved and the flow is not at rest
    assert float(np.abs(r["state"]["u"]).max()) > 1e-3


def test_sharded_cg_with_face_forces_iterations_equal_jax(runs):
    """The CG with the balanced CSF's faces in its right-hand side stops
    at JAX's single-device iteration on every step."""
    jax_runs, port = runs
    want = jax_runs["balanced_cg"][1]
    assert port["balanced_cg"]["cg_iters"] == want
    assert len(want) == STEPS and min(want) > 5


def test_sharded_surface_tension_paths(runs):
    """step.paths names each choice: the fused tier's solid block (the
    ellipse's) or the split tier's advext_block on slabs with offsets,
    the RK4 update with the force on slabs with offsets, the forces on
    their halo slabs, the faces into the projection on halo slabs; on a
    CPU state the kernels' plain twins, so no kernel launches."""
    _, port = runs
    for name, (_, over, _, _) in CASES.items():
        paths = port[name]["paths"]
        split = over.get("phi_area_fix", False)
        assert paths["solid"] == (
            "split, advext_block plain twin on slabs with offsets" if split
            else "fused, plain twin on slabs with offsets"), name
        assert paths["momentum"] == "rk4 plain twin on slabs with offsets"
        csf = ("balanced CSF, faces in the block layout"
               if over["st_method"] == "balanced" else "cell CSF")
        assert paths["forces"].startswith(f"surface tension ({csf}, "), name
        assert paths["halo"] == "direct"
        assert paths["mesh"] == "{}x{} gloo".format(*CASES[name][2])
        for rank in port[name]["launches"]:
            assert not any(rank.values()), (name, rank)
    assert "CG" in port["balanced_cg"]["paths"]["projection"]
    assert port["balanced_kstar"]["paths"]["projection"] == (
        "stencils and face forces on halo slabs, distributed DCT")
    assert port["csf_fd"]["paths"]["projection"] == (
        "stencils on halo slabs, distributed DCT")
    assert mesh_shape(8) == (2, 4)
