"""The configurations that JAX shards by GSPMD alone, sharded in the port:
``make_sharded_step`` against ``pyrmt_tpu``'s single-device step.

All cases run in one gloo world of 8 CPU processes
(``pyrmt_tpu_torch.parallel.launch.run_world``), each from the JAX
package's initial state, and are held to ``pyrmt_tpu.sim.make_step`` over
the same steps (the JAX step on its XLA paths with jit disabled: compiling
each configuration takes 30-50 s on the CPU, running it op by op a few
seconds):

- the three of JAX's own GSPMD tests, with their configurations, meshes
  (JAX's (2, 4) of 8 devices), steps and tolerances:
  tests/test_sharding.py's variable density (u, v, p to 1e-8, the CG's
  iteration count equal on every step) and periodic Taylor-Green box (u, v
  to 1e-10, p to 1e-9), tests/test_rebase.py's always-firing rebasing (u,
  X1, phis0 to 1e-8, ``rebased`` on every step);
- the variable density and the rebasing on the (4, 1) mesh too;
- the periodic box with a disc clear of the seam (1e-10, p 1e-9);
- the split tier: the area fix with PDE reinitialisation, the 'fmm'
  reinitialisation and a rounded square (a level set the fused kernel does
  not evaluate), to the sharded step's 1e-10 (u, v, p) and 1e-11 (X1,
  X2).

The ranks import this module for the rounded square's level set (the
world's job is pickled, and a function pickles by its module's name), so
it imports nothing of JAX at its top.
"""
import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.parallel import Mesh, make_sharded_step, mesh_shape
from pyrmt_tpu_torch.parallel.launch import run_world

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
XLA = dict(rmt_method="xla", momentum_method="xla", extrap_method="xla",
           dct_method="fft")
# JAX's three GSPMD tests' configurations
VRHO = dict(mu_s=1.0, rho_s=5.0, mu_f=1e-3, rho_f=1.0, g_y=-1.0,
            variable_rho=True, cg_tol=1e-10, CFL=0.2, dt_min_cap=1e-3)
PERIODIC = dict(mu_f=0.01, rho_f=1.0, bc_type="periodic", CFL=0.3,
                dt_min_cap=1e-3)
REBASE = dict(mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0, CFL=0.3,
              map_rebase_minj=10.0)
SPLIT = dict(mu_s=0.05, rho_s=1.0, mu_f=0.01, rho_f=1.0, num_layers=3,
             CFL=0.2, dt_min_cap=1e-3)
FLAGSHIP = dict(mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0, rho_s=1.0,
                num_layers=3, CFL=0.2, dt_min_cap=1e-3)
TOL_GSPMD = {"u": 1e-8, "v": 1e-8, "p": 1e-8}
TOL_PERIODIC = {"u": 1e-10, "v": 1e-10, "p": 1e-9}
TOL_REBASE = {"u": 1e-8, "X1": 1e-8, "phis0": 1e-8}
TOL_SPLIT = {"u": 1e-10, "v": 1e-10, "p": 1e-10, "X1": 1e-11, "X2": 1e-11}
# case: (reference, mesh or None for the default of 8 ranks, tolerances)
CASES = {
    "variable density": ("variable density", None, TOL_GSPMD),
    "variable density (4,1)": ("variable density", (4, 1), TOL_GSPMD),
    "periodic": ("periodic", None, TOL_PERIODIC),
    "periodic disc": ("periodic disc", (2, 4),
                      dict(TOL_PERIODIC, X1=1e-11, X2=1e-11)),
    "rebasing": ("rebasing", None, TOL_REBASE),
    "rebasing (4,1)": ("rebasing", (4, 1), TOL_REBASE),
    "area fix + pde": ("area fix + pde", (2, 4), TOL_SPLIT),
    "fmm": ("fmm", (2, 4), TOL_SPLIT),
    "level set": ("level set", (2, 4), TOL_SPLIT),
}


def rounded_square(X1, X2):
    """A rounded square of half-width 0.15 about (0.55, 0.5), corner
    radius 0.05: the split tier's level set."""
    qx = torch.clamp(torch.abs(X1 - 0.55) - 0.1, min=0.0)
    qy = torch.clamp(torch.abs(X2 - 0.5) - 0.1, min=0.0)
    inside = torch.clamp(torch.maximum(torch.abs(X1 - 0.55),
                                       torch.abs(X2 - 0.5)) - 0.1, max=0.0)
    return torch.sqrt(qx * qx + qy * qy) + inside - 0.05


def _references():
    """{reference: (JAX config, JAX level sets, port level sets, BC pair,
    (u0, v0) or None, t_end, steps)}."""
    import jax.numpy as jnp

    import pyrmt_tpu.bcs as jbcs
    from pyrmt_tpu.grid import Grid as JGrid
    from pyrmt_tpu.sim import RMTConfig

    g = JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    X, Y = g.coords(dtype=jnp.float64)

    def j_disc(x0, y0, R):
        return lambda Xq, Yq: jnp.sqrt((Xq - x0) ** 2 + (Yq - y0) ** 2) - R

    def j_rounded_square(Xq, Yq):
        qx = jnp.maximum(jnp.abs(Xq - 0.55) - 0.1, 0.0)
        qy = jnp.maximum(jnp.abs(Yq - 0.5) - 0.1, 0.0)
        inside = jnp.minimum(jnp.maximum(jnp.abs(Xq - 0.55),
                                         jnp.abs(Yq - 0.5)) - 0.1, 0.0)
        return jnp.sqrt(qx * qx + qy * qy) + inside - 0.05

    def tg(amp, k):
        return (amp * jnp.sin(k * jnp.pi * X) * jnp.cos(k * jnp.pi * Y),
                -amp * jnp.cos(k * jnp.pi * X) * jnp.sin(k * jnp.pi * Y))

    def cfg(**fields):
        return RMTConfig(grid=g, **fields, **XLA)

    walls = (jbcs.free_slip_box_bc, pt.free_slip_box_bc)
    lid = (jbcs.make_lid_bc(1.0), pt.make_lid_bc(1.0))
    wrap = (jbcs.periodic_bc, pt.periodic_bc)
    split_disc = (j_disc(0.55, 0.5, 0.2),), (pt.Disc(0.55, 0.5, 0.2),)
    return {
        "variable density": (cfg(**VRHO), (j_disc(0.5, 0.55, 0.18),),
                             (pt.Disc(0.5, 0.55, 0.18),), walls, None, 1.0,
                             3),
        "periodic": (cfg(**PERIODIC), (), (), wrap, tg(0.5, 2), 1.0, 3),
        "periodic disc": (cfg(**FLAGSHIP, bc_type="periodic"),
                          (j_disc(0.6, 0.5, 0.2),), (pt.Disc(0.6, 0.5, 0.2),),
                          wrap, tg(0.3, 2), 1.0, 3),
        "rebasing": (cfg(**REBASE), (j_disc(0.5, 0.5, 0.22),),
                     (pt.Disc(0.5, 0.5, 0.22),), walls, tg(0.3, 1), 10.0,
                     3),
        "area fix + pde": (cfg(**SPLIT, phi_area_fix=True,
                               reinit_method="pde"), *split_disc, lid,
                           tg(0.4, 1), 1.0, 3),
        "fmm": (cfg(**SPLIT, reinit_method="fmm"), *split_disc, lid,
                tg(0.4, 1), 1.0, 2),
        "level set": (cfg(**FLAGSHIP), (j_rounded_square,),
                      (rounded_square,), lid, tg(0.4, 1), 1.0, 3),
    }


@contextlib.contextmanager
def compiled_loops():
    """JAX's CG solve and fast-sweeping redistance jitted inside its
    op-by-op step: run op by op, their loops took ~25 s and ~15 s a step
    (compiling the whole step took longer still). The same functions of
    the JAX package, compiled alone."""
    import jax

    import pyrmt_tpu.ops.levelset as jls
    import pyrmt_tpu.ops.poisson as jpo

    fsm = jax.jit(jls.reinitialize_phi_fsm,
                  static_argnames=("dx", "dy", "n_passes"))
    cg = jax.jit(jpo.solve_variable_poisson_cg_counted,
                 static_argnames=("dx", "dy", "tol", "maxiter", "precision"))

    def fsm_jit(phi, dx, dy, n_passes=2):
        with jax.disable_jit(False):
            return fsm(phi, dx=dx, dy=dy, n_passes=n_passes)

    def cg_jit(rhs, inv_rho, eigenvalues, dx, dy, tol=1e-6, maxiter=200,
               dct_mats=None, precision=None):
        with jax.disable_jit(False):
            return cg(rhs, inv_rho, eigenvalues, dx=dx, dy=dy, tol=tol,
                      maxiter=maxiter, dct_mats=dct_mats,
                      precision=precision)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jls, "reinitialize_phi_fsm", fsm_jit)
        mp.setattr(jpo, "solve_variable_poisson_cg_counted", cg_jit)
        yield


@pytest.fixture(scope="module")
def runs():
    """JAX's single-device runs of each reference (its initial state, its
    final state and each step's aux) and the port's sharded runs of every
    case, the latter in one world of 8 ranks."""
    import jax
    import jax.numpy as jnp

    import pyrmt_tpu.sim as jsim
    from test_torch_step import jax_numpy, port_config

    refs, jax_runs = _references(), {}
    with jax.disable_jit(), compiled_loops():
        for name, (jcfg, jphis, _, (jbc, _), uv, t_end, steps) in \
                refs.items():
            u0, v0 = uv if uv is not None else (None, None)
            s = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0,
                                     dtype=jnp.float64)
            step = jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64)
            s0, auxes = jax_numpy(s), []
            for _ in range(steps):
                s, aux = step(s, jnp.asarray(t_end, jnp.float64))
                auxes.append({k: np.asarray(v) for k, v in aux.items()
                              if k in ("cg_iters", "rebased")})
            jax_runs[name] = (s0, jax_numpy(s), auxes)
    cases = []
    for name, (ref, mesh, _) in CASES.items():
        jcfg, _, phis, (_, bc), _, t_end, steps = refs[ref]
        cases.append(dict(
            cfg=port_config(jcfg), velocity_bc=bc, phi_inits=phis,
            steps=steps, dtype=torch.float64, device=DEV, mesh_shape=mesh,
            state0=jax_runs[ref][0], t_end=t_end))
    # the ranks import this module (the rounded square) from its directory
    here = str(Path(__file__).resolve().parent)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (here, old) if p)
    try:
        port = run_world(8, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                         dict(cases=cases), backend="gloo")[0]
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    return jax_runs, dict(zip(CASES, port))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_single_device(runs, name):
    jax_runs, port = runs
    ref, mesh, tols = CASES[name]
    r, want = port[name], jax_runs[ref][1]
    assert tuple(r["mesh"]) == (mesh or mesh_shape(8))
    assert r["finite"]
    for k, tol in tols.items():
        assert r["state"][k].shape == want[k].shape, k
        err = np.abs(r["state"][k] - want[k]).max(initial=0.0)
        assert err <= tol, (k, err)
    assert float(r["state"]["t"]) == pytest.approx(float(want["t"]),
                                                   abs=1e-15)
    assert int(r["state"]["step"]) == int(want["step"])


@pytest.mark.parametrize("name", ["variable density",
                                  "variable density (4,1)"])
def test_sharded_cg_iterations_equal_jax(runs, name):
    """The CG's stopping test reads the same sums on every rank: in
    float64 its count equals JAX's single-device count on every step, as
    JAX's sharded count does."""
    jax_runs, port = runs
    want = [int(a["cg_iters"]) for a in jax_runs["variable density"][2]]
    assert port[name]["cg_iters"] == want
    assert min(want) > 5


@pytest.mark.parametrize("name", ["rebasing", "rebasing (4,1)"])
def test_sharded_rebase_fires_on_every_step(runs, name):
    """The least J is a min over the ranks: every step rebases, as in JAX,
    and the rebased maps and base level sets are the whole grid's."""
    jax_runs, port = runs
    assert port[name]["rebased"] == [[True]] * 3
    assert all(bool(a["rebased"].all()) for a in jax_runs["rebasing"][2])
    want = jax_runs["rebasing"][1]
    assert port[name]["state"]["phis0"].shape == (1, N, N)
    assert np.abs(port[name]["state"]["X2"] - want["X2"]).max() <= 1e-8


def test_sharded_gspmd_paths(runs):
    """step.paths names each configuration's blocks: the split tier's
    advext_block on slabs with offsets (its plain twin on a CPU state),
    the periodic box's stage loop on wrap-padded slabs and distributed
    FFT, the CG's distributed preconditioner."""
    _, port = runs
    for name in ("area fix + pde", "fmm", "level set", "rebasing"):
        assert port[name]["paths"]["solid"] == (
            "split, advext_block plain twin on slabs with offsets"), name
    for name in ("periodic", "periodic disc"):
        paths = port[name]["paths"]
        assert paths["momentum"] == "stage loop on wrap-padded slabs"
        assert paths["projection"] == ("wrap-padded stencils, distributed "
                                       "FFT")
    assert port["periodic"]["paths"]["solid"] == "none"
    assert "fused" in port["periodic disc"]["paths"]["solid"]
    assert "CG" in port["variable density"]["paths"]["projection"]
    assert port["variable density"]["paths"]["halo"] == "direct"


def test_sharded_periodic_box_keeps_the_overlap(runs):
    """The overlap row and column of the sharded periodic box's fields
    equal row and column 0 (the BC's copy across the ranks), as in the
    single-device step."""
    _, port = runs
    for name in ("periodic", "periodic disc"):
        for k in ("u", "v"):
            f = port[name]["state"][k]
            assert np.array_equal(f[:-1, -1], f[:-1, 0]), (name, k)
            assert np.array_equal(f[-1, :-1], f[0, :-1]), (name, k)
        assert float(np.abs(port[name]["state"]["u"]).max()) > 0.1


def _cfg(**fields):
    return pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0),
                        **dict(dict(mu_s=0.1, rho_s=1.0, num_layers=3),
                               **fields))


@pytest.mark.parametrize("bc_type, bc", [("periodic", pt.free_slip_box_bc),
                                         ("neumann", pt.periodic_bc)])
def test_sharded_periodic_bc_mismatch_raises(bc_type, bc):
    """The sharded box's overlap copy is periodic_bc's: a periodic box
    under another BC, or periodic_bc on walls, raises ValueError."""
    with pytest.raises(ValueError, match="periodic_bc"):
        make_sharded_step(_cfg(bc_type=bc_type), bc, (), Mesh((2, 4)),
                          dtype=torch.float64, device=DEV)


def test_sharded_periodic_mesh_too_tight_raises():
    """The periodic box's wrap halo of 8 cells needs blocks of 9 along
    both axes: 8 rows, enough for the walls' exchange, are too few."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_f=0.01,
                       bc_type="periodic")
    with pytest.raises(ValueError, match="9 along both axes"):
        make_sharded_step(cfg, pt.periodic_bc, (), Mesh((8, 1)),
                          dtype=torch.float64, device=DEV)
