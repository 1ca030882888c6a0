"""Surface tension and variable density in the port's step against
``pyrmt_tpu.sim.make_step``.

Three float64 steps at N=48 of ``make_step`` against the JAX step on its
XLA paths (jit disabled, op by op), from the JAX initial state: the cell
CSF with fd curvature, the balanced CSF with kappa*, the balanced CSF with
the smoothed height-function curvature (``st_hf_smooth=2``), the coupled
capillary ellipse of ``benchmarks/capillary_drop_coupled.py`` on the
fused tier (the port's ``rmt_block_plain``; the kernel's ellipse operand
on the card), the density-contrast disc of
``benchmarks/density_contrast_disc.py`` (``variable_rho``, gravity, free
slip; the CG's iteration counts equal) and the split tier with surface
tension and the area fix. u, v, X1, X2 to 1e-12, p to 1e-11. Then JAX's
checks in its order: the raw height-function warning after the band-mode
one, and the balanced CSF off Neumann walls raising ValueError.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from benchmarks.capillary_drop_coupled import make_ellipse_phi_init
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import state_from_numpy, state_to_numpy
from test_torch_step import jax_numpy, port_config

torch.set_num_threads(1)
DEV = "cpu"

N = 48
STEPS = 3
ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "p": 1e-11,
        "t": 1e-15, "step": 0}
# benchmarks/capillary_drop_coupled.py's configuration (R = 0.2, an
# area-preserving ellipse of eccentricity 1.15)
CAPILLARY = dict(mu_s=1e-3, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=1e-3,
                 rho_f=1.0, gamma=0.1, w_t_cells=2.0, st_method="balanced",
                 num_layers=3, CFL=0.4, dt_min_cap=1e-3)
ELLIPSE = (0.5, 0.5, 0.2 * 1.15, 0.2 / 1.15)
DISC = (0.5, 0.5, 0.2)
# benchmarks/density_contrast_disc.py's configuration, rho_s / rho_f = 10
DENSITY = dict(mu_s=1.0, kappa=0.0, rho_s=10.0, eta_s=0.0, mu_f=1e-3,
               rho_f=1.0, g_y=-1.0, w_t_cells=2.0, variable_rho=True,
               num_layers=3, CFL=0.2, dt_min_cap=1e-3, cg_tol=1e-6,
               cg_maxiter=200)
CASES = {
    "csf_fd": ("disc", dict(CAPILLARY, st_method="csf")),
    "balanced_kstar": ("disc", dict(CAPILLARY, st_kappa_interface=True)),
    "balanced_hf_smooth2": ("disc", dict(CAPILLARY, st_curvature="hf",
                                         st_hf_smooth=2)),
    "capillary_ellipse": ("ellipse", CAPILLARY),
    "density_contrast": ("density", DENSITY),
    "split_csf_area_fix": ("ellipse", dict(CAPILLARY, st_method="csf",
                                           st_kappa_interface=True,
                                           phi_area_fix=True)),
}
_RUNS = {}


def j_disc(x0, y0, R):
    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R
    return phi


def shapes(kind):
    if kind == "ellipse":
        return make_ellipse_phi_init(*ELLIPSE), pt.Ellipse(*ELLIPSE)
    d = (0.5, 0.7, 0.15) if kind == "density" else DISC
    return j_disc(*d), pt.Disc(*d)


def trajectories(case):
    """Both packages' states and aux after each step (cached per case)."""
    if case in _RUNS:
        return _RUNS[case]
    kind, over = CASES[case]
    j_phi, t_phi = shapes(kind)
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0),
                          rmt_method="xla", momentum_method="xla",
                          extrap_method="xla", dct_method="fft", **over)
    tcfg = port_config(jcfg)
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, j_free_slip, (j_phi,),
                               dtype=jnp.float64)
        X, Y = jcfg.grid.coords(dtype=jnp.float64)
        # a swirl, so the interface moves from the first step
        u0 = 0.05 * jnp.sin(np.pi * X) * jnp.cos(np.pi * Y)
        v0 = -0.05 * jnp.cos(np.pi * X) * jnp.sin(np.pi * Y)
        js = jsim.make_init_state(jcfg, (j_phi,), u0=u0, v0=v0,
                                  dtype=jnp.float64)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        tstep = pt.make_step(tcfg, pt.free_slip_box_bc, (t_phi,),
                             dtype=torch.float64, device=DEV)
        traj = []
        for _ in range(STEPS):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            traj.append((jax_numpy(js), {k: np.asarray(v)
                                         for k, v in jaux.items()},
                         state_to_numpy(ts), taux))
    _RUNS[case] = (tstep, traj)
    return _RUNS[case]


@pytest.mark.parametrize("n", range(STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case, n):
    tstep, traj = trajectories(case)
    js, jaux, ts, taux = traj[n]
    for k, atol in ATOL.items():
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                   err_msg=f"{case} step {n + 1}: {k}")
    for k in ("phis", "J", "rho_local"):
        np.testing.assert_allclose(taux[k].numpy(), jaux[k], rtol=0,
                                   atol=1e-12, err_msg=f"aux {k}")
    if case == "density_contrast":
        assert int(taux["cg_iters"]) == int(jaux["cg_iters"]) > 0
        np.testing.assert_allclose(float(taux["cg_relres"]),
                                   float(jaux["cg_relres"]), rtol=1e-6)
    else:
        assert "cg_iters" not in taux
    assert float(np.abs(ts["u"]).max()) > 0.0


def test_paths_of_the_cases():
    """The blocks' paths at the port's defaults: the ellipse on the fused
    tier, the area fix on the split tier, the CG under variable density,
    the face forces under the balanced CSF, the RK4 kernel's path for the
    momentum."""
    expect = {"csf_fd": ("fused", "stencils"),
              "balanced_kstar": ("fused", "faces"),
              "balanced_hf_smooth2": ("fused", "faces"),
              "capillary_ellipse": ("fused", "faces"),
              "density_contrast": ("fused", "cg"),
              "split_csf_area_fix": ("split", "stencils")}
    for case, (solid, proj) in expect.items():
        kind, over = CASES[case]
        cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), **over)
        step = pt.make_step(cfg, pt.free_slip_box_bc, (shapes(kind)[1],),
                            dtype=torch.float64, device=DEV)
        assert step.paths == {"solid": solid, "momentum": "rk4 kernel",
                              "projection": proj}, case


def test_heavy_disc_sinks():
    _, traj = trajectories("density_contrast")
    _, _, ts, taux = traj[-1]
    solid = (taux["phis"][0] <= 0).numpy()
    assert float(ts["v"][solid].mean()) < 0.0


def warning_messages(make):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        make()
    return [str(w.message) for w in rec]


def test_warnings_in_jax_order():
    """Band-mode stress with too few layers, then raw 'hf' on the coupled
    interface: the same messages in the same order in both packages; none
    with st_hf_smooth=2 or gamma=0."""
    over = dict(CAPILLARY, st_curvature="hf", stress_band=True,
                num_layers=3)
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=16, Ny=16, Lx=1.0, Ly=1.0), **over)
    j_phi, t_phi = shapes("disc")
    with jax.disable_jit():
        jw = warning_messages(lambda: jsim.make_step(
            jcfg, j_free_slip, (j_phi,), dtype=jnp.float64))
    tw = warning_messages(lambda: pt.make_step(
        port_config(jcfg), pt.free_slip_box_bc, (t_phi,),
        dtype=torch.float64, device=DEV))
    assert len(jw) == 2 and tw == jw
    assert "stress_band" in tw[0] and "st_curvature='hf'" in tw[1]
    for quiet in (dict(st_hf_smooth=2), dict(gamma=0.0)):
        tw = warning_messages(lambda: pt.make_step(
            port_config(dataclasses.replace(jcfg, **quiet)),
            pt.free_slip_box_bc, (t_phi,), dtype=torch.float64, device=DEV))
        assert not any("st_curvature" in w for w in tw)


def test_balanced_off_neumann_walls_raises_as_in_jax():
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=32, Ny=32, Lx=1.0, Ly=1.0),
                          bc_type="periodic", **CAPILLARY)
    j_phi, t_phi = shapes("disc")
    with pytest.raises(ValueError, match="balanced"):
        jsim.make_step(jcfg, j_free_slip, (j_phi,), dtype=jnp.float64)
    with pytest.raises(ValueError, match="balanced"):
        pt.make_step(port_config(jcfg), pt.periodic_bc, (t_phi,),
                     dtype=torch.float64, device=DEV)
    # variable density needs the Neumann projection too (the JAX step
    # fails on it, reading CG statistics the periodic solve lacks)
    with pytest.raises(ValueError, match="variable_rho"):
        pt.make_step(port_config(dataclasses.replace(
            jcfg, gamma=0.0, variable_rho=True)), pt.periodic_bc, (t_phi,),
            dtype=torch.float64, device=DEV)
