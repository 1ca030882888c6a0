"""Two solids in contact, and gravity: the port against ``pyrmt_tpu``.

- ``rmt_block_plain`` with two discs and the two-solid clamp (4.0) against
  ``pyrmt_tpu.kernels.rmt_block.rmt_block_fused(..., interpret=True)``,
  N=64 float64, the second map stretched so that the clamp bites: all 12
  outputs to 1e-13, J to 1e-12. One extrapolation layer: the interpreter
  compiles the kernel's unrolled layer sweeps in ~12 s at L = 1, ~45 s at
  L = 2 and ~145 s at L = 3, and nothing of the layers depends on the
  number of solids (tests/test_torch_rmt_block.py holds L = 3).
- ``momentum_core`` with a nonzero force under the free-slip BC, without
  Kelvin-Voigt damping as in the contact configuration, against
  ``momentum_rk4_pallas(..., has_ext=True, interpret=True)``, to 1e-12.
- 5 steps of ``make_step`` against ``pyrmt_tpu.sim.make_step`` on its XLA
  paths (jit disabled, op by op), from the JAX initial state: the
  head-on collision with touching contact bands (the discs of
  tests/test_sharding.py's contact test), with gravity, with Kelvin-Voigt
  damping, and on the split tier with the area fix. u, v, X1, X2 to 1e-12,
  p to 1e-11, and the contact force acts on every step.
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
from pyrmt_tpu.kernels.momentum_rk4 import momentum_rk4_pallas
from pyrmt_tpu.kernels.rmt_block import rmt_block_fused as j_rmt_block
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_plain
from pyrmt_tpu_torch.physics import momentum_core
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
DX = 1.0 / (N - 1)
DISCS = ((0.38, 0.5, 0.14), (0.66, 0.5, 0.14))  # contact bands touch
NAMES = ("X1e", "X2e", "phis", "sxx", "sxy", "syy", "J", "Hf", "rho_local",
         "sig_sxx_el", "sig_sxy_el", "sig_syy_el")


def j_disc(x0, y0, R):
    def phi(X, Y):
        return jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R

    return phi


J_PHIS = tuple(j_disc(*d) for d in DISCS)
T_PHIS = tuple(pt.Disc(*d) for d in DISCS)


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def block():
    """Both packages' two-solid blocks on the same inputs: the maps of
    make_init_state, the second stretched 3x along x and 2x along y about
    its centre (det G = 6, clamped to 4), a Taylor-Green velocity."""
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), mu_s=1.0,
                          kappa=0.5, rho_s=1.3, k_rep=2.0, num_layers=1)
    js = jsim.make_init_state(jcfg, J_PHIS, dtype=jnp.float64)
    x0, y0, _ = DISCS[1]
    X1 = np.array(js.X1)
    X2 = np.array(js.X2)
    X1[1] = np.where(X1[1] != 0, x0 + 3.0 * (X1[1] - x0), X1[1])
    X2[1] = np.where(X2[1] != 0, y0 + 2.0 * (X2[1] - y0), X2[1])
    x = np.arange(N) * DX
    X, Y = np.meshgrid(x, x)
    u = 0.3 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    dt = 1e-3
    kw = dict(dx=DX, dy=DX, num_layers=1, w_t=jcfg.w_t, stress_clamp=4.0)
    scalars = dict(mu_s=1.0, kappa=0.5, rho_s=1.3, rho_f=1.0)
    ref = j_rmt_block(*(jnp.asarray(a) for a in (u, v, X1, X2)), dt,
                      phi_inits=J_PHIS, interpret=True, **kw, **scalars)
    out = rmt_block_plain(*(tt(a) for a in (u, v, X1, X2, dt)),
                          phi_inits=T_PHIS, params=tt(list(scalars.values())),
                          **kw)
    return out, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_two_solid_block_matches_pallas_interpret(block, i):
    out, ref = block
    assert out[i].shape == ref[i].shape
    atol = 1e-12 if NAMES[i] == "J" else 1e-13
    np.testing.assert_allclose(out[i].numpy(), ref[i], rtol=0, atol=atol)


def test_two_solid_clamp_bites(block):
    """J reaches 1/4 in the stretched solid: the clamp is on the path."""
    out, _ = block
    J, phis = out[6], out[2]
    assert float(J[1][phis[1] <= 0].min()) == 0.25
    assert float(J[0][phis[0] <= 0].min()) > 0.25


def momentum_case(seed=0):
    """Taylor-Green velocity with noise, the blended fields of a disc at
    (0.6, 0.5), a density contrast of 10, and a contact-like force plus
    buoyancy (pyrmt_tpu's has_ext test, tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    x = np.arange(N) * DX
    X, Y = np.meshgrid(x, x)
    u = 0.1 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.1 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    u += 0.01 * rng.standard_normal((N, N))
    v += 0.01 * rng.standard_normal((N, N))
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    phi = np.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2
    H = 0.5 * (1 + np.tanh(phi / (2 * DX)))
    one_m = 1.0 - H
    sxx = one_m * (1.0 + 0.1 * np.sin(3 * X))
    sxy = one_m * 0.05 * np.cos(2 * Y)
    syy = one_m * (1.0 - 0.1 * X * Y)
    rho = H * 1.0 + one_m * 10.0
    fx = 0.02 * np.sin(np.pi * X) + 0.01 * rng.standard_normal((N, N))
    fy = (rho - 1.0) * (-1.0)
    mkv = (phi <= 0).astype(np.float64) * one_m
    return (u, v, p, sxx, sxy, syy, H, rho), fx, fy, mkv


def test_momentum_with_force_matches_pallas_interpret():
    fields, fx, fy, mkv = momentum_case()
    kw = dict(dt=1e-3, dx=DX, dy=DX, mu_f=0.01, eta_s=0.0)
    bc = j_free_slip
    ref = momentum_rk4_pallas(
        *(jnp.asarray(f) for f in fields), jnp.asarray(fx), jnp.asarray(fy),
        jnp.asarray(mkv), bc_spec=bc.kernel_spec, has_ext=True,
        interpret=True, **kw)
    out = momentum_core(*(tt(f) for f in fields), tt(mkv), pt.free_slip_box_bc,
                        f_ext_x=tt(fx), f_ext_y=tt(fy), **kw)
    free = momentum_core(*(tt(f) for f in fields), tt(mkv),
                         pt.free_slip_box_bc, **kw)
    for o, r, f in zip(out, ref, free):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)
        assert float((o - f).abs().max()) > 1e-6  # the force acts


# the head-on collision of benchmarks/two_disc_contact.py's configuration
# at N=64, with the touching discs of tests/test_sharding.py
CONTACT = dict(mu_s=1.0, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=0.01,
               rho_f=1.0, w_t_cells=2.0, w_c_cells=3.0, k_rep=2.0,
               two_solid_clamp=4.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
CASES = {
    "contact": {},
    "gravity": dict(g_y=-1.0, rho_s=1.2),
    "kelvin_voigt": dict(eta_s=0.01),
    "split_area_fix": dict(phi_area_fix=True),
}
STEPS = 5
ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "p": 1e-11,
        "t": 1e-15, "step": 0}
_RUNS = {}


def jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def trajectories(case):
    """Both packages' states and aux after each of the STEPS steps (cached
    per case)."""
    if case in _RUNS:
        return _RUNS[case]
    jcfg = jsim.RMTConfig(
        grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), rmt_method="xla",
        momentum_method="xla", extrap_method="xla", dct_method="fft",
        **dict(CONTACT, **CASES[case]))
    tcfg = port_config(jcfg)
    assert pt.sim.rmt_block_split_eligible(tcfg, 2) == tcfg.phi_area_fix
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, j_free_slip, J_PHIS, dtype=jnp.float64)
        X, _ = jcfg.grid.coords(dtype=jnp.float64)
        js = jsim.make_init_state(jcfg, J_PHIS,
                                  u0=0.3 * jnp.tanh((0.52 - X) * 8.0),
                                  dtype=jnp.float64)
        ts = state_from_numpy(jax_numpy(js), device=DEV, dtype=torch.float64)
        tstep = pt.make_step(tcfg, pt.free_slip_box_bc, T_PHIS,
                             dtype=torch.float64, device=DEV)
        traj = []
        for _ in range(STEPS):
            js, jaux = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, taux = tstep(ts, 1.0)
            traj.append((jax_numpy(js), {k: np.asarray(v)
                                         for k, v in jaux.items()},
                         state_to_numpy(ts), taux))
    _RUNS[case] = (tcfg, traj)
    return _RUNS[case]


@pytest.mark.parametrize("n", range(STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_two_solid_step_matches_jax(case, n):
    tcfg, traj = trajectories(case)
    js, jaux, ts, taux = traj[n]
    for k, atol in ATOL.items():
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                   err_msg=f"{case} step {n + 1}: {k}")
    for k in ("phis", "J", "rho_local"):
        np.testing.assert_allclose(taux[k].numpy(), jaux[k], rtol=0,
                                   atol=1e-12, err_msg=f"aux {k}")
    # the contact force acts: the contact bands overlap inside a solid
    # (tests/test_sharding.py's predicate), and the force is nonzero
    phis = jaux["phis"]
    assert (np.abs(phis[0] - phis[1]) * 0.5 < tcfg.w_c)[
        (phis[0] <= 0) | (phis[1] <= 0)].any()
    f = pt.external_forces(taux["phis"], None, tcfg.grid.dx, tcfg.grid.dy,
                           gamma=0.0, k_rep=tcfg.k_rep, w_c=tcfg.w_c,
                           w_t=tcfg.w_t)
    assert float(f[0].abs().max()) > 0.0


def test_gravity_moves_the_heavier_discs_down():
    """With g_y = -1 and rho_s = 1.2 the discs sink relative to the
    gravity-free run: the mean vertical velocity over the solids is lower."""
    _, grav = trajectories("gravity")
    _, free = trajectories("contact")
    vs = []
    for traj in (grav, free):
        s, aux = traj[-1][2], traj[-1][3]
        solid = (aux["phis"] <= 0).any(dim=0).numpy()
        vs.append(float(s["v"][solid].mean()))
    assert vs[0] < vs[1]


def test_configs_of_the_slice_build():
    """Two solids with contact and gravity build on both tiers; three
    solids too; with surface tension (the balanced CSF) too; with zero
    solids the same configuration is the pure-fluid step, which gravity
    leaves at rest."""
    g = pt.Grid(32, 32, 1.0, 1.0)
    three = T_PHIS + (pt.Disc(0.52, 0.8, 0.12),)
    for extra in ({}, dict(phi_area_fix=True), dict(reinit_method="pde")):
        cfg = pt.RMTConfig(grid=g, g_y=-1.0, **dict(CONTACT, **extra))
        step = pt.make_step(cfg, pt.free_slip_box_bc, three,
                            dtype=torch.float64, device=DEV)
        s = pt.make_init_state(cfg, three, dtype=torch.float64, device=DEV)
        s, aux = step(s, 1.0)
        assert aux["J"].shape == (3, 32, 32) and not bool(pt.diverged(s))
    st_cfg = dataclasses.replace(cfg, gamma=0.1, st_method="balanced")
    step = pt.make_step(st_cfg, pt.free_slip_box_bc, T_PHIS,
                        dtype=torch.float64, device=DEV)
    s, aux = step(pt.make_init_state(st_cfg, T_PHIS, dtype=torch.float64,
                                     device=DEV), 1.0)
    assert step.paths["projection"] == "faces"
    assert aux["J"].shape == (2, 32, 32) and not bool(pt.diverged(s))
    step = pt.make_step(cfg, pt.free_slip_box_bc, (), dtype=torch.float64,
                        device=DEV)
    s, aux = step(pt.make_init_state(cfg, (), dtype=torch.float64,
                                     device=DEV), 1.0)
    assert aux["J"].shape == (0, 32, 32) and int(s.step) == 1
    assert float(s.u.abs().max()) == 0.0 == float(s.v.abs().max())
