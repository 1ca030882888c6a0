"""The projection's stencil passes against ``pyrmt_tpu``, float64 on the CPU.

``rc_rhs_plain`` and ``grad_correct_plain`` (the plain versions of the
CUDA kernels) against the Pallas kernels ``rc_rhs_pallas`` and
``grad_correct_pallas`` in interpret mode at N=64, the recipe of
tests/test_pallas.py's projection-stencil test, and against JAX's XLA ops
on an odd grid (N=65), where the TPU kernels' row tiling does not divide
the grid; max-abs <= 1e-13 of the field's size. Then the port's step with
``projection_method='pallas'`` against JAX's, 3 steps of the flagship at
N=32: u, v, X1, X2 to 1e-12, p to 1e-11. The JAX step runs with jit
disabled (op by op takes seconds, compiling it tens of seconds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as j_bcs
import pyrmt_tpu.ops.poisson as jp
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.projection_stencils as ps
from __graft_entry__ import _flagship
from pyrmt_tpu.kernels.projection_stencils import (
    grad_correct_pallas,
    rc_rhs_pallas,
)
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy, state_to_numpy
from test_torch_step import port_config

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

ATOL = 1e-13
STEP_ATOL = {"u": 1e-12, "v": 1e-12, "X1": 1e-12, "X2": 1e-12, "p": 1e-11,
             "t": 1e-15, "step": 0}
BCS = {"lid": (j_bcs.make_lid_bc(0.7), pt.make_lid_bc(0.7)),
       "free_slip": (j_bcs.free_slip_box_bc, pt.free_slip_box_bc),
       "noop": (j_bcs.noop_bc, pt.noop_bc)}


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def assert_close(out, ref):
    """max-abs <= ATOL times max(1, max |ref|): rho div / dt is ~4e3 here,
    where 1e-13 is below an ulp (9e-13), and XLA on the CPU rounds the
    Pallas kernel, its own ops and the port's ops a few ulps apart."""
    ref = np.asarray(ref)
    err = float(np.max(np.abs(out.numpy() - ref)))
    assert err <= ATOL * max(1.0, float(np.max(np.abs(ref)))), err


def fields(N, seed=0):
    """tests/test_pallas.py's projection fields with seeded noise; a
    constant-rho array, the fused path's contract."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / (N - 1)
    x = np.arange(N) * dx
    X, Y = np.meshgrid(x, x)
    a = 0.3 * np.sin(2 * np.pi * X) * np.cos(3 * np.pi * Y)
    b = -0.2 * np.cos(3 * np.pi * X) * np.sin(2 * np.pi * Y)
    a += 0.01 * rng.standard_normal((N, N))
    b += 0.01 * rng.standard_normal((N, N))
    p = 0.1 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    rho = np.full((N, N), 1.3)
    return dx, a, b, p, rho, 1.3e-3


def test_rc_rhs_plain_matches_pallas_interpret():
    dx, a, b, p, rho, dt = fields(64)
    d = dt / np.mean(rho)
    ref = rc_rhs_pallas(*(jnp.asarray(f) for f in (a, b, p, rho)), dt, d, dx,
                        dx, interpret=True)
    out = ps.rc_rhs_plain(tt(a), tt(b), tt(p), tt(rho), tt(dt), tt(d), dx, dx)
    assert_close(out, ref)
    assert float(out.abs().max()) > 1.0  # a real divergence


@pytest.mark.parametrize("bc_name", list(BCS))
def test_grad_correct_plain_matches_pallas_interpret(bc_name):
    dx, a, b, p, rho, dt = fields(64, seed=1)
    j_bc, t_bc = BCS[bc_name]
    ref = grad_correct_pallas(*(jnp.asarray(f) for f in (p, a, b, rho)), dt,
                              dx, dx, j_bc.kernel_spec, interpret=True)
    out = ps.grad_correct_plain(tt(p), tt(a), tt(b), tt(rho), tt(dt), dx, dx,
                                t_bc)
    for o, r in zip(out, ref):
        assert_close(o, r)


@pytest.mark.parametrize("bc_name", list(BCS))
def test_odd_grid_matches_xla_ops(bc_name):
    """N=65, where the TPU kernels cannot tile the rows; the plain versions
    against JAX's composed ops, as pressure_projection's XLA branch
    composes them."""
    dx, a, b, p, rho, dt = fields(65, seed=2)
    j_bc, t_bc = BCS[bc_name]
    ja, jb, jpp, jrho = (jnp.asarray(f) for f in (a, b, p, rho))
    ref = jrho * jp.compute_divergence_rc(ja, jb, jpp, dt, jrho, dx, dx,
                                          False) / dt
    out = ps.rc_rhs_plain(tt(a), tt(b), tt(p), tt(rho), tt(dt),
                          tt(dt) / tt(rho).mean(), dx, dx)
    assert_close(out, ref)
    dpdx, dpdy = jp.compute_pressure_gradient(jpp, dx, dx)
    ref = j_bc(ja - (dt / jrho) * dpdx, jb - (dt / jrho) * dpdy)
    out = ps.grad_correct_plain(tt(p), tt(a), tt(b), tt(rho), tt(dt), dx, dx,
                                t_bc)
    for o, r in zip(out, ref):
        assert_close(o, r)


def test_cpu_tensors_take_the_plain_versions():
    dx, a, b, p, rho, dt = fields(16)
    args = (tt(a), tt(b), tt(p), tt(rho), tt(dt))
    before = (ps.rc_rhs_launches, ps.grad_correct_launches)
    d = args[4] / args[3].mean()
    assert torch.equal(ps.rc_rhs_fused(*args, d, dx, dx),
                       ps.rc_rhs_plain(*args, d, dx, dx))
    bc = pt.make_lid_bc(1.0)
    for o, r in zip(ps.grad_correct_fused(args[2], *args[:2], *args[3:], dx,
                                          dx, bc),
                    ps.grad_correct_plain(args[2], *args[:2], *args[3:], dx,
                                          dx, bc)):
        assert torch.equal(o, r)
    assert (ps.rc_rhs_launches, ps.grad_correct_launches) == before
    assert all(ps.projection_stencils_supported(bc)
               for bc in (bc, pt.free_slip_box_bc, pt.noop_bc))
    assert not ps.projection_stencils_supported(lambda u, v: (u, v))


def j_tg_state(jcfg):
    """JAX's flagship init state with a Taylor-Green velocity."""
    X, Y = jcfg.grid.coords(dtype=jnp.float64)
    u0 = 0.4 * jnp.sin(jnp.pi * X) * jnp.cos(jnp.pi * Y)
    v0 = -0.4 * jnp.cos(jnp.pi * X) * jnp.sin(jnp.pi * Y)
    return u0, v0


def step_trajectories(j_overrides, t_overrides, N=32, steps=3, **impls):
    """Both packages' states after each of ``steps`` flagship steps from
    JAX's initial state: JAX on its XLA paths plus ``j_overrides``, the
    port with ``t_overrides`` on top of the same fields and the ``impls``
    substitutes of its make_step."""
    jcfg, jbc, jphis = _flagship(N, jnp.float64)
    jcfg = dataclasses.replace(jcfg, rmt_method="xla", momentum_method="xla",
                               extrap_method="xla", dct_method="fft",
                               **j_overrides)
    tcfg = dataclasses.replace(port_config(jcfg), **t_overrides)
    with jax.disable_jit():
        jstep = jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64)
        u0, v0 = j_tg_state(jcfg)
        js = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0,
                                  dtype=jnp.float64)
        ts = state_from_numpy({k: np.asarray(getattr(js, k))
                               for k in STATE_FIELDS}, device=DEV,
                              dtype=torch.float64)
        tstep = pt.make_step(tcfg, pt.make_lid_bc(1.0),
                             (pt.Disc(0.6, 0.5, 0.2),), dtype=torch.float64,
                             device=DEV, **impls)
        traj = []
        for _ in range(steps):
            js, _ = jstep(js, jnp.asarray(1.0, jnp.float64))
            ts, _ = tstep(ts, 1.0)
            traj.append(({k: np.asarray(getattr(js, k))
                          for k in STATE_FIELDS}, state_to_numpy(ts)))
    return traj


def assert_steps_match(traj):
    for n, (js, ts) in enumerate(traj):
        for k, atol in STEP_ATOL.items():
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=atol,
                                       err_msg=f"step {n + 1}: {k}")
    assert not np.array_equal(traj[-1][1]["u"], traj[0][1]["u"])


def test_projection_stencil_step_matches_jax():
    """JAX's step with projection_method='pallas' runs the Pallas stencils
    in interpret mode on the CPU; the port's runs rc_rhs_fused and
    grad_correct_fused, which take their plain versions on a CPU state."""
    pallas = dict(projection_method="pallas")
    assert_steps_match(step_trajectories(pallas, pallas))


@pytest.mark.parametrize("method", ["pallas", "auto"])
def test_step_selects_the_stencil_pair(method):
    """projection_method='pallas' runs the stencil pair once per step
    (here substitutes that count their calls); 'auto' the plain ops."""
    calls = []

    def rc(*a):
        calls.append("rc_rhs")
        return ps.rc_rhs_fused(*a)

    def gc(*a):
        calls.append("grad_correct")
        return ps.grad_correct_fused(*a)

    cfg = pt.RMTConfig(grid=pt.Grid(16, 16, 1.0, 1.0), mu_s=0.1, mu_f=0.01,
                       projection_method=method)
    disc = pt.Disc(0.6, 0.5, 0.2)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (disc,),
                        dtype=torch.float64, device=DEV,
                        projection_stencils_impl=(rc, gc))
    s = pt.make_init_state(cfg, (disc,), dtype=torch.float64, device=DEV)
    for _ in range(2):
        s, _ = step(s, 1.0)
    assert calls == (["rc_rhs", "grad_correct"] * 2 if method == "pallas"
                     else [])
