"""Shared cases of the port's gradient tests against ``pyrmt_tpu``
(tests/test_torch_diff*.py): both packages' steps at N=24 float64 from
the same state, and the gradients of sum(u^2 + v^2) + sum(p^2) after a few
steps with respect to the traced scalars and a factor on the initial
velocity.

The JAX step runs unjitted (``step.__wrapped__``: its inner jitted
functions compile once per process), where compiling the whole step and
its gradient took over a minute per configuration.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from pyrmt_tpu.bcs import free_slip_box_bc as j_free_slip
from pyrmt_tpu.bcs import make_lid_bc as j_lid_bc
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu_torch.io import STATE_FIELDS, state_from_numpy

torch.set_num_threads(1)
DEV = "cpu"
F64 = torch.float64

N = 24
STEPS = 3
T_END = 1.0
RTOL = 1e-9
BASE = dict(mu_s=0.3, kappa=0.0, eta_s=0.0, rho_s=1.0, mu_f=0.02, rho_f=1.0,
            fixed_dt=2e-3)
# the adaptive timestep with the solid's P-wave limit binding (dx = 1/23:
# dt_solid 0.0206 under the fluid's 0.026, the viscous 0.028 and the cap)
ADAPTIVE = dict(fixed_dt=None, CFL=0.3, dt_min_cap=0.05, mu_f=0.005)


def j_disc(x0, y0, R):
    def phi(X1, X2):
        return jnp.sqrt((X1 - x0) ** 2 + (X2 - y0) ** 2) - R
    return phi


ONE = ((0.5, 0.5, 0.2),)
TWO = ((0.35, 0.5, 0.15), (0.65, 0.5, 0.15))

# {case: (config overrides, traced names, discs, bc, amplitude)}
CASES = {
    "mu_s, fixed dt": ({}, ("mu_s",), ONE, "free_slip", 0.5),
    "mu_s, adaptive dt": (ADAPTIVE, ("mu_s",), ONE, "free_slip", 0.5),
    "mu_s, adaptive dt, from rest": (ADAPTIVE, ("mu_s",), ONE, "lid", 0.0),
    "gamma, balanced CSF": (
        dict(gamma=0.05, st_method="balanced", st_kappa_interface=True,
             fixed_dt=None, CFL=0.3, dt_min_cap=2e-3), ("gamma",), ONE,
        "free_slip", 0.3),
    "contact, adaptive dt": (
        dict(fixed_dt=None, CFL=0.2, dt_min_cap=1e-3, k_rep=2.0, mu_s=1.0),
        (), TWO, "free_slip", 0.5),
    "kappa, rho_s, rho_f, gravity": (
        dict(kappa=0.5, rho_s=1.5, g_y=-1.0), ("kappa", "rho_s", "rho_f"),
        ONE, "free_slip", 0.5),
    "mu_s, split tier (area fix)": (
        dict(phi_area_fix=True), ("mu_s", "rho_s"), ONE, "free_slip", 0.5),
    "mu_s, general tier (central2)": (
        dict(scheme="central2"), ("mu_s", "rho_s"), ONE, "free_slip", 0.5),
}


def jax_config(**over):
    return jsim.RMTConfig(grid=JGrid(N, N, 1.0, 1.0), extrap_method="xla",
                          rmt_method="xla", momentum_method="xla",
                          dct_method="fft", **dict(BASE, **over))


def port_config(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "grid"}
    g = jcfg.grid
    return pt.RMTConfig(grid=pt.Grid(g.Nx, g.Ny, g.Lx, g.Ly), **fields)


def energy(s, np_):
    return np_.sum(s.u ** 2 + s.v ** 2) + np_.sum(s.p ** 2)


def build(over, names, discs, bc, amp):
    """Both packages' steps and initial states (a Taylor-Green velocity of
    amplitude ``amp``; 0 starts from rest)."""
    jcfg = jax_config(**over)
    tcfg = port_config(jcfg)
    jphis = tuple(j_disc(*d) for d in discs)
    tphis = tuple(pt.Disc(*d) for d in discs)
    jbc, tbc = ((j_free_slip, pt.free_slip_box_bc) if bc == "free_slip"
                else (j_lid_bc(1.0), pt.make_lid_bc(1.0)))
    X, Y = jcfg.grid.coords(jnp.float64)
    u0 = amp * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v0 = -amp * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    js = jsim.make_init_state(jcfg, jphis, u0=u0, v0=v0, dtype=jnp.float64)
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in
                           STATE_FIELDS}, device=DEV, dtype=F64)
    traced = names or None
    jstep = jsim.make_step(jcfg, jbc, jphis, dtype=jnp.float64,
                           traced_params=traced).__wrapped__
    tstep = pt.make_step(tcfg, tbc, tphis, dtype=F64, device=DEV,
                         traced_params=traced)
    return jcfg, js, ts, jstep, tstep


def losses(case, steps=STEPS):
    """(JAX's gradients, the port's, the port's loss): with respect to
    each traced scalar and to a factor ``scale`` on the initial velocity
    (the amplitude's gradient; from rest, the lid drives the flow)."""
    over, names, discs, bc, amp = CASES[case]
    jcfg, js, ts, jstep, tstep = build(over, names, discs, bc, amp)
    vals = {k: getattr(jcfg, k) for k in names}
    vals["scale"] = 1.0

    def jloss(p):
        s = dataclasses.replace(js, u=js.u * p["scale"], v=js.v * p["scale"])
        extra = ({k: p[k] for k in names},) if names else ()
        for _ in range(steps):
            s = jstep(s, T_END, *extra)[0]
        return energy(s, jnp)

    g_j = jax.grad(jloss)({k: jnp.asarray(v, jnp.float64)
                           for k, v in vals.items()})
    leaves = {k: torch.tensor(v, dtype=F64, requires_grad=True)
              for k, v in vals.items()}
    s = dataclasses.replace(ts, u=ts.u * leaves["scale"],
                            v=ts.v * leaves["scale"])
    extra = ({k: leaves[k] for k in names},) if names else ()
    dts = []
    for _ in range(steps):
        s, aux = tstep(s, T_END, *extra)
        dts.append(aux["dt"])
    loss = energy(s, torch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                retain_graph=True)
    g_t = dict(zip(leaves, (float(g) for g in grads)))
    return ({k: float(v) for k, v in g_j.items()}, g_t, dts, leaves)


def check_case(case, result):
    """The port's gradients equal JAX's to RTOL and are finite."""
    g_j, g_t = dict(result[0]), dict(result[1])
    if CASES[case][4] == 0.0:
        # from rest the loss does not depend on a factor on zero
        assert g_t.pop("scale") == g_j.pop("scale") == 0.0
    for k, ref in g_j.items():
        assert np.isfinite(g_t[k]), (case, k, g_t[k])
        assert np.isfinite(ref) and abs(ref) > 0.0, (case, k, ref)
        assert abs(g_t[k] - ref) <= RTOL * abs(ref), (case, k, g_t[k], ref)
