"""The port's ``make_diff_step`` / ``make_diff_rollout`` against
``pyrmt_tpu``, and a variable-density rollout's gradient.

The disc in a Taylor-Green vortex between free-slip walls at N=24 float64
(tests/test_torch_diff_cases.py), 3 steps, the loss sum(u^2 + v^2) + sum(p^2):
``make_diff_step(param_names=('mu_s',))``'s forward is the step's bit for
bit, and the gradient of ``make_diff_rollout`` with respect to mu_s and the
initial velocity equals JAX's (under ``jax.disable_jit``) to 1e-9 relative
and ``make_rollout``'s over the step itself to 1e-12. A variable-density
rollout (the CG's implicit adjoint in every step) has JAX's gradient to
1e-9 through ``make_rollout`` and the same through ``make_diff_rollout``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu as jpkg
import pyrmt_tpu_torch as pt
from test_torch_diff_cases import (
    F64,
    ONE,
    STEPS,
    T_END,
    build,
    energy,
    j_disc,
    port_config,
)

RTOL = 1e-9


def scaled(s, scale):
    return dataclasses.replace(s, u=s.u * scale, v=s.v * scale)


def port_grad(loss, *xs):
    leaves = [torch.tensor(x, dtype=F64, requires_grad=True) for x in xs]
    g = torch.autograd.grad(loss(*leaves), leaves)
    return [float(v) for v in g]


def test_diff_step_forward_and_gradient_match_jax():
    jcfg, js, ts, _, tstep = build({}, ("mu_s",), ONE, "free_slip", 0.5)
    tcfg = port_config(jcfg)
    dstep = pt.make_diff_step(tcfg, pt.free_slip_box_bc, (pt.Disc(*ONE[0]),),
                              dtype=F64, device="cpu", param_names=("mu_s",))
    mu = torch.tensor(0.3, dtype=F64)
    out_d = dstep(ts, T_END, {"mu_s": mu})
    out_s, _ = tstep(ts, T_END, {"mu_s": mu})
    for k in ("u", "v", "p", "X1", "X2", "t", "step"):
        assert torch.equal(getattr(out_d, k), getattr(out_s, k)), k
    assert out_d.step.dtype == torch.int32 and not out_d.step.requires_grad

    jd = jpkg.make_diff_step(jcfg, jpkg.free_slip_box_bc, (j_disc(*ONE[0]),),
                             dtype=jnp.float64, param_names=("mu_s",))
    jroll = jpkg.make_diff_rollout(jd, STEPS, with_params=True)
    with jax.disable_jit():
        g_j = jax.grad(lambda m, sc: energy(jroll(
            scaled(js, sc), T_END, {"mu_s": m}), jnp), argnums=(0, 1))(
            jnp.asarray(0.3), jnp.asarray(1.0))
    troll = pt.make_diff_rollout(dstep, STEPS, with_params=True)
    g_t = port_grad(lambda m, sc: energy(
        troll(scaled(ts, sc), T_END, {"mu_s": m}), torch), 0.3, 1.0)
    for a, b in zip(g_t, g_j):
        assert np.isfinite(a) and abs(a - float(b)) <= RTOL * abs(float(b))
    # the same gradient as make_rollout over the step itself
    roll = pt.make_rollout(tstep, STEPS)
    g_r = port_grad(lambda m, sc: energy(
        roll(scaled(ts, sc), T_END, {"mu_s": m}), torch), 0.3, 1.0)
    for a, b in zip(g_t, g_r):
        assert abs(a - b) <= 1e-12 * abs(b)
    with pytest.raises(ValueError, match="kappa"):
        dstep(ts, T_END, {"mu_s": mu, "kappa": mu})
    with pytest.raises(TypeError):
        dstep(ts, T_END)


def test_variable_density_rollout_matches_jax():
    over = dict(rho_s=2.0, variable_rho=True, cg_tol=1e-12, cg_maxiter=400)
    jcfg, js, ts, jstep, tstep = build(over, (), ONE, "free_slip", 1.0)

    def jloss(sc):
        s = scaled(js, sc)
        for _ in range(STEPS):
            s = jstep(s, T_END)[0]
        return energy(s, jnp)

    g_j = float(jax.grad(jloss)(jnp.asarray(1.0)))
    roll = pt.make_rollout(tstep, STEPS)
    g_t = port_grad(lambda sc: energy(roll(scaled(ts, sc), T_END), torch),
                    1.0)[0]
    assert np.isfinite(g_t) and abs(g_t - g_j) <= RTOL * abs(g_j)
    tcfg = port_config(jcfg)
    droll = pt.make_diff_rollout(pt.make_diff_step(
        tcfg, pt.free_slip_box_bc, (pt.Disc(*ONE[0]),), dtype=F64,
        device="cpu"), STEPS)
    g_d = port_grad(lambda sc: energy(droll(scaled(ts, sc), T_END), torch),
                    1.0)[0]
    assert abs(g_d - g_t) <= 1e-12 * abs(g_t)
