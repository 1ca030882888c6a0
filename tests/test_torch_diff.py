"""The port's traced physics scalars and step gradients against
``pyrmt_tpu``.

``make_step(traced_params=...)`` in both packages, float64 at N=24, from
the same state (``state_from_numpy`` of the JAX one): a disc in a
Taylor-Green vortex between free-slip walls (the JAX package's
tests/test_diff.py case). The loss is sum(u^2 + v^2) + sum(p^2) after 3
steps; its gradients with respect to the traced scalars and to the
initial velocity amplitude agree with JAX's to 1e-9 relative and are
finite, with the fixed and the adaptive timestep (the solid's P-wave limit
binding), from rest under the lid (the speed norm's sqrt at 0) and for
gamma on the balanced-CSF drop (tests/test_torch_diff_cases.py; the contact,
gravity and the other tiers are in test_torch_diff_tiers.py). The traced
step's forward is the default build's bit for bit, in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from test_torch_diff_cases import (
    ADAPTIVE,
    DEV,
    F64,
    ONE,
    STEPS,
    T_END,
    build,
    check_case,
    j_disc,
    j_free_slip,
    jax_config,
    losses,
    port_config,
)

CASES = ("mu_s, fixed dt", "mu_s, adaptive dt",
         "mu_s, adaptive dt, from rest", "gamma, balanced CSF")


@pytest.fixture(scope="module")
def cache():
    return {}


def case_grads(cache, case):
    if case not in cache:
        cache[case] = losses(case)
    return cache[case]


@pytest.mark.parametrize("case", CASES)
def test_grad_matches_jax(cache, case):
    check_case(case, case_grads(cache, case))


def test_adaptive_dt_depends_on_mu_s(cache):
    """The adaptive cases' dt is the solid's P-wave limit: dt itself
    carries a gradient with respect to mu_s (both from a moving field and
    from rest, where the speed norm's sqrt sits at 0)."""
    for case in ("mu_s, adaptive dt", "mu_s, adaptive dt, from rest"):
        _, _, dts, leaves = case_grads(cache, case)
        g = torch.autograd.grad(dts[0], leaves["mu_s"], retain_graph=True)[0]
        assert float(g) < 0.0, (case, float(g))
    _, _, dts, leaves = case_grads(cache, "mu_s, fixed dt")
    assert not dts[0].requires_grad


@pytest.mark.parametrize("package", ["port", "jax"])
def test_traced_step_matches_default_build(package):
    """With the cfg's own values, the traced step computes the default
    build's state bit for bit, on the adaptive timestep (the tensor path
    of compute_timestep) with every traceable scalar traced."""
    over = dict(ADAPTIVE, gamma=0.02, kappa=0.4)
    names = jsim._TRACEABLE_PARAMS
    jcfg, js, ts, jstep, tstep = build(over, names, ONE, "free_slip", 0.5)
    vals = {k: getattr(jcfg, k) for k in names}
    if package == "jax":
        jdef = jsim.make_step(jcfg, j_free_slip, (j_disc(*ONE[0]),),
                              dtype=jnp.float64).__wrapped__
        a = b = js
        params = {k: jnp.asarray(v, jnp.float64) for k, v in vals.items()}
        for _ in range(STEPS):
            a = jdef(a, T_END)[0]
            b = jstep(b, T_END, params)[0]
        pairs = [(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
                 for k in ("u", "v", "p", "X1", "X2", "t")]
    else:
        tdef = pt.make_step(port_config(jcfg), pt.free_slip_box_bc,
                            (pt.Disc(*ONE[0]),), dtype=F64, device=DEV)
        a = b = ts
        params = {k: torch.tensor(v, dtype=F64) for k, v in vals.items()}
        for _ in range(STEPS):
            a = tdef(a, T_END)[0]
            b = tstep(b, T_END, params)[0]
        pairs = [(getattr(a, k).numpy(), getattr(b, k).numpy())
                 for k in ("u", "v", "p", "X1", "X2", "t")]
    for x, y in pairs:
        assert np.array_equal(x, y)


def test_unknown_traced_param_raises_as_jax():
    jcfg = jax_config()
    with pytest.raises(ValueError, match="not traceable") as j_err:
        jsim.make_step(jcfg, j_free_slip, (j_disc(*ONE[0]),),
                       dtype=jnp.float64, traced_params=("mu_s", "eta_s"))
    with pytest.raises(ValueError) as t_err:
        pt.make_step(port_config(jcfg), pt.free_slip_box_bc,
                     (pt.Disc(*ONE[0]),), dtype=F64, device=DEV,
                     traced_params=("mu_s", "eta_s"))
    assert str(t_err.value) == str(j_err.value)


def test_unknown_runtime_key_raises():
    """The JAX step drops a params key outside traced_params silently;
    the port's raises."""
    cfg = port_config(jax_config())
    step = pt.make_step(cfg, pt.free_slip_box_bc, (pt.Disc(*ONE[0]),),
                        dtype=F64, device=DEV, traced_params=("mu_s",))
    s = pt.make_init_state(cfg, (pt.Disc(*ONE[0]),), dtype=F64, device=DEV)
    mu = torch.tensor(0.3, dtype=F64)
    with pytest.raises(ValueError, match="kappa"):
        step(s, T_END, {"mu_s": mu, "kappa": mu})
    with pytest.raises(KeyError):
        step(s, T_END, {})
    out, _ = step(s, T_END, {"mu_s": mu})
    assert int(out.step) == 1
