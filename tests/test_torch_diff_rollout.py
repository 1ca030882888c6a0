"""The port's ``make_rollout`` and the variable-density CG's implicit
adjoint against ``pyrmt_tpu``.

The disc in a Taylor-Green vortex between free-slip walls at N=24 float64
(tests/test_torch_diff_cases.py), 3 steps, the loss sum(u^2 + v^2) + sum(p^2):
``make_rollout``'s forward is ``make_run_chunk``'s bit for bit, and its
gradient is the same with and without the checkpointing and equals JAX's
``make_rollout``'s (1e-9 relative; JAX's under ``jax.disable_jit``, its
scan a Python loop: compiling it took over a minute). The CG's adjoint
gives d rhs and d inv_rho equal to JAX's custom VJP (1e-8 of the largest
at cg_tol 1e-10), and autograd does not unroll the loop: the gradient does
not depend on how often the loop reads its stopping test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyrmt_tpu as jpkg
import pyrmt_tpu.ops.poisson as jpo
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.ops.poisson as tpo
from test_torch_diff_cases import (
    F64,
    ONE,
    STEPS,
    T_END,
    build,
    energy,
    j_disc,
)

RTOL = 1e-9


def scaled(s, scale):
    return dataclasses.replace(s, u=s.u * scale, v=s.v * scale)


def leaf(x):
    return torch.tensor(x, dtype=F64, requires_grad=True)


def port_grad(loss, *xs):
    leaves = [leaf(x) for x in xs]
    g = torch.autograd.grad(loss(*leaves), leaves)
    return [float(v) for v in g]


def test_rollout_forward_is_run_chunk_and_remat_grads_agree():
    _, _, ts, _, tstep = build({}, (), ONE, "free_slip", 0.5)
    ref, _ = pt.make_run_chunk(tstep, STEPS)(ts, T_END)
    out = pt.make_rollout(tstep, STEPS, remat=True)(ts, T_END)
    for k in ("u", "v", "p", "X1", "X2", "t", "step"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k

    def loss(remat):
        roll = pt.make_rollout(tstep, STEPS, remat=remat)
        return lambda sc: energy(roll(scaled(ts, sc), T_END), torch)

    g_remat = port_grad(loss(True), 1.0)[0]
    g_plain = port_grad(loss(False), 1.0)[0]
    assert np.isfinite(g_plain) and g_remat == g_plain


def test_rollout_with_traced_params_matches_jax():
    """d/d(mu_s) and d/d(scale) through both packages' make_rollout."""
    jcfg, js, ts, _, tstep = build({}, ("mu_s",), ONE, "free_slip", 0.5)
    jstep = jpkg.make_step(jcfg, jpkg.free_slip_box_bc,
                           (j_disc(*ONE[0]),),
                           dtype=jnp.float64, traced_params=("mu_s",))
    def jloss(mu, sc):
        # make_rollout's step takes (state, t_end): close over mu
        roll = jpkg.make_rollout(lambda s, t: jstep(s, t, {"mu_s": mu}),
                                 STEPS)
        return energy(roll(scaled(js, sc), T_END), jnp)

    with jax.disable_jit():
        g_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(0.3),
                                             jnp.asarray(1.0))
    roll = pt.make_rollout(tstep, STEPS)
    g_t = port_grad(lambda mu, sc: energy(
        roll(scaled(ts, sc), T_END, {"mu_s": mu}), torch), 0.3, 1.0)
    for a, b in zip(g_t, g_j):
        assert np.isfinite(a) and abs(a - float(b)) <= RTOL * abs(float(b))


def cg_case(n=24):
    """The JAX package's CG adjoint case: rhs, 1/rho (a disc four times
    denser behind a logistic interface), a weight field, dx."""
    dx = 1.0 / (n - 1)
    yy, xx = np.mgrid[0:n, 0:n] * dx
    rhs = np.sin(2 * np.pi * xx) * np.cos(np.pi * yy)
    rho = 1.0 + 4.0 / (1.0 + np.exp(
        -(((xx - 0.5) ** 2 + (yy - 0.5) ** 2) - 0.09) / 0.01))
    wt = np.random.RandomState(0).randn(n, n)
    return rhs, 1.0 / rho, wt, dx


def port_cg_grads(rhs, ir, wt, dx, tol=1e-10):
    n = rhs.shape[0]
    eig = tpo.precompute_poisson_eigenvalues(n, n, dx, dx, F64, "cpu")
    mats = tpo.precompute_dct_matrices(n, n, F64, "cpu")
    r, i = leaf(rhs), leaf(ir)
    p, iters, relres = tpo.solve_variable_poisson_cg_counted(
        r, i, eig, dx, dx, tol=tol, maxiter=500, dct_mats=mats)
    assert not iters.requires_grad and not relres.requires_grad
    assert type(p.grad_fn).__name__.startswith("_CGAdjoint")
    g = torch.autograd.grad(torch.sum(p * torch.tensor(wt)), (r, i))
    return g[0].numpy(), g[1].numpy()


def test_cg_adjoint_matches_jax_custom_vjp():
    rhs, ir, wt, dx = cg_case()
    n = rhs.shape[0]
    eig = jpo.precompute_poisson_eigenvalues(n, n, dx, dx, dtype=jnp.float64)

    def loss(r, i):
        p = jpo.solve_variable_poisson_cg(r, i, eig, dx, dx, tol=1e-10,
                                          maxiter=500)
        return jnp.sum(p * jnp.asarray(wt))

    gj = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(rhs), jnp.asarray(ir))]
    gt = port_cg_grads(rhs, ir, wt, dx)
    for a, b in zip(gt, gj):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max())


def test_cg_adjoint_is_not_the_unrolled_loop(monkeypatch):
    """The loop runs masked iterations between host reads; were autograd
    to record them, the gradient would be the unrolled loop's. The
    adjoint's is the same for every spacing of the reads."""
    rhs, ir, wt, dx = cg_case()
    ref = port_cg_grads(rhs, ir, wt, dx)
    for every in (1, 7):
        monkeypatch.setattr(tpo, "CG_READ_EVERY", every)
        got = port_cg_grads(rhs, ir, wt, dx)
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
