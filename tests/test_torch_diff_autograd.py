"""The kernels' autograd wrapper (``kernels._autograd.launch``) on the CPU.

On the card each CUDA entry point runs its kernel forward and its plain
version's autograd backward. A CUDA kernel cannot run here, so the tests
hand ``launch`` each entry point's plain version as the "kernel": for all
seven entry points (and the RK4 update's periodic and force modes) the
outputs and the input gradients equal plain autograd's bit for bit,
float64 at N=32 on the flagship's fields. The wrapper calls its kernel
once, in the forward, and not at all without a gradient to take. Two
traps of the step's gradient: the level sets' norm at a shape's centre
(finite, the double-where) and the derivative with respect to a t_end
that clips the last step (central differences).
"""
import functools

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.kernels import _autograd
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_plain,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.kernels.rmt_block import (
    advext_block_plain,
    rmt_block_plain,
)
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.physics import momentum_core, velocity_rhs_blended

torch.set_num_threads(1)
F64 = torch.float64
N = 32
DISC = pt.Disc(0.6, 0.5, 0.2)


def fields(seed=0):
    """The flagship's solid block outputs from a random swirl: the
    operands of every entry point."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, rho_s=1.3)
    s = pt.make_init_state(cfg, (DISC,), dtype=F64, device="cpu")
    rng = np.random.default_rng(seed)
    X, Y = cfg.grid.coords(dtype=F64, device="cpu")
    a, b = rng.standard_normal(2)
    u = 0.3 * a * torch.sin(np.pi * X) * torch.sin(np.pi * Y)
    v = 0.3 * b * torch.sin(2 * np.pi * X) * torch.sin(np.pi * Y)
    p = torch.tensor(0.1 * rng.standard_normal((N, N)), dtype=F64)
    dt = torch.tensor(2e-3, dtype=F64)
    params = torch.tensor([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f],
                          dtype=F64)
    g = cfg.grid
    blk = rmt_block_plain(u, v, s.X1, s.X2, dt, phi_inits=(DISC,), dx=g.dx,
                          dy=g.dy, num_layers=3, w_t=cfg.w_t, params=params)
    f = torch.tensor(rng.standard_normal((2, N, N)), dtype=F64)
    return dict(u=u, v=v, p=p, dt=dt, params=params, X1=s.X1, X2=s.X2,
                blk=blk, fx=f[0], fy=f[1], dx=g.dx, dy=g.dy, w_t=cfg.w_t)


def calls():
    """{entry point: (plain, args, kwargs)} on the flagship's fields."""
    d = fields()
    X1e, X2e, phis, _, _, _, _, Hf, rho, sxx, sxy, syy = d["blk"]
    mkv = (phis[0] <= 0.0).to(F64) * (1.0 - Hf)
    dx, dy = d["dx"], d["dy"]
    lid = pt.make_lid_bc(1.0)
    mom = dict(eta_s=0.01, dx=dx, dy=dy, dt=d["dt"], mu_f=0.01)
    mom_args = (d["u"], d["v"], d["p"], sxx, sxy, syy, Hf, rho, mkv)
    u_per, v_per = pt.periodic_bc(d["u"], d["v"])
    d_scalar = d["dt"] / torch.mean(rho)
    return {
        "rmt_block": (rmt_block_plain, (d["u"], d["v"], d["X1"], d["X2"],
                                        d["dt"]),
                      dict(phi_inits=(DISC,), dx=dx, dy=dy, num_layers=3,
                           w_t=d["w_t"], params=d["params"])),
        "advext_block": (advext_block_plain, (d["u"], d["v"], d["X1"],
                                              d["X2"], phis, d["dt"]),
                         dict(dx=dx, dy=dy, num_layers=3)),
        "momentum_rk4": (momentum_core, (*mom_args, lid), mom),
        "momentum_rk4, force": (momentum_core, (*mom_args, lid),
                                dict(mom, f_ext_x=d["fx"], f_ext_y=d["fy"])),
        "momentum_rk4, periodic": (
            momentum_core, (u_per, v_per, *mom_args[2:], pt.periodic_bc),
            dict(mom, periodic=True)),
        "extrapolate_fused": (extrapolate_reference_map,
                              (X1e[0] * (phis[0] <= 0.0), X2e[0], phis[0],
                               dx, dy, 3), {}),
        "rc_rhs": (rc_rhs_plain, (d["u"], d["v"], d["p"], rho, d["dt"],
                                  d_scalar, dx, dy), {}),
        "grad_correct": (grad_correct_plain, (d["p"], d["u"], d["v"], rho,
                                              d["dt"], dx, dy, lid), {}),
        "velocity_rhs": (velocity_rhs_blended, (d["u"], d["v"], d["p"], sxx,
                                                sxy, syy, dx, dy, 0.01, Hf,
                                                rho, d["fx"], d["fy"]), {}),
    }


CALLS = calls()


def leaves(args, kwargs):
    """Fresh leaves for every float tensor argument (requires_grad)."""
    def copy(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.detach().clone().requires_grad_(True)
        return a
    return [copy(a) for a in args], {k: copy(a) for k, a in kwargs.items()}


def weighted_loss(out, seed=1):
    outs = (out,) if isinstance(out, torch.Tensor) else out
    rng = np.random.default_rng(seed)
    return sum(torch.sum(o * torch.tensor(rng.standard_normal(o.shape)))
               for o in outs)


def run(fn, args, kwargs):
    out = fn(*args, **kwargs)
    ts = [a for a in (*args, *kwargs.values())
          if isinstance(a, torch.Tensor) and a.requires_grad]
    grads = torch.autograd.grad(weighted_loss(out), ts, allow_unused=True)
    outs = (out,) if isinstance(out, torch.Tensor) else out
    return outs, grads


@pytest.mark.parametrize("name", list(CALLS))
def test_function_gradient_is_plain_autograd(name):
    plain, args, kwargs = CALLS[name]
    ref_out, ref_g = run(plain, *leaves(args, kwargs))
    n = [0]

    def kernel(*a, **kw):
        n[0] += 1
        return plain(*a, **kw)

    a, kw = leaves(args, kwargs)
    out, g = run(lambda *x, **y: _autograd.launch(kernel, plain, x, y), a, kw)
    assert n[0] == 1  # the forward; the backward runs the plain twin
    assert all(type(o.grad_fn).__name__.startswith("_KernelFunction")
               for o in out)
    for x, y in zip(out, ref_out):
        assert torch.equal(x, y)
    assert any(y is not None and bool(torch.any(y != 0)) for y in ref_g)
    for x, y in zip(g, ref_g):
        assert (x is None) == (y is None)
        if y is not None:
            assert torch.equal(x, y)


def test_no_function_without_a_gradient():
    """No input requiring a gradient, or autograd off: the kernel's own
    output, no Function around it."""
    plain, args, kwargs = CALLS["rc_rhs"]
    sentinel = torch.zeros(())
    assert _autograd.launch(lambda *a, **k: sentinel, plain, args,
                            kwargs) is sentinel
    a, kw = leaves(args, kwargs)
    with torch.no_grad():
        assert _autograd.launch(lambda *x, **y: sentinel, plain, a,
                                kw) is sentinel


def test_gradient_to_some_inputs_only():
    """Only the inputs that require a gradient get one; the twin's
    gradient of the others is not taken."""
    plain, args, kwargs = CALLS["grad_correct"]
    a = [x.detach().clone() if isinstance(x, torch.Tensor) else x
         for x in args]
    a[0].requires_grad_(True)  # p_corr alone
    out = _autograd.launch(plain, plain, a, kwargs)
    g = torch.autograd.grad(weighted_loss(out), a[0])[0]
    ref = torch.autograd.grad(weighted_loss(plain(*a, **kwargs)), a[0])[0]
    assert torch.equal(g, ref)


def test_cpu_wrappers_are_the_plain_versions():
    """A CPU tensor takes the plain version itself: the wrappers'
    gradients are plain autograd's with no Function between."""
    from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_fused
    _, args, kwargs = CALLS["momentum_rk4"]
    a, kw = leaves(args, kwargs)
    out = momentum_rk4_fused(*a, **kw)
    assert not type(out[0].grad_fn).__name__.startswith("_KernelFunction")
    _, ref_g = run(momentum_core, *leaves(args, kwargs))
    _, g = run(momentum_rk4_fused, a, kw)
    for x, y in zip(g, ref_g):
        assert (x is None and y is None) or torch.equal(x, y)


def test_rhs_kernel_in_the_stage_loop():
    """The opt-in stage loop with the one-RHS entry point through the
    Function at each of its four stages: momentum_core's gradient to
    roundoff (the Function sums each stage's contributions to an input
    before autograd adds them to the others', in another order)."""
    _, args, kwargs = CALLS["momentum_rk4, force"]
    rhs = functools.partial(_autograd.launch, velocity_rhs_blended,
                            velocity_rhs_blended)

    def rhs_fn(*x, **y):
        return rhs(x, y)

    _, ref_g = run(momentum_core, *leaves(args, kwargs))
    a, kw = leaves(args, kwargs)
    _, g = run(functools.partial(momentum_core, rhs_fn=rhs_fn), a, kw)
    for x, y in zip(g, ref_g):
        assert (x is None) == (y is None)
        if y is not None:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-13 * float(y.abs().max()))


@pytest.mark.parametrize("shape", [pt.Disc(0.5, 0.5, 0.2),
                                   pt.Ellipse(0.5, 0.5, 0.23, 0.174)],
                         ids=["disc", "ellipse"])
def test_level_set_gradient_is_finite_at_the_centre(shape):
    """A map point exactly at a shape's centre: the level set's norm takes
    the double-where, so its gradient is finite there, and its value is
    the unguarded one bit for bit."""
    X, Y = pt.Grid(33, 33, 1.0, 1.0).coords(dtype=F64, device="cpu")
    assert float(X[16, 16]) == 0.5 and float(Y[16, 16]) == 0.5
    ref = shape(X, Y)
    X1, X2 = X.clone().requires_grad_(True), Y.clone().requires_grad_(True)
    phi = shape(X1, X2)
    assert torch.equal(phi.detach(), ref)
    g1, g2 = torch.autograd.grad(phi.sum(), (X1, X2))
    assert bool(torch.isfinite(g1).all() and torch.isfinite(g2).all())
    assert float(g1[16, 16]) == 0.0 and float(g1[16, 20]) > 0.0


def test_gradient_with_respect_to_t_end():
    """t_end clips the last step: the loss's derivative with respect to a
    t_end tensor equals central differences (and is 0 when no step
    reaches it)."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, fixed_dt=2e-3)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), dtype=F64,
                        device="cpu")
    s0 = pt.make_init_state(cfg, (DISC,), dtype=F64, device="cpu")

    def loss(t_end):
        s = s0
        for _ in range(3):
            s, _ = step(s, t_end)
        return torch.sum(s.u ** 2 + s.v ** 2) + torch.sum(s.p ** 2)

    for t_end, clipped in ((5e-3, True), (1.0, False)):
        t = torch.tensor(t_end, dtype=F64, requires_grad=True)
        (g,) = torch.autograd.grad(loss(t), t)
        h = 1e-7
        with torch.no_grad():
            fd = (float(loss(torch.tensor(t_end + h, dtype=F64)))
                  - float(loss(torch.tensor(t_end - h, dtype=F64)))) / (2 * h)
        if clipped:
            assert float(g) != 0.0
            assert abs(float(g) - fd) <= 1e-5 * abs(fd), (float(g), fd)
        else:
            assert float(g) == 0.0 and fd == 0.0
