"""Differentiable FSI: recover a solid's shear modulus from an observed flow
(the twin of ``examples/differentiable_fsi.py``).

A soft disc (R = 0.2 at the centre) sits in a decaying Taylor-Green vortex
between free-slip walls (mu_f = 0.02, a fixed dt of 1.5e-3, under the
P-wave limit for any mu_s the run visits). A run at mu_s* gives the
observed final velocity; from a guess 3x off, Adam steps (lr 0.15, optax's
defaults) on theta, mu_s = softplus(theta), walk into the basin, then
secant iteration on dL/dtheta polishes the root (the misfit has an exact
zero-residual root: the observation came from the same model).
``make_diff_step(param_names=('mu_s',))`` builds one step for every
iterate: on the card its forward runs the kernels, mu_s their device
operand, and its backward the plain twin's autograd.

    python -m pyrmt_tpu_torch.examples.differentiable_fsi [--cpu]
"""
from __future__ import annotations

import math
import sys
import time

import torch

from pyrmt_tpu_torch import (
    Disc,
    Grid,
    RMTConfig,
    free_slip_box_bc,
    make_diff_rollout,
    make_diff_step,
    make_init_state,
)


def recover_mu_s(N=48, n_steps=60, mu_true=0.4, mu_guess=1.2, adam_steps=10,
                 secant_steps=8, dtype=torch.float64, device="cuda",
                 verbose=True):
    """The inverse problem: ``adam_steps`` Adam steps, then at most
    ``secant_steps`` secant steps, each one gradient evaluation of the
    misfit of a rollout of ``n_steps`` steps. Returns {'mu_s': the
    recovered modulus, 'rel_err', 'trace': [(mu_s, loss)] of every
    evaluation, 'wall_s'}."""
    cfg = RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=mu_true, mu_f=0.02,
                    rho_s=1.0, rho_f=1.0, fixed_dt=1.5e-3)
    disc = Disc(0.5, 0.5, 0.2)
    kw = dict(dtype=dtype, device=device)
    X, Y = cfg.grid.coords(**kw)
    u0 = 0.5 * torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y)
    v0 = -0.5 * torch.cos(2 * math.pi * X) * torch.sin(2 * math.pi * Y)
    state0 = make_init_state(cfg, (disc,), u0=u0, v0=v0, **kw)
    t_end = 1.0  # past n_steps fixed steps: dt is fixed_dt throughout
    dstep = make_diff_step(cfg, free_slip_box_bc, (disc,), **kw,
                           param_names=("mu_s",))
    roll = make_diff_rollout(dstep, n_steps, with_params=True)
    area = cfg.grid.dx * cfg.grid.dy
    with torch.no_grad():
        obs = roll(state0, t_end, {"mu_s": torch.tensor(mu_true, **kw)})

    def value_and_grad(theta):
        th = torch.tensor(theta, **kw, requires_grad=True)
        mu = torch.nn.functional.softplus(th)
        s = roll(state0, t_end, {"mu_s": mu})
        L = torch.sum((s.u - obs.u) ** 2 + (s.v - obs.v) ** 2) * area
        (g,) = torch.autograd.grad(L, th)
        return float(L.detach()), float(mu.detach()), float(g)

    t0 = time.perf_counter()
    theta = math.log(math.expm1(mu_guess))
    m = v = 0.0
    b1, b2, lr, eps = 0.9, 0.999, 0.15, 1e-8
    trace = []
    for it in range(1, adam_steps + 1):
        L, mu, g = value_and_grad(theta)
        trace.append((mu, L))
        if verbose:
            print(f"{len(trace) - 1:>4}    adam {mu:>10.5f} {L:>12.3e}")
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        theta -= lr * (m / (1 - b1 ** it)) / (math.sqrt(v / (1 - b2 ** it))
                                              + eps)
    g_prev = theta_prev = None
    for _ in range(secant_steps):  # secant iteration on dL/dtheta
        L, mu, g = value_and_grad(theta)
        trace.append((mu, L))
        if verbose:
            print(f"{len(trace) - 1:>4}  secant {mu:>10.5f} {L:>12.3e}")
        if g_prev is not None and g != g_prev:
            step = -g * (theta - theta_prev) / (g - g_prev)
        else:
            step = -0.05 * math.copysign(1.0, g)  # the second point
        step = max(-0.5, min(0.5, step))
        theta_prev, g_prev = theta, g
        theta += step
        if abs(step) < 1e-10:
            break
    mu_final = float(torch.nn.functional.softplus(
        torch.tensor(theta, dtype=torch.float64)))
    err = abs(mu_final - mu_true) / mu_true
    if verbose:
        print(f"recovered mu_s = {mu_final:.5f} (true {mu_true}; relative "
              f"error {100 * err:.2f}%)")
    return dict(mu_s=mu_final, rel_err=err, trace=trace,
                wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    recover_mu_s(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
