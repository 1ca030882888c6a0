"""The differentiable step with the kernels' forward (counterpart of
``pyrmt_tpu.diff``).

``make_step`` on a CUDA state is differentiable already: every kernel
wrapper is an ``autograd.Function`` whose backward is its plain version's
autograd (``kernels._autograd``). A backward pass through it keeps every
intermediate of the plain versions' graphs, or with ``sim.make_rollout``'s
checkpointing recomputes the kernels' forward as well. ``make_diff_step``
is the JAX package's cheaper form:

- forward: the configuration's own step, the kernels included, run with
  autograd off;
- saved: the step's inputs only (one state per step);
- backward: the autograd of the plain twin, the step built from the same
  configuration with every ``*_impl`` set to its plain version
  (``_PLAIN_IMPLS``, the counterpart of the JAX package's
  ``_XLA_OVERRIDES``), evaluated at those inputs.

The whole step goes through ``kernels._autograd.launch``, as one kernel
with its plain twin.

Kernel and plain twin agree bit for bit in the forward, so the gradient is
the exact gradient of the trajectory the kernels computed. The aux dict is
dropped, as in the JAX package; the state's step counter (int32) gets no
gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from pyrmt_tpu_torch.kernels._autograd import launch
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
from pyrmt_tpu_torch.sim import SimState, make_step

__all__ = ["make_diff_step", "make_diff_rollout"]

# The plain version of every kernel block of make_step: the backward twin.
_PLAIN_IMPLS = dict(
    rmt_block_impl=rmt_block_plain,
    momentum_rk4_impl=momentum_core,
    advext_impl=advext_block_plain,
    extrap_impl=extrapolate_reference_map,
    momentum_rhs_impl=velocity_rhs_blended,
    projection_stencils_impl=(rc_rhs_plain, grad_correct_plain),
)

_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def make_diff_step(
    cfg,
    velocity_bc: Callable,
    phi_inits: Sequence[Callable] = (),
    dtype=torch.float32,
    rmt_block_impl: Callable | None = None,
    momentum_rk4_impl: Callable | None = None,
    param_names: tuple[str, ...] | None = None,
    *,
    device="cuda",
):
    """Build ``dstep(state, t_end) -> SimState``: the kernels' forward, the
    plain twin's backward. With ``param_names`` (of
    ``sim._TRACEABLE_PARAMS``) it is ``dstep(state, t_end, params)``, as
    ``make_step(traced_params=param_names)``'s step, differentiable with
    respect to each entry of ``params``.

    ``rmt_block_impl`` and ``momentum_rk4_impl`` substitute the kernel
    blocks of the forward step (as in ``make_step``). ``variable_rho``
    works too: the CG differentiates through its implicit adjoint, one more
    CG solve per step of the backward.

    Single-device, as in the JAX package: it builds its own steps, with no
    mesh. A sharded step differentiates as it is
    (``parallel.make_sharded_step``, with ``sim.make_rollout``)."""
    fwd = make_step(cfg, velocity_bc, phi_inits, dtype=dtype, device=device,
                    rmt_block_impl=rmt_block_impl,
                    momentum_rk4_impl=momentum_rk4_impl,
                    traced_params=param_names)
    plain = dict(_PLAIN_IMPLS)
    if fwd.paths["solid"] != "fused":
        # a substitute solid block would send the twin to the fused tier
        # where the forward takes another
        del plain["rmt_block_impl"]
    twin = make_step(cfg, velocity_bc, phi_inits, dtype=dtype, device=device,
                     traced_params=param_names, **plain)
    names = tuple(param_names or ())

    def dstep(state: SimState, t_end, params=None):
        if (params is None) != (param_names is None):
            raise TypeError("dstep takes params exactly when it was built "
                            "with param_names")
        present = [k for k in _FIELDS if getattr(state, k) is not None]
        t_tensor = isinstance(t_end, torch.Tensor)
        params = dict(params or {})
        extra = set(params) - set(names)
        if extra:
            raise ValueError(f"params {sorted(extra)} are not among the "
                             f"step's param_names {names}")
        flat = [getattr(state, k) for k in present]
        flat += [t_end] if t_tensor else []
        flat += [torch.as_tensor(params[k], dtype=dtype, device=device)
                 for k in names]

        def run(step_fn):
            def state_tensors(*tensors):
                s = SimState(**dict(zip(present, tensors)))
                rest = list(tensors[len(present):])
                t = rest.pop(0) if t_tensor else t_end
                extra_args = (dict(zip(names, rest)),) if names else ()
                new = step_fn(s, t, *extra_args)[0]
                return tuple(getattr(new, k) for k in present)
            return state_tensors

        # the step as one "kernel": its forward without autograd, its
        # backward the plain twin's autograd at the saved inputs
        outs = launch(run(fwd), run(twin), flat, {})
        return SimState(**dict(zip(present, outs)))

    dstep.paths = fwd.paths
    return dstep


def make_diff_rollout(dstep, n_steps: int, with_params: bool = False):
    """``n_steps`` steps of a ``make_diff_step`` step: ``rollout(state,
    t_end)``, or with ``with_params`` (for a ``param_names`` step)
    ``rollout(state, t_end, params)``. Values are the kernels'
    trajectory; gradients the plain twin's along it, with one state per
    step kept for the backward. Single-device, as ``make_diff_step``."""

    if with_params:
        def rollout(state: SimState, t_end, params):
            for _ in range(n_steps):
                state = dstep(state, t_end, params)
            return state

        return rollout

    def rollout(state: SimState, t_end):
        for _ in range(n_steps):
            state = dstep(state, t_end)
        return state

    return rollout
