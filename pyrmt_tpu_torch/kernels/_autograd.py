"""The kernels' gradient: each CUDA entry point as a
``torch.autograd.Function`` whose backward is the autograd of its plain
PyTorch twin.

The JAX package has no backward kernel: no ``pallas_call`` defines a VJP,
and its gradient is the XLA twin's (``pyrmt_tpu/diff.py``). The port does the
same one kernel at a time. A kernel writes its outputs into fresh tensors
through ctypes, so without this wrapper they would carry no ``grad_fn`` and
a backward pass would silently cut every path through the kernel.

    out = launch(kernel, plain, args, kwargs)

- forward: ``kernel(*args, **kwargs)`` exactly as without gradients (the
  Function's forward runs with autograd off); it never catches an error and
  never calls the plain twin;
- saved: the tensor arguments only; the others (spacings, level-set
  functions, modes, the BC) are closed over;
- backward: the saved inputs detached, ``requires_grad`` set where the
  input needs a gradient, ``plain(*args, **kwargs)`` under autograd, and
  ``torch.autograd.grad`` of its outputs against the incoming gradients.

Kernel and twin agree bit for bit in the forward, so this is the exact
gradient of the trajectory the kernel computed. The Function is used only
when autograd is on and some tensor argument requires a gradient; otherwise
``launch`` calls the kernel directly, so a forward-only run gains no launch
and no host read. The kernel's launch counter counts its forward launches;
a backward pass runs the twin and launches nothing.
"""
from __future__ import annotations

import torch


def needs_grad(tensors) -> bool:
    """Autograd is on and some tensor of ``tensors`` requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _KernelFunction(torch.autograd.Function):
    """forward: the kernel; backward: the plain twin's autograd."""

    @staticmethod
    def forward(ctx, kernel, plain, call, *tensors):
        ctx.plain, ctx.call = plain, call
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return call(kernel, tensors)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n) for t, n in
                  zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.call(ctx.plain, inputs)
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in inputs if t.requires_grad]
        result = [None] * len(inputs)
        if pairs and wrt:
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
            result = [next(got) if t.requires_grad else None for t in inputs]
        return (None, None, None, *result)


def launch(kernel, plain, args, kwargs):
    """``kernel(*args, **kwargs)``, through ``_KernelFunction`` when a
    tensor argument (positional or keyword) requires a gradient and
    autograd is on. ``plain`` takes the same arguments and computes the
    same function; it is the backward."""
    slots = [(i, a) for i, a in enumerate(args)
             if isinstance(a, torch.Tensor)]
    slots += [(k, a) for k, a in kwargs.items()
              if isinstance(a, torch.Tensor)]
    tensors = [t for _, t in slots]
    if not needs_grad(tensors):
        return kernel(*args, **kwargs)
    keys = [k for k, _ in slots]

    def call(fn, ts):
        a, kw = list(args), dict(kwargs)
        for k, t in zip(keys, ts):
            if isinstance(k, int):
                a[k] = t
            else:
                kw[k] = t
        return fn(*a, **kw)

    return _KernelFunction.apply(kernel, plain, call, *tensors)
