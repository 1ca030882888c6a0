"""The projection's two stencil passes around the DCT solve: the wrappers of
their CUDA kernels and their plain versions (counterparts of
``pyrmt_tpu.kernels.projection_stencils.rc_rhs_pallas`` and
``grad_correct_pallas``).

    rhs_2d = rc_rhs(a*, b*, p_prev, rho, dt, d_scalar, dx, dy)
    (a, b) = grad_correct(p_corr, a*, b*, rho, dt, dx, dy, velocity_bc)

The plain versions compose ``ops.poisson``'s Rhie-Chow divergence and
pressure gradient with the BC, the expressions the TPU kernels match; the
kernels are ``csrc/projection_stencils.cu``, whose source note says what
they replace and what bounds them. ``ops.projection.pressure_projection``
runs either pair.
"""
from __future__ import annotations

import ctypes

import torch

from pyrmt_tpu_torch.kernels import _autograd, _build
from pyrmt_tpu_torch.ops.poisson import (
    compute_divergence_rc,
    compute_pressure_gradient,
)

# Times each wrapper launched its CUDA kernel (one per call on a CUDA
# tensor). A caller may reset them to 0.
rc_rhs_launches = 0
grad_correct_launches = 0


def projection_stencils_supported(velocity_bc) -> bool:
    """The grad_correct kernel applies ``velocity_bc`` from its
    ``kernel_spec``: 'lid', 'free_slip' or 'noop'."""
    spec = getattr(velocity_bc, "kernel_spec", None)
    return spec is not None and spec[0] in _build.WALL_BCS


def rc_rhs_plain(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy):
    """rho * div / dt of the Rhie-Chow face velocities with face
    coefficient ``d_scalar`` (dt / mean(rho)); 0 on the boundary ring."""
    return rho * compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx,
                                       dy, d_scalar=d_scalar) / dt


def grad_correct_plain(p_corr, a_star, b_star, rho, dt, dx, dy, velocity_bc):
    """(a*, b*) - (dt / rho) grad p_corr, then the velocity BC."""
    dpdx, dpdy = compute_pressure_gradient(p_corr, dx, dy)
    a = a_star - (dt / rho) * dpdx
    b = b_star - (dt / rho) * dpdy
    return velocity_bc(a, b)


def _cuda_lib():
    lib = _build.load("projection_stencils")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.pyrmt_rc_rhs_f32, lib.pyrmt_rc_rhs_f64):
        fn.argtypes = [P] * 7 + [I, I, D, D, P]
        fn.restype = I
    for fn in (lib.pyrmt_grad_correct_f32, lib.pyrmt_grad_correct_f64):
        fn.argtypes = [P] * 7 + [I, I, D, D, I, D, P]
        fn.restype = I
    return lib


def _check(what, ref, fields):
    """The shared operand checks: a grid of at least 3x3 (the one-sided
    gradients), (Ny, Nx) fields and 0-d dt / d_scalar."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {ref.device}")
    Ny, Nx = ref.shape
    if Ny < 3 or Nx < 3:
        raise ValueError(f"{what} kernel needs a grid of at least 3x3, not "
                         f"{Ny}x{Nx}")
    _build.check_operands(what, ref, {
        name: (t, () if name in ("dt", "d_scalar") else (Ny, Nx))
        for name, t in fields.items()})
    return Ny, Nx


def rc_rhs_fused(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy):
    """``rc_rhs_plain`` with ``rho`` an (Ny, Nx) field and ``dt``,
    ``d_scalar`` 0-d tensors. A CPU tensor goes to the plain version, a
    CUDA tensor to the CUDA kernel; another dtype, shape or device raises.
    Where an input requires a gradient the backward is the plain version's
    autograd (``_autograd.launch``).
    """
    args = (a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy)
    if a_star.device.type == "cpu":
        return rc_rhs_plain(*args)
    return _autograd.launch(_rc_rhs_cuda, rc_rhs_plain, args, {})


def _rc_rhs_cuda(a_star, b_star, p_prev, rho, dt, d_scalar, dx, dy):
    """One launch of the rc_rhs kernel on CUDA tensors."""
    global rc_rhs_launches
    fields = {"a_star": a_star, "b_star": b_star, "p_prev": p_prev,
              "rho": rho, "dt": dt, "d_scalar": d_scalar}
    Ny, Nx = _check("rc_rhs", a_star, fields)
    lib = _cuda_lib()
    out = torch.empty_like(a_star)
    fn = (lib.pyrmt_rc_rhs_f32 if a_star.dtype == torch.float32
          else lib.pyrmt_rc_rhs_f64)
    _build.launch(lib, fn, "rc_rhs kernel launch", a_star.device,
                  *(_build.pointer(t) for t in (*fields.values(), out)), Ny,
                  Nx, float(dx), float(dy))
    rc_rhs_launches += 1
    return out


def grad_correct_fused(p_corr, a_star, b_star, rho, dt, dx, dy, velocity_bc):
    """``grad_correct_plain`` with ``rho`` an (Ny, Nx) field and ``dt`` a
    0-d tensor. A CPU tensor goes to the plain version. A CUDA tensor goes
    to the CUDA kernel, which applies the BC from
    ``velocity_bc.kernel_spec`` ('lid', 'free_slip' or 'noop'); another BC,
    dtype, shape or device raises. Where an input requires a gradient the
    backward is the plain version's autograd (``_autograd.launch``)."""
    args = (p_corr, a_star, b_star, rho, dt, dx, dy, velocity_bc)
    if a_star.device.type == "cpu":
        return grad_correct_plain(*args)
    return _autograd.launch(_grad_correct_cuda, grad_correct_plain, args, {})


def _grad_correct_cuda(p_corr, a_star, b_star, rho, dt, dx, dy, velocity_bc):
    """One launch of the grad_correct kernel on CUDA tensors."""
    global grad_correct_launches
    bc, lid = _build.bc_operands("grad_correct", velocity_bc,
                                 _build.WALL_BCS)
    fields = {"p_corr": p_corr, "a_star": a_star, "b_star": b_star,
              "rho": rho, "dt": dt}
    Ny, Nx = _check("grad_correct", a_star, fields)
    lib = _cuda_lib()
    a = torch.empty_like(a_star)
    b = torch.empty_like(a_star)
    fn = (lib.pyrmt_grad_correct_f32 if a_star.dtype == torch.float32
          else lib.pyrmt_grad_correct_f64)
    _build.launch(lib, fn, "grad_correct kernel launch", a_star.device,
                  *(_build.pointer(t) for t in (*fields.values(), a, b)), Ny,
                  Nx, float(dx), float(dy), bc, lid)
    grad_correct_launches += 1
    return a, b
