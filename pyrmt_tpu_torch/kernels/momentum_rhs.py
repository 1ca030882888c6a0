"""One blended momentum RHS: the wrapper of its CUDA kernel (counterpart of
``pyrmt_tpu.kernels.momentum_rhs.velocity_rhs_blended_pallas``).

The plain version is ``pyrmt_tpu_torch.physics.velocity_rhs_blended``; this
wrapper takes the same arguments, with the external force as two (Ny, Nx)
fields, as the TPU kernel does. The kernel is ``csrc/momentum_rhs.cu``,
whose source note says what it replaces and what bounds it. The step runs
it at each RK4 stage of ``momentum_method='xla'`` with
``use_pallas_rhs=True``.
"""
from __future__ import annotations

import ctypes

import torch

from pyrmt_tpu_torch.kernels import _autograd, _build
from pyrmt_tpu_torch.physics import velocity_rhs_blended

# Times the wrapper launched the CUDA kernel (one per call on a CUDA
# tensor). A caller may reset it to 0.
launches = 0


def _cuda_lib():
    lib = _build.load("momentum_rhs")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.pyrmt_momentum_rhs_f32, lib.pyrmt_momentum_rhs_f64):
        fn.argtypes = [P] * 12 + [I, I, D, D, D, P]
        fn.restype = I
    return lib


def velocity_rhs_blended_fused(u, v, p, sig_sxx, sig_sxy, sig_syy, dx, dy,
                               mu_f, Hf, rho_local, f_ext_x, f_ext_y):
    """(rhs_u, rhs_v); same arguments and result as
    ``physics.velocity_rhs_blended`` with every field (Ny, Nx).

    A CPU tensor goes to the plain version. A CUDA tensor goes to the CUDA
    kernel; a grid under 5x5, another dtype, shape or device raises.
    Where an input requires a gradient the backward is the plain version's
    autograd (``_autograd.launch``).
    """
    args = (u, v, p, sig_sxx, sig_sxy, sig_syy, dx, dy, mu_f, Hf, rho_local,
            f_ext_x, f_ext_y)
    if u.device.type == "cpu":
        return velocity_rhs_blended(*args)
    return _autograd.launch(_velocity_rhs_cuda, velocity_rhs_blended, args,
                            {})


def _velocity_rhs_cuda(u, v, p, sig_sxx, sig_sxy, sig_syy, dx, dy, mu_f, Hf,
                       rho_local, f_ext_x, f_ext_y):
    """One launch of the RHS kernel on CUDA tensors."""
    global launches
    if u.device.type != "cuda":
        raise ValueError(f"velocity_rhs: no kernel for device {u.device}")
    Ny, Nx = u.shape
    if Ny < 5 or Nx < 5:
        raise ValueError(f"velocity_rhs kernel needs a grid of at least 5x5, "
                         f"not {Ny}x{Nx}")
    fields = {"u": u, "v": v, "p": p, "sig_sxx": sig_sxx, "sig_sxy": sig_sxy,
              "sig_syy": sig_syy, "Hf": Hf, "rho_local": rho_local,
              "f_ext_x": f_ext_x, "f_ext_y": f_ext_y}
    _build.check_operands("velocity_rhs", u, {
        name: (t, (Ny, Nx)) for name, t in fields.items()})
    lib = _cuda_lib()
    rhs_u = torch.empty_like(u)
    rhs_v = torch.empty_like(u)
    fn = (lib.pyrmt_momentum_rhs_f32 if u.dtype == torch.float32
          else lib.pyrmt_momentum_rhs_f64)
    _build.launch(lib, fn, "velocity_rhs kernel launch", u.device,
                  *(_build.pointer(t) for t in (*fields.values(), rhs_u,
                                                rhs_v)),
                  Ny, Nx, float(dx), float(dy), float(mu_f))
    launches += 1
    return rhs_u, rhs_v
