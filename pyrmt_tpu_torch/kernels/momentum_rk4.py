"""All four RK4 stages of the blended momentum update: the wrapper of the
CUDA kernel (counterpart of
``pyrmt_tpu.kernels.momentum_rk4.momentum_rk4_pallas``).

The plain version is ``pyrmt_tpu_torch.physics.momentum_core``; this
wrapper takes the same arguments. The kernel is ``csrc/momentum_rk4.cu``,
one launch of shared-memory tiles with an 8-cell halo; its source note
says what it replaces and what bounds it. The external force (contact,
gravity) is two optional (Ny, Nx) operands: with them the launch is the
kernel's force instantiation (the JAX kernel's ``has_ext=True``), without
them the one that has no force operands (``has_ext=False``). The
doubly-periodic BC (``bcs.periodic_bc``) has instantiations of its own:
wrapped reads, the interior stencils, the BC the identity.
"""
from __future__ import annotations

import ctypes

import torch

from pyrmt_tpu_torch.bcs import periodic_bc
from pyrmt_tpu_torch.kernels import _build
from pyrmt_tpu_torch.physics import momentum_core

# Times the wrapper launched the CUDA kernel (one per call on a CUDA
# tensor): its wall instantiations (lid, free slip, no-op; with or without
# the force) and its periodic ones. A caller may reset them to 0.
launches = 0
periodic_launches = 0


def momentum_rk4_supported(velocity_bc) -> bool:
    """The kernel applies ``velocity_bc`` from its ``kernel_spec`` ('lid',
    'free_slip', 'noop' or 'periodic'); the step takes the plain stage loop
    for a BC without one, as the JAX step takes XLA's."""
    spec = getattr(velocity_bc, "kernel_spec", None)
    return spec is not None and spec[0] in _build.BC_CODES


def _cuda_lib():
    lib = _build.load("momentum_rk4")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.pyrmt_momentum_rk4_f32, lib.pyrmt_momentum_rk4_f64):
        fn.argtypes = [P] * 14 + [I, I, D, D, D, D, I, D, P]
        fn.restype = I
    return lib


def momentum_rk4_fused(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                       rho_local, mkv, velocity_bc, *, eta_s, dx, dy, dt,
                       mu_f, f_ext_x=None, f_ext_y=None, periodic=False):
    """RK4 velocity update; same arguments and result as
    ``physics.momentum_core`` with ``dt`` a 0-d tensor.

    A CPU tensor goes to ``momentum_core``. A CUDA tensor goes to the CUDA
    kernel, which applies the BC from ``velocity_bc.kernel_spec`` ('lid',
    'free_slip', 'noop' or 'periodic'); anything else raises. ``mkv`` is
    read only when eta_s > 0; the force (``f_ext_x``, ``f_ext_y``) where it
    is given.

    ``periodic`` says the BC is ``periodic_bc`` (the step passes
    ``bc_type == 'periodic'``); the two must agree. On the periodic box
    ``periodic_bc`` is applied to (u, v) once before the update, as the
    JAX package does before its kernel; the result is ``momentum_core``'s
    on those (u, v). The kernel reads every row index j through
    j mod (Ny - 1), and every column index likewise: the overlap row
    Ny - 1 and column Nx - 1 are read as their copies, row and column 0.
    So the kernel equals ``momentum_core`` exactly where the other fields
    are overlap-consistent (row Ny - 1 equals row 0, column Nx - 1 equals
    column 0): p, the solid stresses, Hf, rho_local, mkv and the force. In
    the step they always are: p comes from the FFT solve's
    ``tile_overlap``, and a solid keeps ``periodic_seam_clearance_cells``
    from the seam, so the blends there are the fluid's constants.
    """
    global launches, periodic_launches
    spec = getattr(velocity_bc, "kernel_spec", None)
    if periodic != (spec is not None and spec[0] == "periodic"):
        raise ValueError(f"momentum_rk4: periodic={periodic} with the BC "
                         f"spec {spec!r}")
    if periodic:
        u, v = periodic_bc(u, v)
    if u.device.type == "cpu":
        return momentum_core(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el,
                             Hf, rho_local, mkv, velocity_bc, eta_s=eta_s,
                             dx=dx, dy=dy, dt=dt, mu_f=mu_f, f_ext_x=f_ext_x,
                             f_ext_y=f_ext_y, periodic=periodic)
    if u.device.type != "cuda":
        raise ValueError(f"momentum_rk4: no kernel for device {u.device}")
    bc, lid = _build.bc_operands("momentum_rk4", velocity_bc)
    Ny, Nx = u.shape
    if Ny < 5 or Nx < 5:
        raise ValueError(f"momentum_rk4 kernel needs a grid of at least 5x5, "
                         f"not {Ny}x{Nx}")
    if (f_ext_x is None) != (f_ext_y is None):
        raise ValueError("momentum_rk4: give both force fields or neither")
    fields = {"u": u, "v": v, "p": p, "sig_sxx_el": sig_sxx_el,
              "sig_sxy_el": sig_sxy_el, "sig_syy_el": sig_syy_el, "Hf": Hf,
              "rho_local": rho_local, "mkv": mkv}
    forces = ({} if f_ext_x is None else
              {"f_ext_x": f_ext_x, "f_ext_y": f_ext_y})
    _build.check_operands("momentum_rk4", u, {
        name: (t, () if name == "dt" else (Ny, Nx))
        for name, t in {**fields, **forces, "dt": dt}.items()})
    lib = _cuda_lib()
    u_new = torch.empty_like(u)
    v_new = torch.empty_like(u)
    fn = (lib.pyrmt_momentum_rk4_f32 if u.dtype == torch.float32
          else lib.pyrmt_momentum_rk4_f64)
    force_ptrs = ((None, None) if f_ext_x is None else
                  (_build.pointer(f_ext_x), _build.pointer(f_ext_y)))
    err = fn(*(_build.pointer(t) for t in fields.values()), *force_ptrs,
             *(_build.pointer(t) for t in (dt, u_new, v_new)),
             Ny, Nx, float(dx), float(dy), float(mu_f), float(eta_s), bc, lid,
             _build.stream_handle(u.device))
    _build.check(lib, err, "momentum_rk4 kernel launch")
    if periodic:
        periodic_launches += 1
    else:
        launches += 1
    return u_new, v_new
