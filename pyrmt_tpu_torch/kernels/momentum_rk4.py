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

from pyrmt_tpu_torch.bcs import bc_of_spec, periodic_bc
from pyrmt_tpu_torch.kernels import _autograd, _build
from pyrmt_tpu_torch.ops.slab import has_offsets
from pyrmt_tpu_torch.physics import RK4_HALO, momentum_core

# Times the wrapper launched the CUDA kernel (one per call on a CUDA
# tensor): its wall instantiations (lid, free slip, no-op; with or without
# the force) on a whole field and on a shard's slab (the offsets), and its
# periodic ones. A caller may reset them to 0.
launches = 0
offset_launches = 0
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
        fn.argtypes = [P] * 14 + [I] * 6 + [D, D, D, D, I, D, P]
        fn.restype = I
    return lib


def momentum_rk4_fused(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                       rho_local, mkv, velocity_bc, *, eta_s, dx, dy, dt,
                       mu_f, f_ext_x=None, f_ext_y=None, periodic=False,
                       row_offset=None, Ny_total=None, col_offset=None,
                       Nx_total=None):
    """RK4 velocity update; same arguments and result as
    ``physics.momentum_core`` with ``dt`` a 0-d tensor.

    ``row_offset``, ``Ny_total``, ``col_offset`` and ``Nx_total`` (the JAX
    kernel's operands) make the fields one shard's slab, as in
    ``kernels.rmt_block.rmt_block_fused``: the BC and every closure act at
    the global domain's edge; the slab's cells outside the domain and the
    ``RK4_HALO`` (8) cells next to a cut come out 0. The periodic box
    takes no offsets (ValueError), as in the JAX package.

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

    Where an input requires a gradient the launch goes through
    ``_autograd.launch``, with ``momentum_core`` as the backward.
    """
    spec = getattr(velocity_bc, "kernel_spec", None)
    if periodic != (spec is not None and spec[0] == "periodic"):
        raise ValueError(f"momentum_rk4: periodic={periodic} with the BC "
                         f"spec {spec!r}")
    offsets = dict(row_offset=row_offset, Ny_total=Ny_total,
                   col_offset=col_offset, Nx_total=Nx_total)
    if periodic and has_offsets(**offsets):
        raise ValueError("momentum_rk4: the periodic box takes no sharding "
                         "offsets (its wrap is the whole field's)")
    if periodic:
        u, v = periodic_bc(u, v)
    args = (u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf, rho_local, mkv,
            velocity_bc)
    kw = dict(eta_s=eta_s, dx=dx, dy=dy, dt=dt, mu_f=mu_f, f_ext_x=f_ext_x,
              f_ext_y=f_ext_y, periodic=periodic, **offsets)
    if u.device.type == "cpu":
        return momentum_core(*args, **kw)
    return _autograd.launch(_momentum_rk4_cuda, momentum_core, args, kw)


def momentum_rk4_pallas(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                        rho_local, f_ext_x, f_ext_y, mkv, dt, dx, dy, mu_f,
                        eta_s, bc_spec, tile=None, interpret=False,
                        row_offset=None, Ny_total=None, col_offset=None,
                        Nx_total=None, has_ext=True, slab_halo=False):
    """``momentum_rk4_fused`` under the JAX kernel's name and parameters,
    in its order: the BC given as its ``kernel_spec`` (``bc_spec``), the
    force fields before ``mkv``, ``dt`` a number or a 0-d tensor.
    ``has_ext=False`` drops the force fields, as the JAX kernel does (the
    caller guarantees they are zero); ``tile``, ``interpret`` and
    ``slab_halo`` are the TPU's tiling, accepted and ignored. Returns
    (u_new, v_new)."""
    if not has_ext:
        f_ext_x = f_ext_y = None
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    return momentum_rk4_fused(
        u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf, rho_local, mkv,
        bc_of_spec(bc_spec), eta_s=eta_s, dx=dx, dy=dy, dt=dt, mu_f=mu_f,
        f_ext_x=f_ext_x, f_ext_y=f_ext_y,
        periodic=bc_spec[0] == "periodic", row_offset=row_offset,
        Ny_total=Ny_total, col_offset=col_offset, Nx_total=Nx_total)


def _momentum_rk4_cuda(u, v, p, sig_sxx_el, sig_sxy_el, sig_syy_el, Hf,
                       rho_local, mkv, velocity_bc, *, eta_s, dx, dy, dt,
                       mu_f, f_ext_x, f_ext_y, periodic, row_offset, Ny_total,
                       col_offset, Nx_total):
    """One launch of the RK4 kernel on CUDA tensors, (u, v) already under
    the periodic BC where ``periodic``."""
    global launches, offset_launches, periodic_launches
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
    offs, slab = _build.slab_operands(u.shape, row_offset, Ny_total,
                                      col_offset, Nx_total)
    lib = _cuda_lib()
    u_new = _build.outputs(u.shape, u, slab)
    v_new = _build.outputs(u.shape, u, slab)
    fn = (lib.pyrmt_momentum_rk4_f32 if u.dtype == torch.float32
          else lib.pyrmt_momentum_rk4_f64)
    force_ptrs = ((None, None) if f_ext_x is None else
                  (_build.pointer(f_ext_x), _build.pointer(f_ext_y)))
    _build.launch(lib, fn, "momentum_rk4 kernel launch", u.device,
                  *(_build.pointer(t) for t in fields.values()), *force_ptrs,
                  *(_build.pointer(t) for t in (dt, u_new, v_new)),
                  Ny, Nx, *offs, float(dx), float(dy), float(mu_f),
                  float(eta_s), bc, lid)
    if periodic:
        periodic_launches += 1
    elif slab:
        offset_launches += 1
    else:
        launches += 1
    return u_new, v_new
