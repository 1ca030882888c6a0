"""The whole narrow-band extrapolation of one reference map: the wrapper of
its CUDA kernel (counterpart of
``pyrmt_tpu.kernels.extrapolate_fused.extrapolate_reference_map_fused``).

The plain version is ``ops.extrapolate.extrapolate_reference_map``; the
kernel is ``csrc/extrapolate_fused.cu``, whose source note says what it
replaces and what bounds it. It runs on every step of the general tier,
once per solid, and at every map-rebase event; with the sharding offsets
on a rank's block of a domain decomposition
(``parallel.sharding.make_extrapolate_sharded``).
"""
from __future__ import annotations

import ctypes

import torch

from pyrmt_tpu_torch.kernels import _autograd, _build
from pyrmt_tpu_torch.ops.extrapolate import (
    _kernels_1d,
    extrapolate_reference_map,
)

# Times the wrapper launched the CUDA kernel (one per call on a CUDA
# tensor): on a whole field, and on a shard's slab (the offsets). A caller
# may reset them to 0.
launches = 0
offset_launches = 0


def window_taps(dx, dy):
    """The 6 x 9 separable factors of the 9x9 window (wx, wxd, wxd2, wy,
    wyd, wyd2) as a ctypes array of doubles, the ``taps`` operand of the
    extrapolation kernels."""
    fx, fy = _kernels_1d(dx, dy)
    return (ctypes.c_double * 54)(*[
        float(w) for k in (fx["wx"], fx["wxd"], fx["wxd2"],
                           fy["wy"], fy["wyd"], fy["wyd2"]) for w in k])


def _cuda_lib():
    lib = _build.load("extrapolate_fused")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pyrmt_extrapolate_fused_f32,
               lib.pyrmt_extrapolate_fused_f64):
        fn.argtypes = [P] * 6 + [I] * 7 + [P, I, P]
        fn.restype = I
    for fn in (lib.pyrmt_extrapolate_fused_scratch_f32,
               lib.pyrmt_extrapolate_fused_scratch_f64):
        fn.argtypes = [I] * 4
        fn.restype = ctypes.c_longlong
    return lib


def extrapolate_reference_map_fused(X1, X2, phi, dx, dy, max_layers,
                                    tile=None, interpret=False, *,
                                    row_offset=None, Ny_total=None,
                                    col_offset=None, Nx_total=None):
    """Extrapolate (X1, X2) from the solid (phi < 0) ``max_layers`` cells
    into the fluid; same arguments and result as
    ``extrapolate_reference_map``.

    A CPU tensor goes to the plain version. A CUDA tensor goes to the CUDA
    kernel (a flag pre-pass and a tile kernel on the current stream, which
    do not wait for the card); another dtype, shape or device raises.
    Where an input requires a gradient the backward is the plain version's
    autograd (``_autograd.launch``). ``row_offset``, ``Ny_total``,
    ``col_offset``, ``Nx_total`` make the inputs a shard's slab, as in
    ``kernels.rmt_block.rmt_block_fused``: the results at the domain's
    cells, 0 within 4 ``max_layers`` cells of a cut and outside the domain,
    as ``extrapolate_reference_map`` with the same offsets gives them.
    ``tile`` and ``interpret`` are the JAX kernel's TPU tiling and Pallas
    switch, accepted and ignored.
    """
    kw = dict(row_offset=row_offset, Ny_total=Ny_total,
              col_offset=col_offset, Nx_total=Nx_total)
    if X1.device.type == "cpu":
        return extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers,
                                         **kw)
    return _autograd.launch(_extrapolate_cuda, extrapolate_reference_map,
                            (X1, X2, phi, dx, dy, max_layers), kw)


def _extrapolate_cuda(X1, X2, phi, dx, dy, max_layers, *, row_offset,
                      Ny_total, col_offset, Nx_total):
    """One call of the kernel (two device kernels) on CUDA tensors."""
    global launches, offset_launches
    if X1.device.type != "cuda":
        raise ValueError(f"extrapolate_fused: no kernel for device {X1.device}")
    Ny, Nx = X1.shape
    _build.check_operands("extrapolate_fused", X1, {
        "X1": (X1, (Ny, Nx)), "X2": (X2, (Ny, Nx)), "phi": (phi, (Ny, Nx))})
    if max_layers < 0:
        raise ValueError(f"extrapolate_fused: max_layers={max_layers} < 0")
    offs, slab = _build.slab_operands(X1.shape, row_offset, Ny_total,
                                      col_offset, Nx_total)
    lib = _cuda_lib()
    x1e = _build.outputs((Ny, Nx), X1, slab)
    x2e = _build.outputs((Ny, Nx), X1, slab)
    f32 = X1.dtype == torch.float32
    sms = torch.cuda.get_device_properties(X1.device).multi_processor_count
    # the pre-pass's flags, and the panels' workspace where a panel does not
    # fit a block's shared memory (float32 from 12 layers, float64 from 9)
    nbytes = (lib.pyrmt_extrapolate_fused_scratch_f32 if f32 else
              lib.pyrmt_extrapolate_fused_scratch_f64)(
                  Ny, Nx, int(max_layers), sms)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=X1.device)
    fn = (lib.pyrmt_extrapolate_fused_f32 if f32
          else lib.pyrmt_extrapolate_fused_f64)
    _build.launch(lib, fn, "extrapolate_fused kernel launch", X1.device,
                  *(_build.pointer(t) for t in (X1, X2, phi, x1e, x2e,
                                                scratch)),
                  Ny, Nx, *offs, int(max_layers), window_taps(dx, dy), sms)
    if slab:
        offset_launches += 1
    else:
        launches += 1
    return x1e, x2e
