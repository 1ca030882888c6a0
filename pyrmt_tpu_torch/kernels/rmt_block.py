"""The RMT solid block of one step: the plain PyTorch versions and the
wrappers of their CUDA kernels (counterparts of
``pyrmt_tpu.kernels.rmt_block.rmt_block_fused`` and
``advext_block_fused``).

The fused tier (``rmt_block_fused``), per solid i of S:

    phi   = phi_init(X1, X2)                  (compatibility rebuild)
    X1a, X2a = advect(X1, X2; u, v, dt) * (phi <= 0)
    X1e, X2e = extrapolate(X1a, X2a, phi)     (num_layers sweeps)
    phi2  = phi_init(X1e, X2e)
    sigma, J = solid_cauchy_stress(X1e, X2e, phi2)   (interior mode, or
               with stress_w_cut > 0 the band mode; with stress_clamp > 0
               det G clamped to [1/clamp, clamp]: the band mode's clamp or
               the step's two-solid collision clamp)
    H     = smoothed_heaviside(phi2, w_t)

followed by the mixture sums Hf = sum_i H_i - (S - 1), rho and
sum_i (1 - H_i) sigma_i. The advection's final sample is bilinear, or with
``sl_interp='bicubic'`` bicubic: with ``sl_guard`` (physical units) only
where the target cell's pre-advection phi < -sl_guard, bilinear elsewhere
(the band guard); with ``sl_guard=None`` everywhere (raw bicubic). The
split tier's kernel A (``advext_block_fused``) runs only the advection and
the extrapolation, with the pre-advection phi given: the step rebuilds,
reinitialises and area-fixes phi around it. Both kernels are entry points
of ``csrc/rmt_block.cu``; its source note says what they replace and what
bounds them.
"""
from __future__ import annotations

import ctypes

import torch

from pyrmt_tpu_torch.kernels import _autograd, _build
from pyrmt_tpu_torch.kernels.extrapolate_fused import window_taps
from pyrmt_tpu_torch.ops.advect import advect_semilagrangian_rk4_local
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.ops.levelset import rebuild_phi_from_reference_map
from pyrmt_tpu_torch.ops.slab import has_offsets, on_slab
from pyrmt_tpu_torch.ops.stress import smoothed_heaviside, solid_cauchy_stress

# Times each wrapper launched its CUDA kernel (one per call on a CUDA
# tensor): rmt_block_fused and advext_block_fused on a whole field, and
# each on a shard's slab (the offsets). Of those, the launches with
# tile_skip=False (on a field or a slab) count again in the no-skip
# counters. A caller may reset them to 0.
launches = 0
advext_launches = 0
offset_launches = 0
advext_offset_launches = 0
no_skip_launches = 0
advext_no_skip_launches = 0

# The most solids the fused tier's kernel takes: their level sets are kernel
# arguments (kMaxSolids in csrc/rmt_block.cu).
MAX_SOLIDS = 16
# The level sets the fused tier's kernel evaluates: the first element of a
# shape's kernel_spec, its index the kind code of csrc/common.cuh's Shape
# (ops.levelset.Disc and Ellipse).
SHAPES = ("disc", "ellipse")
# The advection's final samples: a template parameter of both tile kernels.
SL_INTERPS = ("bilinear", "bicubic")


def _check_interp(sl_interp):
    if sl_interp not in SL_INTERPS:
        raise ValueError(f"unknown sl_interp {sl_interp!r}: expected one of "
                         f"{SL_INTERPS}")


def cut_depth(num_layers, sl_interp="bilinear"):
    """Cells from a slab's cut whose results both blocks leave at 0 (the
    kernels do not compute them: they depend on cells beyond the cut): the
    advection's reach (1 cell, bicubic 2), the 4-cell reach of each
    extrapolation sweep and the post stage's 1. The sharded step's halo,
    4 num_layers + 4, covers it."""
    return 4 * num_layers + 1 + (2 if sl_interp == "bicubic" else 1)


def advext_block_plain(u, v, X1s, X2s, phis, dt, *, dx, dy, num_layers,
                       sl_interp="bilinear", sl_guard=None, row_offset=None,
                       Ny_total=None, col_offset=None, Nx_total=None,
                       origin=None, tile_skip=True):
    """The split tier's advect and extrapolate block: the shared SL-RK4
    backtrace of the (S, Ny, Nx) map stacks, sampled by ``sl_interp`` under
    the band guard ``sl_guard`` (bicubic where phis < -sl_guard), times the
    mask (phis <= 0), then ``num_layers`` extrapolation sweeps from the
    known cells (phis < 0). Returns the stacks (X1e, X2e).

    ``row_offset``, ``Ny_total``, ``col_offset``, ``Nx_total`` (the JAX
    kernel's operands) make the inputs one shard's slab
    (``ops.slab.on_slab``): the results at the domain's cells, 0 within
    ``cut_depth`` of a cut and outside the domain, as the kernel leaves
    them. ``origin`` is ``on_slab``'s: the global cell of the arrays'
    (0, 0), for the samples' rounding. ``tile_skip`` is the kernel's and
    is ignored: this version never skips."""
    _check_interp(sl_interp)
    if has_offsets(row_offset, Ny_total, col_offset, Nx_total):
        return on_slab(
            advext_block_plain, (u, v, X1s, X2s, phis, dt),
            dict(dx=dx, dy=dy, num_layers=num_layers, sl_interp=sl_interp,
                 sl_guard=sl_guard),
            row_offset=row_offset, Ny_total=Ny_total, col_offset=col_offset,
            Nx_total=Nx_total, stale=cut_depth(num_layers, sl_interp),
            origin=True)
    S = X1s.shape[0]
    masks = (phis <= 0.0).to(u.dtype)
    cubic_mask = None
    if sl_interp == "bicubic" and sl_guard is not None:
        guard = phis < -sl_guard  # at each target cell, for both components
        cubic_mask = torch.cat([guard, guard])
    qs = advect_semilagrangian_rk4_local(
        torch.cat([X1s, X2s]), u, v, dt, dx, dy, interp=sl_interp,
        cubic_mask=cubic_mask, origin=origin)
    X1a, X2a = qs[:S] * masks, qs[S:] * masks
    ext = [extrapolate_reference_map(X1a[i], X2a[i], phis[i], dx, dy,
                                     num_layers) for i in range(S)]
    return (torch.stack([e[0] for e in ext]),
            torch.stack([e[1] for e in ext]))


def rmt_block_plain(u, v, X1s, X2s, dt, *, phi_inits, dx, dy, num_layers,
                    w_t, params, stress_w_cut=0.0, stress_clamp=0.0,
                    sl_interp="bilinear", sl_guard=None, row_offset=None,
                    Ny_total=None, col_offset=None, Nx_total=None,
                    origin=None, tile_skip=True):
    """The composed ops. ``X1s``/``X2s`` are (S, Ny, Nx) stacks, ``dt`` a
    0-d tensor and ``params`` the tensor [mu_s, kappa, rho_s, rho_f];
    ``stress_w_cut`` and ``stress_clamp`` select the stress's variant, as
    ``ops.stress.solid_cauchy_stress``'s ``w_cut`` and ``detg_clamp`` do;
    ``sl_interp`` and ``sl_guard`` the advection's final sample, as in
    ``advext_block_plain``.

    Returns (X1e, X2e, phis, sxx_s, sxy_s, syy_s, J_s, Hf, rho_local,
    sig_sxx_el, sig_sxy_el, sig_syy_el): seven (S, Ny, Nx) stacks and five
    (Ny, Nx) fields.

    The offsets make the inputs a shard's slab, and ``tile_skip`` is
    ignored, as in ``advext_block_plain``.
    """
    if has_offsets(row_offset, Ny_total, col_offset, Nx_total):
        return on_slab(
            rmt_block_plain, (u, v, X1s, X2s, dt),
            dict(phi_inits=phi_inits, dx=dx, dy=dy, num_layers=num_layers,
                 w_t=w_t, params=params, stress_w_cut=stress_w_cut,
                 stress_clamp=stress_clamp, sl_interp=sl_interp,
                 sl_guard=sl_guard),
            row_offset=row_offset, Ny_total=Ny_total, col_offset=col_offset,
            Nx_total=Nx_total, stale=cut_depth(num_layers, sl_interp),
            origin=True)
    mu_s, kappa, rho_s, rho_f = params.unbind()
    S = X1s.shape[0]
    phis = torch.stack([rebuild_phi_from_reference_map(X1s[i], X2s[i], f)
                        for i, f in enumerate(phi_inits)])
    X1e, X2e = advext_block_plain(u, v, X1s, X2s, phis, dt, dx=dx, dy=dy,
                                  num_layers=num_layers, sl_interp=sl_interp,
                                  sl_guard=sl_guard, origin=origin)
    phis = torch.stack([rebuild_phi_from_reference_map(X1e[i], X2e[i], f)
                        for i, f in enumerate(phi_inits)])
    stress = [solid_cauchy_stress(X1e[i], X2e[i], dx, dy, mu_s, kappa,
                                  phis[i], w_cut=stress_w_cut,
                                  detg_clamp=stress_clamp)
              for i in range(S)]
    sxx, sxy, syy, J = (torch.stack(c) for c in zip(*stress))
    H = smoothed_heaviside(phis, w_t)
    one_mH = 1.0 - H
    Hf = torch.sum(H, dim=0) - (S - 1.0)
    rho_local = Hf * rho_f + torch.sum(one_mH, dim=0) * rho_s
    return (X1e, X2e, phis, sxx, sxy, syy, J, Hf, rho_local,
            torch.sum(one_mH * sxx, dim=0), torch.sum(one_mH * sxy, dim=0),
            torch.sum(one_mH * syy, dim=0))


def rmt_block_supported(phi_inits) -> bool:
    """The fused tier's kernel evaluates every level set: 1 to
    ``MAX_SOLIDS`` solids, each with a ``kernel_spec`` of a kind in
    ``SHAPES``. The step sends the other configurations to the split tier,
    which takes phi as a field."""
    return 1 <= len(phi_inits) <= MAX_SOLIDS and all(
        (getattr(f, "kernel_spec", None) or ("",))[0] in SHAPES
        for f in phi_inits)


def _check_cuda_operands(u, v, X1s, X2s, dt, params, phi_inits,
                         num_layers):
    """Raise unless the operands are what the kernel takes; returns each
    solid's (kind code, (x0, y0, R, 0) or (x0, y0, a, b))."""
    Ny, Nx = u.shape
    S = len(phi_inits)
    if Ny < 3 or Nx < 3:
        raise ValueError(f"rmt_block kernel needs a grid of at least 3x3, "
                         f"not {Ny}x{Nx}")
    if not 1 <= S <= MAX_SOLIDS:
        raise ValueError(f"the rmt_block kernel takes 1 to {MAX_SOLIDS} "
                         f"solids, not {S}")
    _build.check_operands("rmt_block", u, {
        "u": (u, (Ny, Nx)), "v": (v, (Ny, Nx)), "X1s": (X1s, (S, Ny, Nx)),
        "X2s": (X2s, (S, Ny, Nx)), "dt": (dt, ()), "params": (params, (4,))})
    shapes = []
    for f in phi_inits:
        spec = getattr(f, "kernel_spec", None)
        if spec is None or spec[0] not in SHAPES:
            raise ValueError(
                "the rmt_block kernel evaluates the level sets from runtime "
                "scalars and needs shapes with kernel_spec ('disc', x0, y0, "
                "R) or ('ellipse', x0, y0, a, b) (ops.levelset.Disc, "
                f"Ellipse); got {f!r}")
        q = tuple(float(x) for x in spec[1:])
        shapes.append((SHAPES.index(spec[0]), q + (0.0,) * (4 - len(q))))
    if num_layers < 1:
        raise ValueError("rmt_block kernel needs num_layers >= 1")
    return shapes


def _cuda_lib():
    lib = _build.load("rmt_block")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.pyrmt_rmt_block_f32, lib.pyrmt_rmt_block_f64):
        fn.argtypes = [P] * 19 + [I, P, P, I, I, I, I, I, I, D, D, I, D, D,
                                  D, D, I, I, D, P, I, I, P]
        fn.restype = I
    for fn in (lib.pyrmt_rmt_block_workspace_f32,
               lib.pyrmt_rmt_block_workspace_f64):
        fn.argtypes = [I, I, I, I]
        fn.restype = ctypes.c_longlong
    for fn in (lib.pyrmt_advext_f32, lib.pyrmt_advext_f64):
        fn.argtypes = [P] * 9 + [I, I, I, I, I, I, I, D, D, I, I, I, D, P,
                                 I, I, P]
        fn.restype = I
    for fn in (lib.pyrmt_advext_scratch_f32, lib.pyrmt_advext_scratch_f64):
        fn.argtypes = [I] * 4
        fn.restype = ctypes.c_longlong
    return lib


def _guard_operands(sl_interp, sl_guard):
    """(bicubic, guarded, the guard's threshold -sl_guard) for a kernel."""
    bicubic = sl_interp == "bicubic"
    guarded = bicubic and sl_guard is not None
    return int(bicubic), int(guarded), -float(sl_guard) if guarded else 0.0


def rmt_block_fused(u, v, X1s, X2s, dt, *, phi_inits, dx, dy, num_layers,
                    w_t, params, stress_w_cut=0.0, stress_clamp=0.0,
                    sl_interp="bilinear", sl_guard=None, row_offset=None,
                    Ny_total=None, col_offset=None, Nx_total=None,
                    tile_skip=True):
    """The solid block; same arguments and results as ``rmt_block_plain``.

    A CPU tensor goes to ``rmt_block_plain``. A CUDA tensor goes to the
    CUDA kernel, which takes 1 to ``MAX_SOLIDS`` solids whose level sets
    carry ``kernel_spec = ('disc', x0, y0, R)`` or ``('ellipse', x0, y0,
    a, b)`` (``rmt_block_supported``), both stress modes with or without
    the clamp and both final samples; anything else raises. dt
    and the physics scalars are read on the device, so a call does not
    wait for the card, and ``params`` may carry traced values
    (``make_step(traced_params=...)``).

    ``row_offset``, ``Ny_total``, ``col_offset`` and ``Nx_total`` (the JAX
    kernel's operands, None for a whole field) make the inputs one shard's
    slab: element (0, 0) is global cell (row_offset, col_offset), possibly
    negative, of a Ny_total x Nx_total domain. Every edge or interior
    decision, coordinate and clip then takes the global index; rows and
    columns outside the domain are never read and come out 0, and so do
    the ``cut_depth`` cells next to a cut, which depend on cells the slab
    does not hold (the plain version's result with the same operands).

    ``tile_skip=False`` (the JAX kernel's switch) makes the kernel run the
    full pipeline on every tile, the solid-free ones too: the same results,
    bit for bit, since the skip is exact. It times the skip
    (``profiling.ablation_breakdown``).

    Where an input requires a gradient the launch goes through
    ``_autograd.launch``: the kernel forward, the autograd of
    ``rmt_block_plain`` backward.
    """
    _check_interp(sl_interp)
    kw = dict(phi_inits=phi_inits, dx=dx, dy=dy, num_layers=num_layers,
              w_t=w_t, params=params, stress_w_cut=stress_w_cut,
              stress_clamp=stress_clamp, sl_interp=sl_interp,
              sl_guard=sl_guard, row_offset=row_offset, Ny_total=Ny_total,
              col_offset=col_offset, Nx_total=Nx_total, tile_skip=tile_skip)
    if u.device.type == "cpu":
        return rmt_block_plain(u, v, X1s, X2s, dt, **kw)
    return _autograd.launch(_rmt_block_cuda, rmt_block_plain,
                            (u, v, X1s, X2s, dt), kw)


def _rmt_block_cuda(u, v, X1s, X2s, dt, *, phi_inits, dx, dy, num_layers,
                    w_t, params, stress_w_cut, stress_clamp, sl_interp,
                    sl_guard, row_offset, Ny_total, col_offset, Nx_total,
                    tile_skip):
    """One launch of the fused tier's kernel on CUDA tensors."""
    global launches, offset_launches, no_skip_launches
    if u.device.type != "cuda":
        raise ValueError(f"rmt_block: no kernel for device {u.device}")
    shapes = _check_cuda_operands(u, v, X1s, X2s, dt, params, phi_inits,
                                  num_layers)
    offs, slab = _build.slab_operands(u.shape, row_offset, Ny_total,
                                      col_offset, Nx_total)
    lib = _cuda_lib()
    S = len(shapes)
    Ny, Nx = u.shape
    stacks = [_build.outputs((S, Ny, Nx), u, slab) for _ in range(7)]
    fields = [_build.outputs((Ny, Nx), u, slab) for _ in range(5)]
    f32 = u.dtype == torch.float32
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    # device memory for the panels only where they do not fit a block's
    # shared memory (num_layers past ~10)
    ws_bytes = (lib.pyrmt_rmt_block_workspace_f32 if f32 else
                lib.pyrmt_rmt_block_workspace_f64)(Ny, Nx, int(num_layers),
                                                   sms)
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=u.device)
          if ws_bytes else None)
    kinds = (ctypes.c_int * S)(*(k for k, _ in shapes))
    shape_args = (ctypes.c_double * (4 * S))(*(x for _, q in shapes
                                               for x in q))
    # the clamp's lower end as the plain version's torch.clamp takes it: a
    # Python double, rounded once to the tensor's type
    clamp = float(stress_clamp)
    clamp_lo = 1.0 / clamp if clamp > 0.0 else 0.0
    fn = lib.pyrmt_rmt_block_f32 if f32 else lib.pyrmt_rmt_block_f64
    _build.launch(lib, fn, "rmt_block kernel launch", u.device,
                  *(_build.pointer(t) for t in (u, v, X1s, X2s, dt, params,
                                                *stacks, *fields)),
                  None if ws is None else _build.pointer(ws), S, kinds,
                  shape_args, Ny, Nx, *offs, float(dx), float(dy),
                  int(num_layers), float(w_t), clamp, clamp_lo,
                  max(float(stress_w_cut), 0.0),
                  *_guard_operands(sl_interp, sl_guard), window_taps(dx, dy),
                  sms, int(bool(tile_skip)))
    if slab:
        offset_launches += 1
    else:
        launches += 1
    if not tile_skip:
        no_skip_launches += 1
    return (*stacks, *fields)


def advext_block_fused(u, v, X1s, X2s, phis, dt, *, dx, dy, num_layers,
                       sl_interp="bilinear", sl_guard=None, row_offset=None,
                       Ny_total=None, col_offset=None, Nx_total=None,
                       tile_skip=True):
    """The split tier's advect and extrapolate block; same arguments and
    results as ``advext_block_plain``.

    A CPU tensor goes to ``advext_block_plain``. A CUDA tensor goes to the
    CUDA kernel, which takes phi as a field, so any level set and any
    number of solids, and both final samples; another dtype, shape or
    device raises. dt is read on the device, so a call does not wait for
    the card. Where an input requires a gradient the backward is the
    autograd of ``advext_block_plain`` (``_autograd.launch``). The offsets
    make the inputs a shard's slab, as in ``rmt_block_fused``.
    ``tile_skip=False`` runs no flag pre-pass and the full pipeline on
    every tile (one device kernel a call), with the same results.
    """
    _check_interp(sl_interp)
    kw = dict(dx=dx, dy=dy, num_layers=num_layers, sl_interp=sl_interp,
              sl_guard=sl_guard, row_offset=row_offset, Ny_total=Ny_total,
              col_offset=col_offset, Nx_total=Nx_total, tile_skip=tile_skip)
    if u.device.type == "cpu":
        return advext_block_plain(u, v, X1s, X2s, phis, dt, **kw)
    return _autograd.launch(_advext_cuda, advext_block_plain,
                            (u, v, X1s, X2s, phis, dt), kw)


def _advext_cuda(u, v, X1s, X2s, phis, dt, *, dx, dy, num_layers, sl_interp,
                 sl_guard, row_offset, Ny_total, col_offset, Nx_total,
                 tile_skip):
    """One launch of the split tier's kernel A on CUDA tensors."""
    global advext_launches, advext_offset_launches, advext_no_skip_launches
    if u.device.type != "cuda":
        raise ValueError(f"advext_block: no kernel for device {u.device}")
    Ny, Nx = u.shape
    S = X1s.shape[0]
    _build.check_operands("advext_block", u, {
        "u": (u, (Ny, Nx)), "v": (v, (Ny, Nx)), "X1s": (X1s, (S, Ny, Nx)),
        "X2s": (X2s, (S, Ny, Nx)), "phis": (phis, (S, Ny, Nx)),
        "dt": (dt, ())})
    if Ny < 3 or Nx < 3:
        raise ValueError(f"advext_block kernel needs a grid of at least "
                         f"3x3, not {Ny}x{Nx}")
    if num_layers < 1:
        raise ValueError("advext_block kernel needs num_layers >= 1")
    offs, slab = _build.slab_operands(u.shape, row_offset, Ny_total,
                                      col_offset, Nx_total)
    lib = _cuda_lib()
    x1e = _build.outputs(X1s.shape, u, slab)
    x2e = _build.outputs(X1s.shape, u, slab)
    f32 = u.dtype == torch.float32
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    # the pre-pass's flags, and the panels' workspace past ~10 layers
    nbytes = (lib.pyrmt_advext_scratch_f32 if f32 else
              lib.pyrmt_advext_scratch_f64)(Ny, Nx, int(num_layers), sms)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=u.device)
    fn = lib.pyrmt_advext_f32 if f32 else lib.pyrmt_advext_f64
    _build.launch(lib, fn, "advext_block kernel launch", u.device,
                  *(_build.pointer(t) for t in (u, v, X1s, X2s, phis, dt,
                                                x1e, x2e, scratch)),
                  S, Ny, Nx, *offs, float(dx), float(dy), int(num_layers),
                  *_guard_operands(sl_interp, sl_guard), window_taps(dx, dy),
                  sms, int(bool(tile_skip)))
    if slab:
        advext_offset_launches += 1
    else:
        advext_launches += 1
    if not tile_skip:
        advext_no_skip_launches += 1
    return x1e, x2e
