"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and nvcc (a CUDA kernel has no CPU mode), so they
skip elsewhere. This module imports no jax, so it also runs on a machine
without it; there, skip the repository's conftest (it sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.extrapolate_fused as ef
import pyrmt_tpu_torch.kernels.momentum_rhs as mr
import pyrmt_tpu_torch.kernels.momentum_rk4 as mk
import pyrmt_tpu_torch.kernels.projection_stencils as ps
import pyrmt_tpu_torch.kernels.rmt_block as rb
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.physics import momentum_core, velocity_rhs_blended

pytestmark = pytest.mark.cuda

N = 64
# (Ny, Nx): square, wide, odd; ragged against the tile kernels' tiles on
# both axes, one tile row, a whole grid smaller than a tile, and a last
# tile one cell deep on both axes
SHAPES = [(64, 64), (48, 80), (65, 65), (203, 301), (9, 300), (5, 5),
          (33, 49)]
DISC = pt.Disc(0.6, 0.5, 0.2)
EDGE_DISC = pt.Disc(0.08, 0.9, 0.15)  # clipped by the domain's edge
# the capillary drop's ellipse (benchmarks/capillary_drop_coupled.py, R =
# 0.2, eccentricity 1.15), and one off-centre, flat and clipped by the
# domain's edge: no symmetry inside a tile
ELLIPSE = pt.Ellipse(0.5, 0.5, 0.23, 0.174)
EDGE_ELLIPSE = pt.Ellipse(0.13, 0.78, 0.21, 0.07)
# a disc and an ellipse whose contact bands touch
DISC_AND_ELLIPSE = (pt.Disc(0.36, 0.5, 0.13), pt.Ellipse(0.64, 0.52, 0.15,
                                                         0.11))
# float64 kernel vs plain version: the same IEEE operations in the same
# order (nvcc --fmad=false) and agree bit for bit on the H100
ATOL = 1e-11


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def block_inputs(dev, shape=(N, N), dtype=torch.float64, disc=DISC,
                 num_layers=3):
    Ny, Nx = shape
    cfg = pt.RMTConfig(grid=pt.Grid(Nx, Ny, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, rho_s=1.3, num_layers=num_layers)
    s = pt.make_init_state(cfg, (disc,), dtype=dtype, device=dev)
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    u = t(0.3 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    v = t(-0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y))
    kw = dict(phi_inits=(disc,), dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t,
              params=t([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f]))
    return cfg, (u, v, s.X1, s.X2, t(0.4 * cfg.grid.dx / 0.3)), kw


@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_kernel_matches_plain(dev, shape):
    _, args, kw = block_inputs(dev, shape)
    before = rb.launches
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert rb.launches == before + 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) <= ATOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("bc", [pt.make_lid_bc(0.7), pt.free_slip_box_bc,
                                pt.noop_bc])
def test_momentum_kernel_matches_plain(dev, bc, eta_s, shape):
    cfg, fields, dt = momentum_inputs(dev, shape)
    mkw = dict(eta_s=eta_s, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
               mu_f=cfg.mu_f)
    out = mk.momentum_rk4_fused(*fields, bc, **mkw)
    ref = momentum_core(*fields, bc, **mkw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= ATOL


def momentum_inputs(dev, shape, dtype=torch.float64):
    """The RK4 kernel's nine fields from the plain block's outputs, and a
    smooth pressure."""
    cfg, args, kw = block_inputs(dev, shape, dtype)
    blk = rb.rmt_block_plain(*args, **kw)
    Hf, rho, sbxx, sbxy, sbyy = blk[7:]
    mkv = (blk[2][0] <= 0.0).to(Hf.dtype) * (1.0 - Hf)
    Ny, Nx = shape
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    p = torch.tensor(0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y),
                     dtype=dtype, device=dev)
    fields = (args[0], args[1], p, sbxx, sbxy, sbyy, Hf, rho, mkv)
    return cfg, fields, args[4] / 20


def assert_close_f32(out, ref, rel):
    """float32: max-abs <= rel * max(1, max |plain|) (chip_smoke.py's
    bounds)."""
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        scale = max(1.0, float(r.abs().max()))
        assert float((o - r).abs().max()) <= rel * scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
def test_tile_kernels_match_plain_in_float32(dev, disc, shape):
    """The two tile kernels in float32: rmt_block to 1e-4 and momentum_rk4
    to 1e-5 of max(1, |plain|); they round alike, so the expected
    difference is 0."""
    _, args, kw = block_inputs(dev, shape, torch.float32, disc)
    assert_close_f32(rb.rmt_block_fused(*args, **kw),
                     rb.rmt_block_plain(*args, **kw), 1e-4)
    cfg, fields, dt = momentum_inputs(dev, shape, torch.float32)
    mkw = dict(eta_s=0.01, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
               mu_f=cfg.mu_f)
    bc = pt.free_slip_box_bc
    assert_close_f32(mk.momentum_rk4_fused(*fields, bc, **mkw),
                     momentum_core(*fields, bc, **mkw), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layers", [1, 5, 7, 9, 12])
def test_rmt_block_kernel_takes_any_num_layers(dev, layers, dtype):
    """As the layers grow the panel outgrows a block's shared memory: the
    tile shrinks from 32 to 16 and 8 cells (float32: 7 and 9 layers;
    float64: 5) and then the panels move to a device-memory workspace
    (float32 from 10 layers, float64 from 7)."""
    _, args, kw = block_inputs(dev, (65, 97), dtype, num_layers=layers)
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("what", ["u_nan", "v_inf", "u_huge", "X1_nan",
                                  "X2_inf", "dt_nan"])
def test_rmt_block_tile_skip_is_exact_for_any_input(dev, what):
    """A tile far from the solid takes the skip only where the full
    pipeline gives the zero map: a non-finite (or overflowing) velocity or
    map, or a non-finite dt, sends it down the full path, so the kernel
    gives the plain version's NaNs where that one does."""
    _, args, kw = block_inputs(dev)
    args = [a.clone() for a in args]
    u, v, X1, X2, dt = args
    at = (3, 5)  # far from the disc at (0.6, 0.5)
    if what == "u_nan":
        u[at] = float("nan")
    elif what == "v_inf":
        v[at] = float("inf")
    elif what == "u_huge":
        u[at] = 1e308  # finite; its backtrace may overflow
    elif what == "X1_nan":
        X1[(0, *at)] = float("nan")
    elif what == "X2_inf":
        X2[(0, *at)] = float("inf")
    else:
        args[4] = torch.full_like(dt, float("nan"))
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert what == "u_huge" or not bool(
        torch.isfinite(ref[0]).all() and torch.isfinite(ref[1]).all())
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=ATOL, equal_nan=True)


TILE_KERNELS = ["rmt_block", "momentum_rk4", "advext_block", "velocity_rhs",
                "rc_rhs", "grad_correct", "extrapolate_fused",
                "rmt_block, two solids", "momentum_rk4, force",
                "momentum_rk4, periodic", "rmt_block, ellipse",
                "rmt_block, disc and ellipse"]


@pytest.fixture(scope="module")
def device_kernels_per_call():
    """{(kernel, dtype): the device events of one wrapper call} for each
    tile kernel at 203x301, from one torch.profiler session with a spin
    kernel before each call and after the last: on the card's machine a
    process's later profiler sessions may record no device work, so the
    cases share one (as chip_smoke.py's profile does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    shape = (203, 301)
    calls = {}
    for dtype in (torch.float64, torch.float32):
        calls[("rmt_block", dtype)] = (rb.rmt_block_fused, *block_inputs(
            dev, shape, dtype)[1:])
        calls[("rmt_block, two solids", dtype)] = (
            rb.rmt_block_fused, *multi_call(dev, shape, dtype, TWO_DISCS))
        calls[("rmt_block, ellipse", dtype)] = (rb.rmt_block_fused,
                                                *block_inputs(
                                                    dev, shape, dtype,
                                                    ELLIPSE)[1:])
        calls[("rmt_block, disc and ellipse", dtype)] = (
            rb.rmt_block_fused, *multi_call(dev, shape, dtype,
                                            DISC_AND_ELLIPSE))
        calls[("momentum_rk4", dtype)] = momentum_call(dev, shape, dtype)
        fn, margs, mkw = momentum_call(dev, shape, dtype)
        calls[("momentum_rk4, force", dtype)] = (fn, margs, dict(
            mkw, **force_fields(dev, shape, dtype)))
        calls[("momentum_rk4, periodic", dtype)] = periodic_call(dev, shape,
                                                                dtype)
        calls[("advext_block", dtype)] = (rb.advext_block_fused,
                                          *split_call(dev, shape, DISC, dtype))
        calls[("velocity_rhs", dtype)] = (mr.velocity_rhs_blended_fused,
                                          rhs_inputs(dev, shape, dtype), {})
        calls[("rc_rhs", dtype)] = (ps.rc_rhs_fused,
                                    rc_args(dev, shape, dtype), {})
        calls[("grad_correct", dtype)] = (ps.grad_correct_fused, gc_args(
            dev, shape, dtype, pt.free_slip_box_bc), {})
        calls[("extrapolate_fused", dtype)] = (
            ef.extrapolate_reference_map_fused,
            extrap_args(dev, shape, dtype=dtype), {})
    for fn, args, kw in calls.values():
        fn(*args, **kw)  # builds and warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, args, kw in calls.values():
            torch.cuda._sleep(1000)
            fn(*args, **kw)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = sum("spin_kernel" in e.name for e in events)
    assert marks in (len(calls), len(calls) + 1), marks
    out = {key: [] for key in calls}
    keys = list(calls)
    k = len(calls) + 1 - marks  # 1 where the first mark was not recorded
    for e in events:
        if "spin_kernel" in e.name:
            k += 1
        elif 0 < k <= len(keys):
            out[keys[k - 1]].append(e.name)
    return out


@pytest.mark.parametrize("kernel", TILE_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_kernel_call_runs_one_device_kernel(device_kernels_per_call,
                                                 kernel, dtype):
    """One wrapper call of each tile kernel runs exactly one CUDA kernel
    on the card (torch.profiler), no copy and no other kernel (with two
    solids and with a force too); advext_block and extrapolate_fused run
    two, their skip's flag pre-pass and their tile kernel. On the periodic
    box momentum_rk4's wrapper applies periodic_bc first (a few PyTorch
    copies), then launches one CUDA kernel."""
    device = device_kernels_per_call[(kernel, dtype)]
    two = ("advext_block", "extrapolate_fused")
    if kernel == "momentum_rk4, periodic":
        assert sum("rk4_periodic_kernel" in n for n in device) == 1, device
        assert sum("rk4_" in n for n in device) == 1, device
        return
    assert len(device) == (2 if kernel in two else 1), device


def momentum_call(dev, shape, dtype):
    """(momentum_rk4_fused, its arguments, its keywords) under the lid."""
    cfg, fields, dt = momentum_inputs(dev, shape, dtype)
    mkw = dict(eta_s=0.01, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
               mu_f=cfg.mu_f)
    return mk.momentum_rk4_fused, (*fields, pt.make_lid_bc(1.0)), mkw


def test_kernel_path_step_matches_plain_path(dev):
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01)
    kw = dict(dtype=torch.float64, device=dev)
    step_k = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw)
    step_p = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                          rmt_block_impl=rb.rmt_block_plain,
                          momentum_rk4_impl=momentum_core)
    s_k = s_p = pt.make_init_state(cfg, (DISC,), **kw)
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert float((getattr(s_k, k) - getattr(s_p, k)).abs().max()) <= 1e-10


def test_kernels_raise_on_what_they_do_not_take(dev):
    _, args, kw = block_inputs(dev)
    with pytest.raises(ValueError):  # a level set without kernel_spec
        rb.rmt_block_fused(*args, **dict(kw, phi_inits=(lambda x, y: x,)))
    with pytest.raises(ValueError):  # a final sample it does not know
        rb.rmt_block_fused(*args, **dict(kw, sl_interp="bicubic_raw"))
    with pytest.raises(ValueError):  # more solids than the kernel takes
        S = rb.MAX_SOLIDS + 1
        rb.rmt_block_fused(args[0], args[1], args[2].expand(S, -1, -1),
                           args[3].expand(S, -1, -1), args[4],
                           **dict(kw, phi_inits=(DISC,) * S))
    with pytest.raises(ValueError):  # operands on two devices
        rb.rmt_block_fused(args[0], args[1].cpu(), *args[2:], **kw)
    u = args[0]
    with pytest.raises(ValueError):  # a BC without kernel_spec
        mk.momentum_rk4_fused(*([u] * 9), lambda a, b: (a, b), eta_s=0.0,
                              dx=0.1, dy=0.1, dt=args[4], mu_f=0.01)
    with pytest.raises(TypeError):
        h = u.half()
        mk.momentum_rk4_fused(*([h] * 9), pt.noop_bc, eta_s=0.0, dx=0.1,
                              dy=0.1, dt=args[4].half(), mu_f=0.01)
    with pytest.raises(ValueError):  # one force field without the other
        mk.momentum_rk4_fused(*([u] * 9), pt.noop_bc, eta_s=0.0, dx=0.1,
                              dy=0.1, dt=args[4], mu_f=0.01, f_ext_x=u)


def split_inputs(dev, shape, disc, dtype=torch.float64, solids=None):
    """The block inputs plus a pre-advection phi that is the disc shifted
    and wobbled off the map's own rebuild; with ``solids`` (a tuple of
    discs) the stacks of all of them."""
    Ny, Nx = shape
    solids = solids or (disc,)
    cfg = pt.RMTConfig(grid=pt.Grid(Nx, Ny, 1.0, 1.0), mu_s=0.1, mu_f=0.01)
    s = pt.make_init_state(cfg, solids, dtype=dtype, device=dev)
    X, Y = cfg.grid.coords(dtype=dtype, device=dev)
    wobble = (0.2 * cfg.grid.dx
              * torch.sin(4 * torch.pi * X) * torch.cos(2 * torch.pi * Y))
    phis = torch.stack([d(X, Y) + wobble for d in solids])
    u = 0.3 * torch.sin(2 * torch.pi * X) * torch.cos(2 * torch.pi * Y)
    v = -0.3 * torch.cos(2 * torch.pi * X) * torch.sin(2 * torch.pi * Y)
    dt = torch.tensor(0.4 * cfg.grid.dx / 0.3, dtype=dtype, device=dev)
    return cfg, (u, v, s.X1, s.X2, phis.contiguous(), dt)


def split_call(dev, shape, disc, dtype=torch.float64, num_layers=3,
               solids=None):
    """(advext_block's arguments, its keywords)."""
    cfg, args = split_inputs(dev, shape, disc, dtype, solids)
    return args, dict(dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=num_layers)


@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_advext_kernel_matches_plain(dev, shape, disc):
    cfg, args = split_inputs(dev, shape, disc)
    kw = dict(dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=cfg.num_layers)
    before = rb.advext_launches
    out = rb.advext_block_fused(*args, **kw)
    ref = rb.advext_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert rb.advext_launches == before + 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape == (1,) + shape
        assert float((o - r).abs().max()) <= ATOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layers", [1, 5, 7, 9, 12])
def test_advext_kernel_takes_any_num_layers(dev, layers, dtype):
    """The split tier's panels as the fused tier's: the tile shrinks to 16
    and 8 cells, then the panels move to a device-memory workspace (after
    the pre-pass's flags in the same scratch)."""
    args, kw = split_call(dev, (65, 97), DISC, dtype, layers)
    out = rb.advext_block_fused(*args, **kw)
    ref = rb.advext_block_plain(*args, **kw)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_advext_kernel_takes_two_solids(dev, dtype):
    """Two solids share one backtrace per cell; each has its own mask,
    known cells and sweeps."""
    solids = (DISC, pt.Disc(0.25, 0.3, 0.12))
    args, kw = split_call(dev, (96, 130), DISC, dtype, solids=solids)
    out = rb.advext_block_fused(*args, **kw)
    ref = rb.advext_block_plain(*args, **kw)
    assert out[0].shape == (2, 96, 130)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("what", ["u_nan", "v_inf", "u_huge", "X1_nan",
                                  "X2_inf", "dt_nan", "phi_nan"])
def test_advext_block_tile_skip_is_exact_for_any_input(dev, what):
    """As rmt_block's skip: a tile far from the solid skips only where the
    full path gives the zero map, so a non-finite (or overflowing) velocity
    or map, or a non-finite dt, gives the plain version's NaNs; a NaN phi
    there gives the zero map in both."""
    args, kw = split_call(dev, (160, 160), DISC)
    u, v, X1, X2, phis, dt = [a.clone() for a in args]
    at = (3, 5)  # far from the disc at (0.6, 0.5): 64 cells and more
    if what == "u_nan":
        u[at] = float("nan")
    elif what == "v_inf":
        v[at] = float("inf")
    elif what == "u_huge":
        u[at] = 1e308  # finite; its backtrace may overflow
    elif what == "X1_nan":
        X1[(0, *at)] = float("nan")
    elif what == "X2_inf":
        X2[(0, *at)] = float("inf")
    elif what == "phi_nan":
        phis[(0, *at)] = float("nan")
    else:
        dt = torch.full_like(dt, float("nan"))
    args = (u, v, X1, X2, phis, dt)
    out = rb.advext_block_fused(*args, **kw)
    ref = rb.advext_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert what in ("u_huge", "phi_nan") or not bool(
        torch.isfinite(ref[0]).all() and torch.isfinite(ref[1]).all())
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_and_rhs_kernels_match_plain_in_float32(dev, shape):
    """advext_block to 1e-4 and velocity_rhs to 1e-5 of max(1, |plain|) in
    float32 (chip_smoke.py's bounds); the expected difference is 0."""
    args, kw = split_call(dev, shape, DISC, torch.float32)
    assert_close_f32(rb.advext_block_fused(*args, **kw),
                     rb.advext_block_plain(*args, **kw), 1e-4)
    rargs = rhs_inputs(dev, shape, torch.float32)
    assert_close_f32(mr.velocity_rhs_blended_fused(*rargs),
                     velocity_rhs_blended(*rargs), 1e-5)


def extrap_args(dev, shape, disc=DISC, dtype=torch.float64, layers=3):
    """The extrapolation's arguments: the identity map inside the wobbled
    disc (phi < 0), as a rebase extrapolates it, in dtype."""
    cfg, args = split_inputs(dev, shape, disc)
    X, Y = cfg.grid.coords(dtype=torch.float64, device=dev)
    phi = args[4][0]
    m = (phi < 0).to(X.dtype)
    return [f.to(dtype).contiguous() for f in (X * m, Y * m, phi)] + [
        cfg.grid.dx, cfg.grid.dy, layers]


@pytest.mark.parametrize("layers", [0, 1, 3, 4])
@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_extrapolate_fused_kernel_matches_plain(dev, shape, disc, layers):
    a = extrap_args(dev, shape, disc, layers=layers)
    before = ef.launches
    out = ef.extrapolate_reference_map_fused(*a)
    ref = extrapolate_reference_map(*a)
    torch.cuda.synchronize()
    assert ef.launches == before + 1
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= ATOL


@pytest.mark.parametrize("dtype, layers", [
    (torch.float64, 6), (torch.float64, 8), (torch.float64, 9),
    (torch.float32, 9), (torch.float32, 11), (torch.float32, 12)],
    ids=["f64-16", "f64-8", "f64-workspace", "f32-16", "f32-8",
         "f32-workspace"])
def test_extrapolate_fused_kernel_takes_any_num_layers(dev, dtype, layers):
    """As the layers grow the panel (the tile plus 4L each side, no u, v)
    outgrows a block's shared memory: the tile shrinks from 32 to 16 and 8
    cells, then the panels move to a device-memory workspace (float64 from
    9 layers, float32 from 12)."""
    a = extrap_args(dev, (65, 97), dtype=dtype, layers=layers)
    assert_bit_for_bit(ef.extrapolate_reference_map_fused(*a),
                       extrapolate_reference_map(*a))


@pytest.mark.parametrize("what", ["X1_nan_far", "X2_inf_far", "X1_inf_near",
                                  "phi_nan_far", "phi_nan_near"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extrapolate_fused_copy_is_exact_for_any_input(dev, dtype, what):
    """A tile copies X1, X2 only where no cell can change, so a NaN or an
    infinity far from the solid comes out where it went in, one in a
    frontier cell's window gives the plain version's NaNs, and a NaN phi
    is an unknown cell in both."""
    a = extrap_args(dev, (160, 160), dtype=dtype)
    X1, X2, phi = (f.clone() for f in a[:3])
    far, near = (3, 5), (80, 129)  # the disc's edge is at i = 127.2 there
    if what == "X1_nan_far":
        X1[far] = float("nan")
    elif what == "X2_inf_far":
        X2[far] = float("inf")
    elif what == "X1_inf_near":
        X1[near] = float("inf")
    elif what == "phi_nan_far":
        phi[far] = float("nan")
    else:
        phi[80, 126] = float("nan")  # a solid cell
    a[:3] = X1, X2, phi
    out = ef.extrapolate_reference_map_fused(*a)
    ref = extrapolate_reference_map(*a)
    assert_bit_for_bit(out, ref)
    assert bool(torch.isnan(ref[0]).any()) == (what in ("X1_nan_far",
                                                        "X1_inf_near"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extrapolate_fused_takes_misaligned_fields(dev, dtype):
    a = extrap_args(dev, (48, 80), dtype=dtype)
    a[0], a[2] = misaligned(a[0]), misaligned(a[2])
    assert a[0].data_ptr() % 16 != 0
    assert_bit_for_bit(ef.extrapolate_reference_map_fused(*a),
                       extrapolate_reference_map(*a))


@pytest.mark.parametrize("known", ["none", "all"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extrapolate_fused_every_tile_copies(dev, dtype, known):
    """With no known cell, or no unknown one, every tile copies: the
    outputs are the inputs bit for bit, as in the plain version."""
    a = extrap_args(dev, (203, 301), dtype=dtype)
    a[2] = torch.full_like(a[2], 1.0 if known == "none" else -1.0)
    out = ef.extrapolate_reference_map_fused(*a)
    assert_bit_for_bit(out, extrapolate_reference_map(*a))
    assert_bit_for_bit(out, a[:2])


@pytest.mark.parametrize("override", [
    dict(phi_area_fix=True, reinit_method="pde"),
    dict(map_rebase_minj=10.0),   # a rebase on every step
])
def test_split_kernel_path_matches_plain_path(dev, override):
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, **override)
    kw = dict(dtype=torch.float64, device=dev)
    step_k = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw)
    step_p = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                          momentum_rk4_impl=momentum_core,
                          advext_impl=rb.advext_block_plain,
                          extrap_impl=extrapolate_reference_map)
    s_k = s_p = pt.make_init_state(cfg, (DISC,), **kw)
    before = (rb.launches, rb.advext_launches, ef.launches)
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    rebases = 3 if cfg.map_rebase_minj > 0 else 0
    assert (rb.launches, rb.advext_launches, ef.launches) == (
        before[0], before[1] + 3, before[2] + rebases)
    for k in ("u", "v", "p", "X1", "X2", "t", "phis0"):
        diff = (getattr(s_k, k) - getattr(s_p, k)).abs()
        assert diff.numel() == 0 or float(diff.max()) <= 1e-10, k


def test_split_tier_kernel_takes_any_level_set(dev):
    def ellipse(X1, X2):
        return torch.sqrt(((X1 - 0.5) / 1.3) ** 2 + (X2 - 0.5) ** 2) - 0.15

    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, mu_f=0.01,
                       phi_area_fix=True)
    kw = dict(dtype=torch.float64, device=dev)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (ellipse,), **kw)
    s = pt.make_init_state(cfg, (ellipse,), **kw)
    before = rb.advext_launches
    for _ in range(2):
        s, _ = step(s, 1.0)
    assert rb.advext_launches == before + 2 and not bool(pt.diverged(s))


def test_split_kernels_raise_on_what_they_do_not_take(dev):
    cfg, args = split_inputs(dev, (N, N), DISC)
    kw = dict(dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=3)
    with pytest.raises(TypeError):  # dtype
        rb.advext_block_fused(*(a.half() for a in args), **kw)
    with pytest.raises(ValueError):  # operands on two devices
        rb.advext_block_fused(args[0], args[1].cpu(), *args[2:], **kw)
    with pytest.raises(ValueError):  # phis of another shape
        rb.advext_block_fused(*args[:4], args[4][:, :-1], args[5], **kw)
    with pytest.raises(ValueError):  # a 2x3 grid
        rb.advext_block_fused(*(a[..., :2, :3].contiguous() for a in args[:5]),
                              args[5], **kw)
    X1, X2, phi = args[2][0], args[3][0], args[4][0]
    with pytest.raises(TypeError):
        ef.extrapolate_reference_map_fused(X1.half(), X2.half(), phi.half(),
                                           0.1, 0.1, 3)
    with pytest.raises(ValueError):
        ef.extrapolate_reference_map_fused(X1, X2, phi.cpu(), 0.1, 0.1, 3)
    with pytest.raises(ValueError):
        ef.extrapolate_reference_map_fused(X1, X2[:-1], phi, 0.1, 0.1, 3)
    with pytest.raises(ValueError):
        ef.extrapolate_reference_map_fused(X1, X2, phi, 0.1, 0.1, -1)


def stencil_inputs(dev, shape, seed=0):
    """Seeded velocities, pressures and a two-valued density on the grid."""
    Ny, Nx = shape
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    a = 0.3 * np.sin(2 * np.pi * X) * np.cos(3 * np.pi * Y)
    b = -0.2 * np.cos(3 * np.pi * X) * np.sin(2 * np.pi * Y)
    a += 0.01 * rng.standard_normal(shape)
    b += 0.01 * rng.standard_normal(shape)
    p = 0.1 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    pc = 0.01 * rng.standard_normal(shape)
    rho = 1.0 + 0.3 * (np.hypot(X - 0.6, Y - 0.5) < 0.2)
    return [t(f) for f in (a, b, p, pc, rho)], 1.0 / (Nx - 1), 1.0 / (Ny - 1)


def assert_equal_to_plain(out, ref):
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) <= ATOL


# the projection stencils' 64 x 32 tiles: SHAPES, the smallest grids (3
# rows or columns) and a grid whose last tiles are 5 rows deep and 6
# columns wide, with Nx not a multiple of 4 (float32 rows of a multiple of
# 16 bytes take 16-byte copies: 64, 48x80, 9x300, 3x200 do)
STENCIL_SHAPES = SHAPES + [(3, 3), (3, 200), (200, 3), (2053, 390)]
DTYPES = [torch.float64, torch.float32]
STENCIL_BCS = [pt.make_lid_bc(0.7), pt.free_slip_box_bc, pt.noop_bc]


def assert_bit_for_bit(out, ref):
    """max-abs 0.0 and NaN where the plain version has NaN."""
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0, equal_nan=True)


def rc_args(dev, shape, dtype, seed=0):
    (a, b, p, _, rho), dx, dy = stencil_inputs(dev, shape, seed)
    a, b, p, rho = (f.to(dtype) for f in (a, b, p, rho))
    dt = torch.tensor(1.3e-3, dtype=dtype, device=dev)
    return [a, b, p, rho, dt, dt / rho.mean(), dx, dy]


def gc_args(dev, shape, dtype, bc, seed=1):
    (a, b, _, pc, rho), dx, dy = stencil_inputs(dev, shape, seed)
    pc, a, b, rho = (f.to(dtype) for f in (pc, a, b, rho))
    dt = torch.tensor(1.3e-3, dtype=dtype, device=dev)
    return [pc, a, b, rho, dt, dx, dy, bc]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_rc_rhs_kernel_matches_plain(dev, shape, dtype):
    """Bit for bit, float64 and float32."""
    args = rc_args(dev, shape, dtype)
    before = ps.rc_rhs_launches
    assert_bit_for_bit([ps.rc_rhs_fused(*args)], [ps.rc_rhs_plain(*args)])
    assert ps.rc_rhs_launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
@pytest.mark.parametrize("bc", STENCIL_BCS)
def test_grad_correct_kernel_matches_plain(dev, bc, shape, dtype):
    """Bit for bit, float64 and float32."""
    args = gc_args(dev, shape, dtype, bc)
    before = ps.grad_correct_launches
    assert_bit_for_bit(ps.grad_correct_fused(*args),
                       ps.grad_correct_plain(*args))
    assert ps.grad_correct_launches == before + 1


def place(f, at, what):
    f = f.clone()
    big = torch.finfo(f.dtype).max / 4
    f[at] = {"nan": float("nan"), "inf": float("inf"), "huge": big}[what]
    return f


@pytest.mark.parametrize("at", [(1, 2), (6, 1), (20, 30)],
                         ids=["next_to_corner", "next_to_side", "interior"])
@pytest.mark.parametrize("what", ["a_nan", "b_inf", "p_huge", "p_nan",
                                  "rho_inf", "rho_huge"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rc_rhs_kernel_takes_non_finite_inputs(dev, dtype, what, at):
    """A NaN, an infinity or a huge value in one input off the boundary
    ring: the kernel gives the plain version's output at every cell, NaN
    for NaN. The ring is 0 in both because the plain version computes
    rho * 0 / dt there with a finite rho (rc_rhs_pallas and the kernel
    write 0 whatever rho is); d_scalar stays that of the finite density."""
    args = rc_args(dev, (48, 80), dtype)
    name, value = what.split("_")
    k = {"a": 0, "b": 1, "p": 2, "rho": 3}[name]
    args[k] = place(args[k], at, value)
    out, ref = ps.rc_rhs_fused(*args), ps.rc_rhs_plain(*args)
    assert not bool(torch.isfinite(ref).all()) or value == "huge"
    assert_bit_for_bit([out], [ref])


@pytest.mark.parametrize("at", [(1, 2), (6, 1), (20, 30)],
                         ids=["next_to_corner", "next_to_side", "interior"])
@pytest.mark.parametrize("what", ["pc_nan", "pc_inf", "pc_huge", "a_nan",
                                  "b_inf", "rho_nan", "rho_zero"])
@pytest.mark.parametrize("bc", STENCIL_BCS, ids=["lid", "free_slip", "noop"])
def test_grad_correct_kernel_takes_non_finite_inputs(dev, bc, what, at):
    """As for rc_rhs, under each BC, in float32: the free-slip copies carry
    a non-finite corrected value of row 1 and column 1 to the walls, and a
    zero density makes dt / rho infinite (times a zero gradient, NaN)."""
    args = gc_args(dev, (48, 80), torch.float32, bc)
    name, value = what.split("_")
    k = {"pc": 0, "a": 1, "b": 2, "rho": 3}[name]
    if value == "zero":
        args[k] = args[k].clone()
        args[k][at] = 0.0
    else:
        args[k] = place(args[k], at, value)
    assert_bit_for_bit(ps.grad_correct_fused(*args),
                       ps.grad_correct_plain(*args))


def misaligned(f):
    """f's values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    flat = torch.empty(f.numel() + 1, dtype=f.dtype, device=f.device)
    out = flat[1:].view(f.shape)
    out.copy_(f)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil_kernels_take_misaligned_fields(dev, dtype):
    """Rows of a multiple of 16 bytes take 16-byte copies only where every
    field starts at a 16-byte boundary; one that does not takes the
    element copies, with the same result."""
    args = rc_args(dev, (48, 80), dtype)
    args[2] = misaligned(args[2])
    assert args[2].data_ptr() % 16 != 0
    assert_bit_for_bit([ps.rc_rhs_fused(*args)], [ps.rc_rhs_plain(*args)])
    args = gc_args(dev, (48, 80), dtype, pt.free_slip_box_bc)
    args[3] = misaligned(args[3])
    assert_bit_for_bit(ps.grad_correct_fused(*args),
                       ps.grad_correct_plain(*args))


def rhs_inputs(dev, shape, dtype=torch.float64):
    """velocity_rhs's arguments: the block's velocity and blended fields, a
    smooth pressure and a random force, made in float64 and cast."""
    cfg, args, kw = block_inputs(dev, shape)
    blk = rb.rmt_block_plain(*args, **kw)
    Hf, rho, sbxx, sbxy, sbyy = blk[7:]
    (_, _, p, _, _), dx, dy = stencil_inputs(dev, shape)
    rng = np.random.default_rng(2)
    fx, fy = (torch.tensor(0.01 * rng.standard_normal(shape),
                           dtype=torch.float64, device=dev) for _ in range(2))
    fields = [f.to(dtype) for f in (args[0], args[1], p, sbxx, sbxy, sbyy,
                                    Hf, rho, fx, fy)]
    return (*fields[:6], dx, dy, cfg.mu_f, *fields[6:])


@pytest.mark.parametrize("shape", SHAPES)
def test_velocity_rhs_kernel_matches_plain(dev, shape):
    rargs = rhs_inputs(dev, shape)
    before = mr.launches
    assert_equal_to_plain(mr.velocity_rhs_blended_fused(*rargs),
                          velocity_rhs_blended(*rargs))
    assert mr.launches == before + 1


@pytest.mark.parametrize("override", [
    dict(projection_method="pallas"),
    dict(momentum_method="xla", use_pallas_rhs=True),
    dict(projection_method="pallas", momentum_method="xla",
         use_pallas_rhs=True, phi_area_fix=True, reinit_method="pde"),
])
def test_opt_in_kernel_paths_match_plain_paths(dev, override):
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, **override)
    kw = dict(dtype=torch.float64, device=dev)
    step_k = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw)
    step_p = pt.make_step(
        cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
        rmt_block_impl=rb.rmt_block_plain, momentum_rk4_impl=momentum_core,
        advext_impl=rb.advext_block_plain,
        momentum_rhs_impl=velocity_rhs_blended,
        projection_stencils_impl=(ps.rc_rhs_plain, ps.grad_correct_plain))
    s_k = s_p = pt.make_init_state(cfg, (DISC,), **kw)
    before = (ps.rc_rhs_launches, ps.grad_correct_launches, mr.launches,
              mk.launches)
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    proj = 3 if cfg.projection_method == "pallas" else 0
    rhs = 12 if cfg.use_pallas_rhs else 0
    assert (ps.rc_rhs_launches, ps.grad_correct_launches, mr.launches,
            mk.launches) == (before[0] + proj, before[1] + proj,
                             before[2] + rhs, before[3] + 3 - rhs // 4)
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert float((getattr(s_k, k) - getattr(s_p, k)).abs().max()) <= 1e-10


def test_opt_in_kernels_raise_on_what_they_do_not_take(dev):
    (a, b, p, pc, rho), dx, dy = stencil_inputs(dev, (N, N))
    dt = torch.tensor(1e-3, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):  # a BC without kernel_spec
        ps.grad_correct_fused(pc, a, b, rho, dt, dx, dy, lambda u, v: (u, v))
    with pytest.raises(ValueError):  # dt as a Python float
        ps.rc_rhs_fused(a, b, p, rho, 1e-3, dt, dx, dy)
    with pytest.raises(ValueError):  # a scalar density
        ps.rc_rhs_fused(a, b, p, rho.mean(), dt, dt, dx, dy)
    with pytest.raises(TypeError):
        h = a.half()
        mr.velocity_rhs_blended_fused(*([h] * 6), dx, dy, 0.01, *([h] * 4))
    with pytest.raises(ValueError):  # a 4x4 grid
        s = a[:4, :4].contiguous()
        mr.velocity_rhs_blended_fused(*([s] * 6), dx, dy, 0.01, *([s] * 4))


# the fused tier with S solids: the contact configuration's discs (their
# contact bands touch), two apart (a tile near one solid skips the other),
# two overlapping, three, and one solid with the clamp
TWO_DISCS = (pt.Disc(0.38, 0.5, 0.14), pt.Disc(0.66, 0.5, 0.14))
SOLID_CASES = {
    "contact": TWO_DISCS,
    "apart": (pt.Disc(0.25, 0.3, 0.12), pt.Disc(0.72, 0.7, 0.12)),
    "overlap": (pt.Disc(0.45, 0.5, 0.2), pt.Disc(0.6, 0.5, 0.2)),
    "three": TWO_DISCS + (pt.Disc(0.52, 0.8, 0.12),),
    "one": (DISC,),
}


def multi_call(dev, shape, dtype, solids, clamp=4.0):
    """(rmt_block's arguments, its keywords) for the solids, with the
    collision clamp: the maps from make_init_state, the first squeezed and
    stretched along x by a sine (det G down to ~0.2 at N=64) and, with two
    solids or more, the second stretched 3x along x and 2x along y (det G
    6), so the clamp bites at both ends; made in float64 and cast."""
    Ny, Nx = shape
    cfg = pt.RMTConfig(grid=pt.Grid(Nx, Ny, 1.0, 1.0), mu_s=1.0, kappa=0.5,
                       mu_f=0.01, rho_s=1.3)
    s = pt.make_init_state(cfg, solids, dtype=torch.float64, device=dev)
    X1, X2 = s.X1.clone(), s.X2.clone()
    k = 2 * math.pi / 0.1
    X1[0] = X1[0] + (0.95 / k) * torch.sin(k * X1[0])
    if len(solids) > 1:
        x0, y0 = solids[1].x0, solids[1].y0
        X1[1] = torch.where(X1[1] != 0, x0 + 3.0 * (X1[1] - x0), X1[1])
        X2[1] = torch.where(X2[1] != 0, y0 + 2.0 * (X2[1] - y0), X2[1])
    X, Y = cfg.grid.coords(dtype=torch.float64, device=dev)
    u = 0.3 * torch.sin(2 * torch.pi * X) * torch.cos(2 * torch.pi * Y)
    v = -0.3 * torch.cos(2 * torch.pi * X) * torch.sin(2 * torch.pi * Y)
    t = lambda a: a.to(dtype).contiguous()
    dt = torch.tensor(0.4 * cfg.grid.dx / 0.3, dtype=dtype, device=dev)
    kw = dict(phi_inits=solids, dx=cfg.grid.dx, dy=cfg.grid.dy,
              num_layers=cfg.num_layers, w_t=cfg.w_t,
              params=torch.tensor([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f],
                                  dtype=dtype, device=dev),
              stress_clamp=clamp)
    return [t(u), t(v), t(X1), t(X2), dt], kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(SOLID_CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_kernel_takes_several_solids(dev, shape, case, dtype):
    """S solids and the clamp, one launch: float64 to 1e-11 (S = 2 is bit
    for bit; S = 3 leaves torch.sum's order of three terms to it), float32
    to 1e-4 of max(1, |plain|)."""
    args, kw = multi_call(dev, shape, dtype, SOLID_CASES[case])
    before = rb.launches
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    assert rb.launches == before + 1
    assert out[0].shape == (len(SOLID_CASES[case]),) + shape
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("clamp", [4.0, 0.0, 2.5])
def test_rmt_block_two_solid_clamp_bites(dev, clamp):
    """With the clamp c, J over the solids spans [1/c, c] (det G left it at
    both ends), in the kernel as in the plain version, bit for bit; without
    it (0) J goes past both. The clamp's lower end is 1.0 / c in double,
    rounded once to the type (2.5: 0.4 is not a float)."""
    for dtype in DTYPES:
        args, kw = multi_call(dev, (64, 64), dtype, TWO_DISCS, clamp)
        out = rb.rmt_block_fused(*args, **kw)
        ref = rb.rmt_block_plain(*args, **kw)
        assert_bit_for_bit(out, ref)
        J = ref[6][ref[2] <= 0.0]
        lo, hi = float(J.min()), float(J.max())
        if clamp:
            assert abs(hi - clamp) <= 1e-6 * clamp
            assert abs(lo - 1.0 / clamp) <= 1e-6 / clamp
        else:
            assert hi > 4.0 and lo < 0.25


@pytest.mark.parametrize("what", ["u_nan", "X1_nan", "X2_inf", "dt_nan"])
def test_rmt_block_two_solids_non_finite_inputs(dev, what):
    """A NaN or an infinity in the second solid's map far from both discs
    (or in u, or dt): the kernel gives the plain version's NaNs; the first
    solid's tiles there may skip."""
    args, kw = multi_call(dev, (160, 160), torch.float64, TWO_DISCS)
    u, v, X1, X2, dt = args
    at = (5, 150)  # far from the discs
    if what == "u_nan":
        u[at] = float("nan")
    elif what == "X1_nan":
        X1[(1, *at)] = float("nan")
    elif what == "X2_inf":
        X2[(1, *at)] = float("inf")
    else:
        args[4] = torch.full_like(dt, float("nan"))
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref[0]).all() and
                    torch.isfinite(ref[1]).all())
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=ATOL, equal_nan=True)


def force_fields(dev, shape, dtype=torch.float64, seed=3):
    """{"f_ext_x", "f_ext_y"}: a contact-like random force and a buoyancy-
    like one, made in float64 and cast."""
    Ny, Nx = shape
    rng = np.random.default_rng(seed)
    Y = np.linspace(0.0, 1.0, Ny)[:, None] * np.ones((1, Nx))
    fx = 0.05 * rng.standard_normal(shape)
    fy = -0.3 * (Y > 0.5) + 0.05 * rng.standard_normal(shape)
    return {k: torch.tensor(f, dtype=torch.float64, device=dev).to(dtype)
            for k, f in (("f_ext_x", fx), ("f_ext_y", fy))}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("bc", [pt.make_lid_bc(0.7), pt.free_slip_box_bc,
                                pt.noop_bc])
def test_momentum_kernel_with_force_matches_plain(dev, bc, eta_s, shape):
    """The force instantiation, one launch, bit for bit in float64 and to
    1e-5 of max(1, |plain|) in float32."""
    for dtype in DTYPES:
        cfg, fields, dt = momentum_inputs(dev, shape, dtype)
        mkw = dict(eta_s=eta_s, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
                   mu_f=cfg.mu_f, **force_fields(dev, shape, dtype))
        before = mk.launches
        out = mk.momentum_rk4_fused(*fields, bc, **mkw)
        ref = momentum_core(*fields, bc, **mkw)
        assert mk.launches == before + 1
        if dtype == torch.float32:
            assert_close_f32(out, ref, 1e-5)
        else:
            assert_equal_to_plain(out, ref)
        # the force moved the result
        free = momentum_core(*fields, bc, **dict(mkw, f_ext_x=None,
                                                 f_ext_y=None))
        assert float((free[1] - ref[1]).abs().max()) > 0.0


CONTACT = dict(mu_s=1.0, kappa=0.0, rho_s=1.0, eta_s=0.0, mu_f=0.01,
               rho_f=1.0, w_t_cells=2.0, w_c_cells=3.0, k_rep=2.0,
               two_solid_clamp=4.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)


@pytest.mark.parametrize("override", [
    {}, dict(g_y=-1.0, rho_s=1.2), dict(eta_s=0.01), dict(phi_area_fix=True),
    dict(momentum_method="xla", use_pallas_rhs=True,
         projection_method="pallas"),
], ids=["contact", "gravity", "kelvin_voigt", "split", "both_switches"])
def test_contact_kernel_path_matches_plain_path(dev, override):
    """Three float64 steps of the head-on collision (touching contact
    bands, so the force acts from the first step) through the kernels and
    through the plain versions, within 1e-10; the kernel path launches
    the two-solid rmt_block (advext_block on the split tier) and
    momentum_rk4 with the force (the one-RHS kernel with it) every step."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0),
                       **dict(CONTACT, **override))
    kw = dict(dtype=torch.float64, device=dev)
    bc = pt.free_slip_box_bc
    step_k = pt.make_step(cfg, bc, TWO_DISCS, **kw)
    step_p = pt.make_step(
        cfg, bc, TWO_DISCS, **kw, rmt_block_impl=rb.rmt_block_plain,
        momentum_rk4_impl=momentum_core, advext_impl=rb.advext_block_plain,
        momentum_rhs_impl=velocity_rhs_blended,
        projection_stencils_impl=(ps.rc_rhs_plain, ps.grad_correct_plain))
    X, _ = cfg.grid.coords(**kw)
    s_k = s_p = pt.make_init_state(cfg, TWO_DISCS,
                                   u0=0.3 * torch.tanh((0.52 - X) * 8.0), **kw)
    before = (rb.launches, rb.advext_launches, mk.launches, mr.launches)
    for _ in range(3):
        s_k, aux = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    split, rhs = cfg.phi_area_fix, cfg.use_pallas_rhs
    assert (rb.launches, rb.advext_launches, mk.launches, mr.launches) == (
        before[0] + (0 if split else 3), before[1] + (3 if split else 0),
        before[2] + (0 if rhs else 3), before[3] + (12 if rhs else 0))
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert float((getattr(s_k, k) - getattr(s_p, k)).abs().max()) <= 1e-10
    f = pt.external_forces(aux["phis"], None, cfg.grid.dx, cfg.grid.dy,
                           gamma=0.0, k_rep=cfg.k_rep, w_c=cfg.w_c,
                           w_t=cfg.w_t)
    assert float(f[0].abs().max()) > 0.0  # the contact force acts


# The periodic instantiation of momentum_rk4: overlap-consistent inputs
# (the last row and column repeat the first), as the step gives them.

def overlap(f):
    """f with column Nx-1 set to column 0, then row Ny-1 to row 0."""
    f = f.clone()
    f[:, -1] = f[:, 0]
    f[-1, :] = f[0, :]
    return f


def periodic_inputs(dev, shape, dtype=torch.float64, force=False):
    """momentum_inputs' nine fields (and force_fields' force) made
    overlap-consistent, with the keywords of a periodic call."""
    cfg, fields, dt = momentum_inputs(dev, shape, dtype)
    fields = tuple(overlap(f) for f in fields)
    mkw = dict(eta_s=0.01, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
               mu_f=cfg.mu_f, periodic=True)
    if force:
        mkw.update({k: overlap(f) for k, f in
                    force_fields(dev, shape, dtype).items()})
    return fields, mkw


def periodic_call(dev, shape, dtype):
    """(momentum_rk4_fused, its arguments, its keywords) on the periodic
    box."""
    fields, mkw = periodic_inputs(dev, shape, dtype)
    return mk.momentum_rk4_fused, (*fields, pt.periodic_bc), mkw


@pytest.mark.parametrize("shape", SHAPES + [(129, 129), (300, 9)])
@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("force", [False, True], ids=["free", "force"])
def test_periodic_momentum_kernel_matches_plain(dev, force, eta_s, shape):
    """The periodic instantiation, one launch, bit for bit with the plain
    periodic update in float64 and to 1e-5 of max(1, |plain|) in float32,
    on grids narrower than its 8-cell halo too (an index wraps more than
    once there)."""
    for dtype in DTYPES:
        fields, mkw = periodic_inputs(dev, shape, dtype, force)
        mkw["eta_s"] = eta_s
        before = (mk.launches, mk.periodic_launches)
        out = mk.momentum_rk4_fused(*fields, pt.periodic_bc, **mkw)
        ref = momentum_core(*fields, pt.periodic_bc, **mkw)
        assert (mk.launches, mk.periodic_launches) == (before[0],
                                                       before[1] + 1)
        if dtype == torch.float32:
            assert_close_f32(out, ref, 1e-5)
        else:
            assert_equal_to_plain(out, ref)
        for o in out:  # the result is overlap-consistent
            assert torch.equal(o[-1], o[0]) and torch.equal(o[:, -1], o[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_periodic_kernel_reads_the_reduced_velocity(dev, dtype):
    """The wrapper's periodic_bc and the kernel's wrapped reads: a velocity
    that is not overlap-consistent gives the result of its reduced grid
    (rows and columns 0..N-2), as the plain update does after the BC."""
    fields, mkw = periodic_inputs(dev, (65, 65), dtype)
    u, v = fields[0].clone(), fields[1].clone()
    u[-1, :] += 1.0
    v[:, -1] -= 1.0
    out = mk.momentum_rk4_fused(u, v, *fields[2:], pt.periodic_bc, **mkw)
    ref = mk.momentum_rk4_fused(*fields, pt.periodic_bc, **mkw)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_periodic_kernel_raises_on_what_it_does_not_take(dev):
    fields, mkw = periodic_inputs(dev, (33, 33))
    with pytest.raises(ValueError):  # the flag without the periodic BC
        mk.momentum_rk4_fused(*fields, pt.noop_bc, **mkw)
    with pytest.raises(ValueError):  # the periodic BC without the flag
        mk.momentum_rk4_fused(*fields, pt.periodic_bc,
                              **dict(mkw, periodic=False))
    rho = fields[7]
    with pytest.raises(ValueError):  # the projection kernels take walls
        ps.grad_correct_fused(fields[2], fields[0], fields[1], rho,
                              mkw["dt"], 0.1, 0.1, pt.periodic_bc)
    assert not pt.projection_stencils_supported(pt.periodic_bc)


def tg_velocity(cfg, dev, amp=0.5):
    """bench.py --periodic's Taylor-Green seed, float64."""
    X, Y = cfg.grid.coords(dtype=torch.float64, device=dev)
    return (amp * torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y),
            -amp * torch.cos(2 * math.pi * X) * torch.sin(2 * math.pi * Y))


@pytest.mark.parametrize("case", ["periodic_flagship", "periodic_split",
                                  "lid_fluid", "tg_fluid", "tg_fluid_proj"])
def test_periodic_and_fluid_kernel_paths_match_plain_paths(dev, case):
    """Three float64 steps through the kernels and through the plain
    versions, within 1e-10: the flagship on the periodic box with its
    Taylor-Green seed (bench.py --periodic; also on the split tier), and
    with no solid the lid cavity and the periodic Taylor-Green vortex
    (also with projection_method='pallas', which the periodic box runs as
    plain ops). The kernel path launches momentum_rk4 every step, its
    periodic instantiation on the periodic box (and the solid block where
    there is a solid)."""
    grid = pt.Grid(N, N, 1.0, 1.0)
    kw = dict(dtype=torch.float64, device=dev)
    if case.startswith("periodic"):
        cfg = pt.RMTConfig(grid=grid, mu_s=0.1, eta_s=0.01, mu_f=0.01,
                           bc_type="periodic",
                           phi_area_fix=case.endswith("split"))
        solids, bc = (DISC,), pt.periodic_bc
        u0, v0 = tg_velocity(cfg, dev)
    elif case == "lid_fluid":
        cfg = pt.RMTConfig(grid=grid, mu_f=0.01, CFL=0.2, dt_min_cap=1e-2)
        solids, bc = (), pt.make_lid_bc(1.0)
        zero = torch.zeros(grid.shape, **kw)
        u0, v0 = bc(zero, zero)
    else:
        cfg = pt.RMTConfig(grid=grid, mu_f=0.01, CFL=0.3, dt_min_cap=1e-3,
                           bc_type="periodic",
                           projection_method=("pallas" if case.endswith("proj")
                                              else "auto"))
        solids, bc = (), pt.periodic_bc
        u0, v0 = tg_velocity(cfg, dev)
    step_k = pt.make_step(cfg, bc, solids, **kw)
    step_p = pt.make_step(cfg, bc, solids, **kw,
                          rmt_block_impl=rb.rmt_block_plain,
                          momentum_rk4_impl=momentum_core,
                          advext_impl=rb.advext_block_plain)
    s_k = s_p = pt.make_init_state(cfg, solids, u0=u0, v0=v0, **kw)
    def counts():
        return (rb.launches, rb.advext_launches, mk.launches,
                mk.periodic_launches, ps.rc_rhs_launches)

    before = counts()
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    torch.cuda.synchronize()
    fused = 3 if solids and not cfg.phi_area_fix else 0
    split = 3 if cfg.phi_area_fix else 0
    periodic = 3 if cfg.bc_type == "periodic" else 0
    assert counts() == (before[0] + fused, before[1] + split,
                        before[2] + 3 - periodic, before[3] + periodic,
                        before[4])
    for k in ("u", "v", "p", "X1", "X2", "t"):
        diff = getattr(s_k, k) - getattr(s_p, k)
        assert diff.numel() == 0 or float(diff.abs().max()) <= 1e-10, k
    assert float(s_k.u.abs().max()) > 0.1


# Bicubic sampling and the band-mode stress: the bicubic instantiations of
# both tile kernels (band-guarded and raw) and the band mode's runtime
# branch of rmt_block's post stage. The maps are bent by a smooth third of
# a cell: on the identity map (linear inside the solid) the bicubic and
# bilinear samples agree.

GUARDS = {"guarded": 3.0, "raw": None}


def bend(cfg, X1s, X2s):
    X, Y = cfg.grid.coords(dtype=torch.float64, device=X1s.device)
    h = cfg.grid.dx / 3
    b1 = h * torch.sin(3 * torch.pi * X) * torch.sin(2 * torch.pi * Y)
    b2 = h * torch.sin(3 * torch.pi * Y) * torch.sin(2 * torch.pi * X)
    return ((X1s + b1.to(X1s.dtype)).contiguous(),
            (X2s - b2.to(X2s.dtype)).contiguous())


def sample_kw(cfg, guard):
    g = GUARDS[guard]
    return dict(sl_interp="bicubic",
                sl_guard=None if g is None else g * max(cfg.grid.dx,
                                                        cfg.grid.dy))


def bicubic_block(dev, shape, dtype=torch.float64, disc=DISC,
                  guard="guarded"):
    """(rmt_block's arguments, its keywords) with the bicubic sample on the
    bent map."""
    cfg, args, kw = block_inputs(dev, shape, dtype, disc)
    args = [*args[:2], *bend(cfg, args[2], args[3]), args[4]]
    return args, dict(kw, **sample_kw(cfg, guard))


@pytest.mark.parametrize("guard", list(GUARDS))
@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_bicubic_kernel_matches_plain(dev, shape, disc, guard):
    """The fused tier's bicubic instantiation, one launch: float64 to 1e-11
    (bit for bit expected), float32 to 1e-4 of max(1, |plain|); the edge
    disc clips the stencil at the domain's edge."""
    for dtype in DTYPES:
        args, kw = bicubic_block(dev, shape, dtype, disc, guard)
        before = rb.launches
        out = rb.rmt_block_fused(*args, **kw)
        ref = rb.rmt_block_plain(*args, **kw)
        assert rb.launches == before + 1
        if dtype == torch.float32:
            assert_close_f32(out, ref, 1e-4)
        else:
            assert_equal_to_plain(out, ref)
    if shape == (64, 64):  # the sample is not the bilinear one
        bil = rb.rmt_block_plain(*args, **dict(kw, sl_interp="bilinear"))
        assert float((ref[0] - bil[0]).abs().max()) > 1e-6


def band_block(dev, shape, dtype=torch.float64, clamp=3.0):
    """(rmt_block's arguments, its keywords) in band mode (w_cut = w_t)
    with the clamp, on multi_call's squeezed map of one solid (det G down to
    ~0.1, so the clamp bites)."""
    args, kw = multi_call(dev, shape, dtype, (DISC,), clamp)
    return args, dict(kw, stress_w_cut=kw["w_t"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_band_kernel_matches_plain(dev, shape, dtype):
    """The band mode (stress_w_cut = w_t, clamp 3), one launch: float64 to
    1e-11, float32 to 1e-4 of max(1, |plain|)."""
    args, kw = band_block(dev, shape, dtype)
    before = rb.launches
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    assert rb.launches == before + 1
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


def test_rmt_block_band_mode_reaches_past_the_solid(dev):
    """The band mode stresses fluid cells within w_t of the interface
    (central differences), which the interior mode leaves at 0; its clamp
    holds J in [1/3, 3]; bit for bit with the plain version in both
    modes."""
    args, kw = band_block(dev, (64, 64))
    band = rb.rmt_block_fused(*args, **kw)
    interior = rb.rmt_block_fused(*args, **dict(kw, stress_w_cut=0.0,
                                                stress_clamp=0.0))
    assert_bit_for_bit(band, rb.rmt_block_plain(*args, **kw))
    phi, sxx, J = band[2][0], band[3][0], band[6][0]
    ring = (phi > 0.0) & (sxx != 0.0)
    assert bool(ring.any()) and float(interior[3][0][ring].abs().max()) == 0
    assert abs(float(J.max()) - 3.0) <= 1e-12
    assert abs(float(J.min()) - 1.0 / 3.0) <= 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["bicubic", "band"])
@pytest.mark.parametrize("case", ["contact", "three"])
def test_rmt_block_several_solids_bicubic_and_band(dev, case, mode, dtype):
    """S solids with the clamp and the bicubic sample (the kMulti bicubic
    instantiation), or in band mode: float64 to 1e-11, float32 to 1e-4."""
    args, kw = multi_call(dev, (96, 130), dtype, SOLID_CASES[case])
    if mode == "bicubic":
        cfg = pt.RMTConfig(grid=pt.Grid(130, 96, 1.0, 1.0))
        kw = dict(kw, **sample_kw(cfg, "guarded"))
    else:
        kw = dict(kw, stress_w_cut=kw["w_t"])
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers", [1, 7, 12])
def test_rmt_block_bicubic_takes_any_num_layers(dev, layers, dtype):
    """The bicubic instantiation on the smaller tiles and on the panels in
    the device-memory workspace, band mode on top."""
    args, kw = bicubic_block(dev, (65, 97), dtype, guard="raw")
    cfg, _, lkw = block_inputs(dev, (65, 97), dtype, num_layers=layers)
    kw = dict(kw, num_layers=layers, stress_w_cut=lkw["w_t"],
              stress_clamp=3.0)
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


def advext_bicubic(dev, shape, dtype=torch.float64, disc=DISC,
                   guard="guarded", solids=None):
    """(advext_block's arguments, its keywords) with the bicubic sample on
    the bent maps."""
    cfg, args = split_inputs(dev, shape, disc, dtype, solids)
    X1, X2 = bend(cfg, args[2], args[3])
    return ((*args[:2], X1, X2, *args[4:]),
            dict(dx=cfg.grid.dx, dy=cfg.grid.dy, num_layers=3,
                 **sample_kw(cfg, guard)))


@pytest.mark.parametrize("guard", list(GUARDS))
@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_advext_bicubic_kernel_matches_plain(dev, shape, disc, guard):
    """The split tier's bicubic instantiation (pre-pass and tile kernel):
    float64 to 1e-11, float32 to 1e-4 of max(1, |plain|)."""
    for dtype in DTYPES:
        args, kw = advext_bicubic(dev, shape, dtype, disc, guard)
        before = rb.advext_launches
        out = rb.advext_block_fused(*args, **kw)
        ref = rb.advext_block_plain(*args, **kw)
        assert rb.advext_launches == before + 1
        if dtype == torch.float32:
            assert_close_f32(out, ref, 1e-4)
        else:
            assert_equal_to_plain(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("guard", list(GUARDS))
def test_advext_bicubic_takes_two_solids(dev, guard, dtype):
    """Two solids share the backtrace; each takes its own guard from its
    own phi."""
    solids = (DISC, pt.Disc(0.25, 0.3, 0.12))
    args, kw = advext_bicubic(dev, (96, 130), dtype, guard=guard,
                              solids=solids)
    out = rb.advext_block_fused(*args, **kw)
    ref = rb.advext_block_plain(*args, **kw)
    if dtype == torch.float32:
        assert_close_f32(out, ref, 1e-4)
    else:
        assert_equal_to_plain(out, ref)


# a NaN in the map two cells outside the first 32 x 32 tile, far from the
# disc at (0.6, 0.5): the raw bicubic sample of a fluid cell next to it is
# NaN x 0 = NaN in the plain version
NAN_AT = (5, 33)


@pytest.mark.parametrize("what", ["X1_nan_2_out", "X2_inf_2_out", "u_nan",
                                  "X1_huge", "dt_nan"])
@pytest.mark.parametrize("guard", list(GUARDS))
def test_bicubic_tile_skips_are_exact_for_any_input(dev, guard, what):
    """Both kernels' bicubic skips: a non-finite map up to two cells beyond
    a tile's reach, a non-finite velocity or dt, or a map value whose
    bicubic sample could overflow send the tile down the full path, so the
    kernels give the plain versions' values and NaNs (the guard takes the
    bilinear sample at fluid cells, where NaN x 0 stays local)."""
    args, kw = bicubic_block(dev, (160, 160), guard=guard)
    sargs, skw = advext_bicubic(dev, (160, 160), guard=guard)
    u, v, X1, X2, dt = [a.clone() for a in args]
    su, sv, sX1, sX2, phis, sdt = [a.clone() for a in sargs]
    if what == "X1_nan_2_out":
        X1[(0, *NAN_AT)] = sX1[(0, *NAN_AT)] = float("nan")
    elif what == "X2_inf_2_out":
        X2[(0, *NAN_AT)] = sX2[(0, *NAN_AT)] = float("inf")
    elif what == "u_nan":
        u[NAN_AT] = su[NAN_AT] = float("nan")
    elif what == "X1_huge":  # finite; a Catmull-Rom sum of it may not be
        X1[(0, *NAN_AT)] = sX1[(0, *NAN_AT)] = 1e306
    else:
        dt = torch.full_like(dt, float("nan"))
        sdt = torch.full_like(sdt, float("nan"))
    for fn, plain, a, k in (
            (rb.rmt_block_fused, rb.rmt_block_plain, (u, v, X1, X2, dt), kw),
            (rb.advext_block_fused, rb.advext_block_plain,
             (su, sv, sX1, sX2, phis, sdt), skw)):
        out = fn(*a, **k)
        ref = plain(*a, **k)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=ATOL,
                                       equal_nan=True)


def between_floats(p, frac):
    """A double frac of the way from the float32 p to the next float32 up:
    the plain version's comparison with it rounds it to nearest."""
    nxt = float(np.nextafter(np.float32(p), np.float32(np.inf)))
    return float(p) + frac * (nxt - float(p))


@pytest.mark.parametrize("frac", [0.4, 0.6])
def test_thresholds_round_as_the_plain_versions(dev, frac):
    """The guard's -sl_guard and the band's w_cut are Python doubles that
    the plain versions compare with a float32 tensor, rounding them to the
    nearest float32. With the threshold between a cell's phi p and the next
    float32 up, 0.4 of the way rounds down to p (p < thr is false: the
    bilinear sample, out of the band) and 0.6 up (true: bicubic, in the
    band), in the kernels as in the plain versions, bit for bit."""
    dtype = torch.float32

    def cell_near(phi, target):
        return tuple(torch.nonzero(
            (phi - target).abs() == (phi - target).abs().min())[0].tolist())

    # the split tier's guard at a cell's given phi
    sargs, skw = advext_bicubic(dev, (64, 64), dtype)
    at = cell_near(sargs[4][0], -1.5 * skw["dx"])
    skw = dict(skw, sl_guard=-between_floats(float(sargs[4][0][at]), frac))
    out = rb.advext_block_fused(*sargs, **skw)
    assert_bit_for_bit(out, rb.advext_block_plain(*sargs, **skw))
    bil = rb.advext_block_plain(*sargs, **dict(skw, sl_interp="bilinear"))
    assert bool(out[0][0][at] != bil[0][0][at]) == (frac > 0.5)
    # the fused tier's guard at a cell's pre-advection phi, disc(X)
    args, kw = bicubic_block(dev, (64, 64), dtype)
    phi0 = DISC(args[2][0], args[3][0])
    at = cell_near(phi0, -1.5 * kw["dx"])
    kw = dict(kw, sl_guard=-between_floats(float(phi0[at]), frac))
    out = rb.rmt_block_fused(*args, **kw)
    assert_bit_for_bit(out, rb.rmt_block_plain(*args, **kw))
    bil = rb.rmt_block_plain(*args, **dict(kw, sl_interp="bilinear"))
    assert bool(out[0][0][at] != bil[0][0][at]) == (frac > 0.5)
    # the band's cut at a rebuilt phi in the band, outside the solid
    bargs, bkw = band_block(dev, (64, 64), dtype)
    ref = rb.rmt_block_plain(*bargs, **bkw)
    cells = torch.nonzero((ref[2][0] > 0) & (ref[3][0] != 0))
    at = tuple(cells[0].tolist())
    bkw = dict(bkw, stress_w_cut=between_floats(float(ref[2][0][at]), frac))
    out = rb.rmt_block_fused(*bargs, **bkw)
    assert_bit_for_bit(out, rb.rmt_block_plain(*bargs, **bkw))
    assert bool(out[3][0][at] != 0) == (frac > 0.5)


@pytest.mark.parametrize("override", [
    dict(sl_interp="bicubic"), dict(sl_interp="bicubic", sl_band_guard=0.0),
    dict(stress_band=True, num_layers=4),
    dict(sl_interp="bicubic", phi_area_fix=True),
    dict(sl_interp="bicubic", bc_type="periodic"),
    dict(stress_band=True, map_rebase_minj=10.0, num_layers=4),
], ids=["bicubic", "raw_bicubic", "band", "bicubic_split",
        "bicubic_periodic", "band_rebase"])
def test_bicubic_and_band_kernel_paths_match_plain_paths(dev, override):
    """Three float64 steps through the kernels and through the plain
    versions, within 1e-10, with the new modes on both tiers; the kernel
    path launches its solid block every step."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, **override)
    kw = dict(dtype=torch.float64, device=dev)
    periodic = cfg.bc_type == "periodic"
    bc = pt.periodic_bc if periodic else pt.make_lid_bc(1.0)
    u0, v0 = tg_velocity(cfg, dev) if periodic else (None, None)
    step_k = pt.make_step(cfg, bc, (DISC,), **kw)
    step_p = pt.make_step(cfg, bc, (DISC,), **kw,
                          rmt_block_impl=rb.rmt_block_plain,
                          momentum_rk4_impl=momentum_core,
                          advext_impl=rb.advext_block_plain,
                          extrap_impl=extrapolate_reference_map)
    s_k = s_p = pt.make_init_state(cfg, (DISC,), u0=u0, v0=v0, **kw)
    before = (rb.launches, rb.advext_launches)
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    split = pt.sim.rmt_block_split_eligible(cfg, 1)
    assert (rb.launches, rb.advext_launches) == (
        before[0] + (0 if split else 3), before[1] + (3 if split else 0))
    for k in ("u", "v", "p", "X1", "X2", "t", "phis0"):
        diff = (getattr(s_k, k) - getattr(s_p, k)).abs()
        assert diff.numel() == 0 or float(diff.max()) <= 1e-10, k


# The ellipse level set in the fused tier's kernel


ELLIPSE_MODES = {
    "bilinear": {},
    "bicubic": dict(sl_interp="bicubic", guard=True),
    "raw_bicubic": dict(sl_interp="bicubic"),
    "band": dict(band=True),
}


def ellipse_mode(cfg, mode):
    """The rmt_block keywords of an ELLIPSE_MODES entry: the final sample
    (the band guard 3 cells) and the stress mode (band: w_cut = w_t, the
    clamp 3)."""
    m = ELLIPSE_MODES[mode]
    kw = {}
    if "sl_interp" in m:
        kw["sl_interp"] = m["sl_interp"]
        kw["sl_guard"] = 3.0 * cfg.grid.dx if m.get("guard") else None
    if m.get("band"):
        kw.update(stress_w_cut=cfg.w_t, stress_clamp=3.0)
    return kw


def assert_bit_for_bit(out, ref):
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mode", list(ELLIPSE_MODES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ellipse", [ELLIPSE, EDGE_ELLIPSE],
                         ids=["ellipse", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_ellipse_kernel_matches_plain(dev, shape, ellipse, dtype,
                                                mode):
    """One solid shaped as an Ellipse: the kernel's S = 1 ellipse
    instantiations, bit for bit with the plain version in both types, in
    each final sample and stress mode, one launch."""
    cfg, args, kw = block_inputs(dev, shape, dtype, ellipse)
    args = list(args)
    X1 = args[2]
    args[2] = torch.where(X1 != 0, X1 + 0.15 * (args[3] - ellipse.y0), X1)
    kw = dict(kw, **ellipse_mode(cfg, mode))
    before = rb.launches
    out = rb.rmt_block_fused(*args, **kw)
    assert rb.launches == before + 1
    assert_bit_for_bit(out, rb.rmt_block_plain(*args, **kw))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "raw_bicubic"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rmt_block_disc_and_ellipse_match_plain(dev, shape, dtype, mode):
    """A disc and an ellipse in contact range, with the two-solid clamp:
    the S >= 2 instantiation taking each solid's shape at run time, bit
    for bit with the plain version."""
    args, kw = multi_call(dev, shape, dtype, DISC_AND_ELLIPSE)
    cfg = pt.RMTConfig(grid=pt.Grid(shape[1], shape[0], 1.0, 1.0))
    kw = dict(kw, **ellipse_mode(cfg, mode))
    out = rb.rmt_block_fused(*args, **kw)
    assert_bit_for_bit(out, rb.rmt_block_plain(*args, **kw))


@pytest.mark.parametrize("what", ["u_nan", "v_inf", "X1_nan", "X2_inf",
                                  "X1_huge", "dt_nan"])
@pytest.mark.parametrize("mode", ["bilinear", "raw_bicubic"])
def test_rmt_block_ellipse_tile_skip_is_exact_for_any_input(dev, mode,
                                                            what):
    """The skip reads the evaluated level set, whatever its shape: a
    non-finite (or huge) input far from the flat, clipped ellipse sends
    its tile down the full path, so the kernel gives the plain version's
    NaNs where that one does."""
    cfg, args, kw = block_inputs(dev, (N, N), torch.float64, EDGE_ELLIPSE)
    args = [a.clone() for a in args]
    u, v, X1, X2, dt = args
    at = (40, 50)  # far from the ellipse at (0.13, 0.78)
    if what == "u_nan":
        u[at] = float("nan")
    elif what == "v_inf":
        v[at] = float("inf")
    elif what == "X1_nan":
        X1[(0, *at)] = float("nan")
    elif what == "X2_inf":
        X2[(0, *at)] = float("inf")
    elif what == "X1_huge":
        X1[(0, *at)] = 1e300  # finite; the ellipse's r overflows
    else:
        args[4] = torch.full_like(dt, float("nan"))
    kw = dict(kw, **ellipse_mode(cfg, mode))
    out = rb.rmt_block_fused(*args, **kw)
    ref = rb.rmt_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_bit_for_bit(out, ref)


def lid_without_spec(u, v):
    """The lid BC without a kernel_spec, as a user would write it."""
    return pt.make_lid_bc(1.0)(u, v)


def rounded_square(X1, X2):
    qx = torch.clamp(torch.abs(X1 - 0.55) - 0.1, min=0.0)
    qy = torch.clamp(torch.abs(X2 - 0.5) - 0.1, min=0.0)
    inside = torch.clamp(torch.maximum(torch.abs(X1 - 0.55),
                                       torch.abs(X2 - 0.5)) - 0.1, max=0.0)
    return torch.sqrt(qx * qx + qy * qy) + inside - 0.05


PLAIN = dict(rmt_block_impl=rb.rmt_block_plain, momentum_rk4_impl=momentum_core,
             advext_impl=rb.advext_block_plain,
             projection_stencils_impl=(ps.rc_rhs_plain, ps.grad_correct_plain))


@pytest.mark.parametrize("projection", ["auto", "pallas"])
def test_bc_without_spec_steps_on_the_stage_loop(dev, projection):
    """F1: a BC without kernel_spec takes the plain RK4 stage loop and the
    plain projection stencils on a CUDA state, where the kernels would
    raise; three steps equal those of the lid BC with its spec through the
    plain versions."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, projection_method=projection)
    kw = dict(dtype=torch.float64, device=dev)
    step = pt.make_step(cfg, lid_without_spec, (DISC,), **kw)
    ref = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw, **PLAIN)
    assert step.paths["momentum"] == "stage loop"
    assert step.paths["projection"] == "stencils"
    s = s_ref = pt.make_init_state(cfg, (DISC,), **kw)
    before = (mk.launches, ps.grad_correct_launches, rb.launches)
    for _ in range(3):
        s, _ = step(s, 1.0)
        s_ref, _ = ref(s_ref, 1.0)
    assert (mk.launches, ps.grad_correct_launches) == before[:2]
    assert rb.launches == before[2] + 3
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert float((getattr(s, k) - getattr(s_ref, k)).abs().max()) <= 1e-10


def test_other_level_sets_step_on_the_split_tier(dev):
    """F2: a level set the fused kernel does not evaluate takes the split
    tier (advext_block's kernel) on a CUDA state; three steps equal the
    plain fused path's."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01)
    kw = dict(dtype=torch.float64, device=dev)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (rounded_square,), **kw)
    ref = pt.make_step(cfg, pt.make_lid_bc(1.0), (rounded_square,), **kw,
                       **PLAIN)
    assert step.paths["solid"] == "split" and ref.paths["solid"] == "fused"
    s = s_ref = pt.make_init_state(cfg, (rounded_square,), **kw)
    before = (rb.launches, rb.advext_launches)
    for _ in range(3):
        s, _ = step(s, 1.0)
        s_ref, _ = ref(s_ref, 1.0)
    assert (rb.launches, rb.advext_launches) == (before[0], before[1] + 3)
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert float((getattr(s, k) - getattr(s_ref, k)).abs().max()) <= 1e-10
    ell = pt.make_step(cfg, pt.make_lid_bc(1.0), (ELLIPSE,), **kw)
    assert ell.paths["solid"] == "fused"


def test_cg_count_on_the_card_equals_the_cpu_run(dev):
    """The variable-density step's CG on the card stops at the iteration
    the plain float64 run on the CPU stops at, from the same state, and
    the two agree to roundoff; the stopping test is read on the host once
    every CG_READ_EVERY iterations."""
    from pyrmt_tpu_torch.ops import poisson
    from pyrmt_tpu_torch.validation import (
        DENSITY_DISC,
        density_contrast_config,
    )

    cfg = density_contrast_config(64)
    kw = dict(dtype=torch.float64)
    step = pt.make_step(cfg, pt.free_slip_box_bc, (DENSITY_DISC,),
                        device=dev, **kw)
    s = pt.make_init_state(cfg, (DENSITY_DISC,), device=dev, **kw)
    for _ in range(5):
        s, _ = step(s, 1.0)
    cpu_step = pt.make_step(cfg, pt.free_slip_box_bc, (DENSITY_DISC,),
                            device="cpu", **kw)
    s_cpu = pt.state_from_numpy(pt.state_to_numpy(s), device="cpu", **kw)
    poisson.cg_host_reads = 0
    s_gpu, aux = step(s, 1.0)
    reads = poisson.cg_host_reads
    s_cpu, aux_cpu = cpu_step(s_cpu, 1.0)
    it = int(aux["cg_iters"])
    assert it == int(aux_cpu["cg_iters"]) > 0
    assert reads == -(-it // poisson.CG_READ_EVERY)
    for k in ("u", "v", "p"):
        ref = getattr(s_cpu, k)
        err = float((getattr(s_gpu, k).cpu() - ref).abs().max())
        assert err <= 1e-10 * max(1.0, float(ref.abs().max())), k


# the general tier (WENO5, central2, the gather path; CFL 1.5 as the
# timestep's caps let it through): flagship overrides
GENERAL = {"weno5": dict(scheme="weno5"),
           "central2": dict(scheme="central2"),
           "gather": dict(sl_local=False),
           "gather_cfl": dict(CFL=1.5, mu_f=1e-4, mu_s=0.01, kappa=1.0,
                              eta_s=0.0, dt_min_cap=1.0)}


def general_case(dev, case, dtype, n=N):
    """The flagship with the general tier's ``case`` and a swirl, so that
    the map moves from the first step."""
    fields = dict(dict(mu_s=0.1, eta_s=0.01, mu_f=0.01), **GENERAL[case])
    cfg = pt.RMTConfig(grid=pt.Grid(n, n, 1.0, 1.0), **fields)
    X, Y = cfg.grid.coords(dtype=dtype, device=dev)
    amp = 1.0 if case == "gather_cfl" else 0.5
    s = pt.make_init_state(
        cfg, (DISC,), u0=amp * torch.sin(math.pi * X) * torch.cos(math.pi * Y),
        v0=-amp * torch.cos(math.pi * X) * torch.sin(math.pi * Y),
        dtype=dtype, device=dev)
    return cfg, s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(GENERAL))
def test_general_kernel_path_matches_plain_path(dev, case, dtype):
    """Three general-tier steps through the kernels (extrapolate_fused once
    per solid, momentum_rk4 once a step, no solid block) against the plain
    path on the card: float64 to 1e-11, float32 to 1e-5 (u, v, p) and
    1e-4 (the maps) of max(1, |plain|)."""
    cfg, s = general_case(dev, case, dtype)
    kw = dict(dtype=dtype, device=dev)
    step_k = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw)
    step_p = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                          momentum_rk4_impl=momentum_core,
                          extrap_impl=extrapolate_reference_map)
    assert step_k.paths["solid"] == "general"
    before = (rb.launches, rb.advext_launches, ef.launches, mk.launches)
    s_k = s_p = s
    for _ in range(3):
        s_k, _ = step_k(s_k, 1.0)
        s_p, _ = step_p(s_p, 1.0)
    assert (rb.launches, rb.advext_launches, ef.launches, mk.launches) == (
        before[0], before[1], before[2] + 3, before[3] + 3)
    for k in ("u", "v", "p", "X1", "X2"):
        out, ref = getattr(s_k, k), getattr(s_p, k)
        if dtype == torch.float64:
            assert float((out - ref).abs().max()) <= ATOL, k
        else:
            assert_close_f32([out], [ref], 1e-4 if k[0] == "X" else 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(GENERAL))
def test_extrapolate_fused_on_general_tier_maps(dev, case, dtype):
    """extrapolate_fused equals its plain version bit for bit on the masked
    maps and level sets that a general-tier step hands it."""
    cfg, s = general_case(dev, case, dtype, n=96)
    seen = []

    def record(X1, X2, phi, dx, dy, layers):
        seen.append((X1, X2, phi, dx, dy, layers))
        return extrapolate_reference_map(X1, X2, phi, dx, dy, layers)

    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), dtype=dtype,
                        device=dev, momentum_rk4_impl=momentum_core,
                        extrap_impl=record)
    for _ in range(2):
        s, _ = step(s, 1.0)
    assert len(seen) == 2
    for args in seen:
        assert_bit_for_bit(ef.extrapolate_reference_map_fused(*args),
                           extrapolate_reference_map(*args))


@pytest.mark.parametrize("case", list(GENERAL))
def test_general_step_does_not_wait_for_the_card(dev, case):
    cfg, s = general_case(dev, case, torch.float32)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,),
                        dtype=torch.float32, device=dev)
    s, _ = step(s, 1.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, aux = step(s, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(s.u).all()) and aux["J"].shape == (1, N, N)


# The kernels' gradient: every CUDA entry point is an autograd.Function
# whose backward is its plain version's autograd (kernels/_autograd.py)

PLAIN_IMPLS = dict(rmt_block_impl=rb.rmt_block_plain,
                   momentum_rk4_impl=momentum_core,
                   advext_impl=rb.advext_block_plain,
                   extrap_impl=extrapolate_reference_map,
                   momentum_rhs_impl=velocity_rhs_blended,
                   projection_stencils_impl=(ps.rc_rhs_plain,
                                             ps.grad_correct_plain))


def grad_calls(dev, dtype, n=256):
    """{entry point: (wrapper, plain version, args, kwargs)} on the
    flagship's fields at n x n, the force and the periodic BC's modes of
    the RK4 update among them."""
    cfg, args, kw = block_inputs(dev, (n, n), dtype)
    u, v, X1, X2, dt = args
    blk = rb.rmt_block_plain(*args, **kw)
    X1e, X2e, phis, Hf, rho = blk[0], blk[1], blk[2], blk[7], blk[8]
    sxx, sxy, syy = blk[9:]
    mkv = (phis[0] <= 0.0).to(dtype) * (1.0 - Hf)
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    p = t(0.05 * rng.standard_normal((n, n)))
    fx, fy = t(rng.standard_normal((2, n, n)))
    g = cfg.grid
    mom = dict(eta_s=0.01, dx=g.dx, dy=g.dy, dt=dt / 20, mu_f=cfg.mu_f)
    fields = (u, v, p, sxx, sxy, syy, Hf, rho, mkv)
    lid = pt.make_lid_bc(1.0)
    d_scalar = dt / torch.mean(rho)
    return {
        "rmt_block": (rb.rmt_block_fused, rb.rmt_block_plain, args, kw),
        "advext_block": (rb.advext_block_fused, rb.advext_block_plain,
                         (u, v, X1, X2, phis, dt),
                         dict(dx=g.dx, dy=g.dy, num_layers=3)),
        "momentum_rk4": (mk.momentum_rk4_fused, momentum_core,
                         (*fields, lid), mom),
        "momentum_rk4, force": (mk.momentum_rk4_fused, momentum_core,
                                (*fields, lid),
                                dict(mom, f_ext_x=fx, f_ext_y=fy)),
        # the wrapper applies periodic_bc to (u, v) before the update, and
        # equals the plain update on overlap-consistent fields
        "momentum_rk4, periodic": (
            mk.momentum_rk4_fused,
            lambda u, v, *rest, **k: momentum_core(*pt.periodic_bc(u, v),
                                                   *rest, **k),
            (*pt.periodic_bc(u, v), *(overlap_consistent(f)
                                      for f in fields[2:]), pt.periodic_bc),
            dict(mom, periodic=True)),
        "extrapolate_fused": (ef.extrapolate_reference_map_fused,
                              extrapolate_reference_map,
                              (X1e[0] * (phis[0] <= 0.0), X2e[0], phis[0],
                               g.dx, g.dy, 3), {}),
        "rc_rhs": (ps.rc_rhs_fused, ps.rc_rhs_plain,
                   (u, v, p, rho, dt, d_scalar, g.dx, g.dy), {}),
        "grad_correct": (ps.grad_correct_fused, ps.grad_correct_plain,
                         (p, u, v, rho, dt, g.dx, g.dy, lid), {}),
        "velocity_rhs": (mr.velocity_rhs_blended_fused, velocity_rhs_blended,
                         (u, v, p, sxx, sxy, syy, g.dx, g.dy, cfg.mu_f, Hf,
                          rho, fx, fy), {}),
    }


def overlap_consistent(f):
    """f with its last row and column copied from its first: a field of
    the doubly-periodic overlap grid."""
    f = f.clone()
    f[-1, :] = f[0, :]
    f[:, -1] = f[:, 0]
    return f


# The gradient through the kernels' Functions and the plain path's differ
# only in the order in which autograd sums an input's contributions (the
# Function sums the twin's before autograd adds them to the others'): on
# the card 1e-15 to 5e-12 relative, reproducibly, on these losses.
GRAD_RTOL = 1e-10

GRAD_CALLS = ["rmt_block", "advext_block", "momentum_rk4",
              "momentum_rk4, force", "momentum_rk4, periodic",
              "extrapolate_fused", "rc_rhs", "grad_correct", "velocity_rhs"]


def input_grads(fn, args, kwargs):
    """The outputs of fn on fresh leaves of every float tensor argument,
    and their gradients of a seeded weighted sum of the outputs."""
    def leaf(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.detach().clone().requires_grad_(True)
        return a
    args = [leaf(a) for a in args]
    kwargs = {k: leaf(a) for k, a in kwargs.items()}
    out = fn(*args, **kwargs)
    outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    rng = np.random.default_rng(1)
    loss = sum(torch.sum(o * torch.tensor(rng.standard_normal(o.shape),
                                          dtype=o.dtype, device=o.device))
               for o in outs)
    ins = [a for a in (*args, *kwargs.values())
           if isinstance(a, torch.Tensor) and a.requires_grad]
    return outs, torch.autograd.grad(loss, ins, allow_unused=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", GRAD_CALLS)
def test_kernel_gradients_are_the_plain_twins(dev, name, dtype):
    """Each wrapper with inputs that require a gradient: its outputs are
    the kernel's (one launch, a _KernelFunction node) and its input
    gradients those of the plain version's autograd, bit for bit; the
    backward launches nothing."""
    wrapper, plain, args, kwargs = grad_calls(dev, dtype)[name]
    counters = lambda: [v for m in (rb, mk, ef, ps, mr) for k, v in
                        sorted(vars(m).items()) if k.endswith("launches")]
    n0 = counters()
    outs, grads = input_grads(wrapper, args, kwargs)
    n1 = counters()
    assert sum(n1) - sum(n0) == 1
    assert all(type(o.grad_fn).__name__.startswith("_KernelFunction")
               for o in outs)
    ref_outs, ref_grads = input_grads(plain, args, kwargs)
    assert counters() == n1
    outs = [o.detach() for o in outs]
    ref_outs = [o.detach() for o in ref_outs]
    if dtype == torch.float64:
        assert_equal_to_plain(outs, ref_outs)
    else:
        assert_close_f32(outs, ref_outs, 1e-4)
    assert any(r is not None and bool(torch.any(r != 0)) for r in ref_grads)
    for g, r in zip(grads, ref_grads):
        assert (g is None) == (r is None)
        if r is not None:
            assert torch.equal(g, r)


def flagship_loss(dev, step, n_steps=3, N=128):
    """L = sum(u^2 + v^2) + sum(p^2) after n_steps steps of the N x N
    flagship from a seeded swirl, and (L, mu_s, the velocity factor)."""
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01)
    s = pt.make_init_state(cfg, (DISC,), dtype=torch.float64, device=dev)
    X, Y = cfg.grid.coords(dtype=torch.float64, device=dev)
    mu = torch.tensor(0.1, dtype=torch.float64, device=dev,
                      requires_grad=True)
    sc = torch.tensor(1.0, dtype=torch.float64, device=dev,
                      requires_grad=True)
    s.u = 0.3 * sc * torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    s.v = -0.2 * sc * torch.sin(2 * math.pi * X) * torch.sin(math.pi * Y)
    for _ in range(n_steps):
        s, _ = step(s, 1.0, {"mu_s": mu})
    return torch.sum(s.u ** 2 + s.v ** 2) + torch.sum(s.p ** 2), mu, sc


def test_flagship_gradient_through_the_kernels_is_the_plain_paths(dev):
    """F5: on the card a step's outputs lost every dependence through a
    kernel, so d/d(mu_s) of a rollout through the kernels was silently
    cut. It equals the plain path's on the card (N=128 float64, 3 steps;
    GRAD_RTOL: the sums' order) and is nonzero."""
    cfg = pt.RMTConfig(grid=pt.Grid(128, 128, 1.0, 1.0), mu_s=0.1,
                       eta_s=0.01, mu_f=0.01)
    kw = dict(dtype=torch.float64, device=dev, traced_params=("mu_s",))
    step_k = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw)
    step_p = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                          **PLAIN_IMPLS)
    rb.launches = 0
    L_k, mu_k, sc_k = flagship_loss(dev, step_k)
    g_k = torch.autograd.grad(L_k, (mu_k, sc_k))
    assert rb.launches == 3
    L_p, mu_p, sc_p = flagship_loss(dev, step_p)
    g_p = torch.autograd.grad(L_p, (mu_p, sc_p))
    assert float(L_k) == float(L_p)
    for a, b in zip(g_k, g_p):
        assert float(b) != 0.0 and bool(torch.isfinite(a))
        assert abs(float(a) - float(b)) <= GRAD_RTOL * abs(float(b))


def test_diff_step_on_the_card_matches_make_rollout(dev):
    """make_diff_rollout (kernel forward, plain twin backward) against
    make_rollout through the kernels' Functions: the same gradient, and
    a backward that launches no kernel."""
    cfg = pt.RMTConfig(grid=pt.Grid(128, 128, 1.0, 1.0), mu_s=0.1,
                       eta_s=0.01, mu_f=0.01)
    kw = dict(dtype=torch.float64, device=dev)
    dstep = pt.make_diff_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                              param_names=("mu_s",))
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (DISC,), **kw,
                        traced_params=("mu_s",))
    droll = pt.make_diff_rollout(dstep, 3, with_params=True)
    roll = pt.make_rollout(step, 3)
    rb.launches = mk.launches = 0
    L_d, mu_d, sc_d = flagship_loss(dev, lambda s, t, p: (droll(s, t, p),
                                                          None), n_steps=1)
    assert rb.launches == mk.launches == 3
    g_d = torch.autograd.grad(L_d, (mu_d, sc_d))
    assert rb.launches == mk.launches == 3
    L_r, mu_r, sc_r = flagship_loss(dev, lambda s, t, p: (roll(s, t, p),
                                                          None), n_steps=1)
    g_r = torch.autograd.grad(L_r, (mu_r, sc_r))
    # make_rollout's checkpoint recomputes each step's forward, kernels
    # included
    assert rb.launches == mk.launches == 9
    assert float(L_d) == float(L_r)
    for a, b in zip(g_d, g_r):
        assert abs(float(a) - float(b)) <= GRAD_RTOL * abs(float(b))


# The sharding offsets (parallel/sharding.py): each block of a mesh,
# padded by its exchange halo with zeros beyond the domain, through the
# kernel with its offsets. Square and ragged grids (204 x 300: blocks of
# 102 x 75 and 51 x 300 against the tiles' 32 and 48), the disc inside the
# domain (the edge tiles skip) and clipped by its edge.
OFFSET_SHAPES = [(64, 64), (204, 300)]
OFFSET_MESHES = [(2, 2), (4, 1), (1, 4), (2, 4)]


def offset_case(dev, kernel, shape, disc, dtype):
    """(kernel call, plain call, whole fields, halo, float32 bound): each
    call ``call(*fields, **offsets)``."""
    _, args, kw = block_inputs(dev, shape, dtype, disc)
    if kernel == "rmt_block":
        return (lambda *f, **o: rb.rmt_block_fused(*f, args[4], **kw, **o),
                lambda *f, **o: rb.rmt_block_plain(*f, args[4], **kw, **o),
                list(args[:4]), 16, 1e-4)
    if kernel == "advext_block":
        phis = disc(args[2][0], args[3][0])[None].contiguous()
        akw = dict(dx=kw["dx"], dy=kw["dy"], num_layers=kw["num_layers"])
        return (lambda *f, **o: rb.advext_block_fused(*f, args[4], **akw,
                                                       **o),
                lambda *f, **o: rb.advext_block_plain(*f, args[4], **akw,
                                                       **o),
                list(args[:4]) + [phis], 16, 1e-4)
    cfg, fields, dt = momentum_inputs(dev, shape, dtype)
    mkw = dict(eta_s=0.01, dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
               mu_f=cfg.mu_f)
    bc = pt.free_slip_box_bc
    return (lambda *f, **o: mk.momentum_rk4_fused(*f, bc, **mkw, **o),
            lambda *f, **o: momentum_core(*f, bc, **mkw, **o),
            list(fields), 8, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("disc", [DISC, EDGE_DISC], ids=["disc", "edge"])
@pytest.mark.parametrize("shape", OFFSET_SHAPES)
@pytest.mark.parametrize("kernel", ["rmt_block", "advext_block",
                                    "momentum_rk4"])
def test_offsets_stitched_slabs_equal_the_unsharded_kernel(
        dev, kernel, shape, disc, dtype):
    """The kernel's blocks stitched equal the unsharded kernel bit for bit;
    each slab equals its plain twin with the same offsets (0 at the cut's
    stale cells and beyond the domain in both)."""
    from pyrmt_tpu_torch.parallel.sharding import Mesh, slab_of

    kern, plain, fields, halo, rel = offset_case(dev, kernel, shape, disc,
                                                 dtype)

    def outs(o):
        return (o,) if isinstance(o, torch.Tensor) else tuple(o)

    whole = outs(kern(*fields))
    counter = "offset_launches" if kernel != "advext_block" else \
        "advext_offset_launches"
    mod = mk if kernel == "momentum_rk4" else rb
    for mesh in OFFSET_MESHES:
        for iy in range(mesh[0]):
            for ix in range(mesh[1]):
                slabs = [slab_of(f, mesh, (iy, ix), halo) for f in fields]
                offs = slabs[0][1]
                before = getattr(mod, counter)
                ko = outs(kern(*(a for a, _ in slabs), **offs))
                assert getattr(mod, counter) == before + 1
                po = outs(plain(*(a for a, _ in slabs), **offs))
                torch.cuda.synchronize()
                m = Mesh(mesh, (iy, ix))
                rows, cols = m.block(*shape)
                for k, p, w in zip(ko, po, whole):
                    assert torch.equal(m.unpad(k, halo), w[..., rows, cols])
                    scale = (1.0 if dtype == torch.float64
                             else rel * max(1.0, float(p.abs().max())))
                    bound = ATOL if dtype == torch.float64 else scale
                    assert float((k - p).abs().max()) <= bound


def test_kernels_launch_inside_their_tensors_device(dev, monkeypatch):
    """Every launch enters ``torch.cuda.device`` of its tensors' device
    (the launchers run on the current device), and runs there."""
    real = torch.cuda.device
    seen = []

    class Recording:
        def __init__(self, device):
            self.inner = real(device)
            self.device = torch.device(device)

        def __enter__(self):
            self.inner.__enter__()
            seen.append((self.device, torch.cuda.current_device()))

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    _, args, kw = block_inputs(dev, (64, 64))
    cfg, fields, dt = momentum_inputs(dev, (64, 64))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device", Recording)
        rb.rmt_block_fused(*args, **kw)
        mk.momentum_rk4_fused(*fields, pt.free_slip_box_bc, eta_s=0.0,
                              dx=cfg.grid.dx, dy=cfg.grid.dy, dt=dt,
                              mu_f=cfg.mu_f)
    torch.cuda.synchronize()
    assert len(seen) == 2
    assert all(d == dev and cur == dev.index for d, cur in seen)


def test_sharded_pure_fluid_step_launches_the_rk4_kernel(dev):
    """A pure-fluid sharded step (no solid, so no solid-block kernel) on
    the card takes the RK4 kernel's offset instantiation once a step on
    every rank, and matches the single-process step: a gloo world of 2
    ranks sharing the card, the (1, 2) mesh."""
    from pyrmt_tpu_torch.parallel.launch import run_world

    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                       mu_f=0.01, rho_s=1.0, num_layers=3, CFL=0.2,
                       dt_min_cap=1e-3)
    bc, steps = pt.make_lid_bc(1.0), 3
    r = run_world(2, "pyrmt_tpu_torch.parallel.launch:run_sharded", dict(
        cases=[dict(cfg=cfg, velocity_bc=bc, phi_inits=(), steps=steps,
                    dtype=torch.float64, device="cuda", mesh_shape=(1, 2))]),
        backend="gloo")[0][0]
    assert r["paths"]["momentum"].startswith("rk4 kernel")
    for launches in r["launches"]:
        assert launches["momentum_rk4.offset_launches"] == steps
        assert launches["momentum_rk4.launches"] == 0
        assert launches["rmt_block.offset_launches"] == 0
    step = pt.make_step(cfg, bc, (), dtype=torch.float64, device=dev)
    ref = pt.make_init_state(cfg, (), dtype=torch.float64, device=dev)
    t_end = torch.tensor(1.0, dtype=torch.float64, device=dev)
    for _ in range(steps):
        ref, _ = step(ref, t_end)
    for k in ("u", "v", "p"):
        want = getattr(ref, k).cpu().numpy()
        assert np.abs(r["state"][k] - want).max() <= 1e-10, k
    assert r["state"]["X1"].shape == (0, N, N)


def advext_sharded_rank(shape, mesh_shape, dtype):
    """A rank body (``launch.run_world``; the test puts this file's
    directory on the ranks' path): ``make_advext_block_sharded`` on this
    rank's block of ``block_inputs``' fields, whose halo the ranks
    exchange; returns the gathered results and the rank's launches of the
    offset instantiation."""
    from pyrmt_tpu_torch.parallel.sharding import (
        make_advext_block_sharded,
        make_mesh,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    _, args, kw = block_inputs(dev, shape, dtype)
    phis = DISC(args[2][0], args[3][0])[None].contiguous()
    mesh = make_mesh(shape=mesh_shape)
    rows, cols = mesh.block(*shape)
    impl = make_advext_block_sharded(mesh, *shape, kw["num_layers"])
    rb.advext_offset_launches = 0
    outs = impl(*(f[..., rows, cols].contiguous()
                  for f in (*args[:4], phis)), args[4], dx=kw["dx"],
                dy=kw["dy"], num_layers=kw["num_layers"])
    torch.cuda.synchronize()
    return ([mesh.gather(o).cpu() for o in outs], rb.advext_offset_launches)


def _run_on_ranks(n, target, kwargs):
    """run_world with this file's directory on the ranks' path."""
    import os
    from pathlib import Path

    from pyrmt_tpu_torch.parallel.launch import run_world

    here = str(Path(__file__).resolve().parent)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (here, old) if p)
    try:
        return run_world(n, target, kwargs, backend="gloo")
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_advext_block_sharded_stitches_to_the_unsharded_kernel(dev, dtype):
    """``make_advext_block_sharded`` on the (2, 2) blocks of a 64 x 64
    field, its halo exchanged by 4 ranks sharing the card (gloo): the
    blocks gathered equal the unsharded advext_block kernel bit for bit,
    and each rank launches the offset instantiation once."""
    shape = (N, N)
    results = _run_on_ranks(4, "test_torch_cuda:advext_sharded_rank",
                            dict(shape=shape, mesh_shape=(2, 2),
                                 dtype=dtype))
    _, args, kw = block_inputs(dev, shape, dtype)
    phis = DISC(args[2][0], args[3][0])[None].contiguous()
    whole = rb.advext_block_fused(*args[:4], phis, args[4], dx=kw["dx"],
                                  dy=kw["dy"], num_layers=kw["num_layers"])
    for outs, launches in results:
        assert launches == 1
        for got, want in zip(outs, whole):
            assert torch.equal(got, want.cpu())


def test_sharded_split_step_launches_advext_block(dev):
    """A sharded split-tier step (the area fix with PDE reinit) on the
    card names the advext_block kernel in its paths, launches its offset
    instantiation once a step on every rank, and matches the
    single-process step: 4 ranks sharing the card, the (2, 2) mesh."""
    from pyrmt_tpu_torch.parallel.launch import run_world

    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.05, mu_f=0.01,
                       phi_area_fix=True, reinit_method="pde")
    bc, steps = pt.make_lid_bc(1.0), 3
    r = run_world(4, "pyrmt_tpu_torch.parallel.launch:run_sharded", dict(
        cases=[dict(cfg=cfg, velocity_bc=bc, phi_inits=(DISC,), steps=steps,
                    dtype=torch.float64, device="cuda", mesh_shape=(2, 2))]),
        backend="gloo")[0][0]
    assert r["paths"]["solid"] == ("split, advext_block kernel on slabs "
                                   "with offsets")
    for launches in r["launches"]:
        assert launches["rmt_block.advext_offset_launches"] == steps
        assert launches["rmt_block.advext_launches"] == 0
        assert launches["rmt_block.offset_launches"] == 0
        assert launches["momentum_rk4.offset_launches"] == steps
    step = pt.make_step(cfg, bc, (DISC,), dtype=torch.float64, device=dev)
    ref = pt.make_init_state(cfg, (DISC,), dtype=torch.float64, device=dev)
    for _ in range(steps):
        ref, _ = step(ref, 1.0)
    for k, tol in (("u", 1e-10), ("v", 1e-10), ("p", 1e-10), ("X1", 1e-11),
                   ("X2", 1e-11)):
        want = getattr(ref, k).cpu().numpy()
        assert np.abs(r["state"][k] - want).max() <= tol, k


def test_sharded_capillary_drop_launches_the_ellipse_offsets(dev):
    """The sharded capillary drop (the ellipse, gamma 0.1, the balanced
    CSF, free slip) on the card: the fused tier's rmt_block launches its
    ellipse offset instantiation and momentum_rk4 its force offset
    instantiation once a step on every rank; the split tier (the cell CSF,
    kappa*, the area fix) advext_block's offsets; both match the
    single-process step: 4 ranks sharing the card, the (2, 2) mesh."""
    from pyrmt_tpu_torch.parallel.launch import run_world

    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=1e-3, mu_f=1e-3,
                       gamma=0.1, st_method="balanced", CFL=0.4)
    split = dataclasses.replace(cfg, st_method="csf",
                                st_kappa_interface=True, phi_area_fix=True)
    ell, bc, steps = (pt.Ellipse(0.5, 0.5, 0.23, 0.174),
                      pt.free_slip_box_bc, 3)
    cases = [dict(cfg=c, velocity_bc=bc, phi_inits=(ell,), steps=steps,
                  dtype=torch.float64, device="cuda", mesh_shape=(2, 2))
             for c in (cfg, split)]
    runs = run_world(4, "pyrmt_tpu_torch.parallel.launch:run_sharded",
                     dict(cases=cases), backend="gloo")[0]
    for c, r in zip((cfg, split), runs):
        fused = c is cfg
        assert r["paths"]["solid"] == (
            "fused, kernel on slabs with offsets" if fused else
            "split, advext_block kernel on slabs with offsets")
        assert r["paths"]["momentum"] == "rk4 kernel on slabs with offsets"
        for launches in r["launches"]:
            assert launches["rmt_block.offset_launches"] == (
                steps if fused else 0)
            assert launches["rmt_block.advext_offset_launches"] == (
                0 if fused else steps)
            assert launches["momentum_rk4.offset_launches"] == steps
            assert launches["rmt_block.launches"] == 0
            assert launches["momentum_rk4.launches"] == 0
        step = pt.make_step(c, bc, (ell,), dtype=torch.float64, device=dev)
        ref = pt.make_init_state(c, (ell,), dtype=torch.float64, device=dev)
        for _ in range(steps):
            ref, _ = step(ref, 1.0)
        for k, tol in (("u", 1e-10), ("v", 1e-10), ("p", 1e-10),
                       ("X1", 1e-11), ("X2", 1e-11)):
            want = getattr(ref, k).cpu().numpy()
            assert np.abs(r["state"][k] - want).max() <= tol, k


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (1, 4), (2, 4)])
def test_dct_block_products_round_as_the_whole_solve(dev, mesh):
    """The distributed DCT solve's products of a rank's rows of C_y and
    C_x (``ops.poisson._block_products``: cuBLASLt) equal the rows of the
    single-device solve's whole products bit for bit at N=2048 float32,
    the size of chip_smoke's float32 sharded runs."""
    from pyrmt_tpu_torch.ops.poisson import (
        _block_products,
        precompute_dct_matrices,
    )

    n = 2048
    torch.backends.cuda.matmul.allow_tf32 = False
    Cx, Cy = precompute_dct_matrices(n, n, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn(n, n, generator=g, device=dev)
    first = Cy @ f
    second = first @ Cx.T
    ly, lx = n // mesh[0], n // mesh[1]
    with _block_products(f):
        for iy in range(mesh[0]):
            for ix in range(mesh[1]):
                rows = slice(iy * ly, (iy + 1) * ly)
                cols = slice(ix * lx, (ix + 1) * lx)
                assert torch.equal(Cy[rows] @ f[:, cols], first[rows, cols])
                assert torch.equal(first[rows] @ Cx[cols].T,
                                   second[rows, cols])
