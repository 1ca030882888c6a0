"""The sharding offsets (``row_offset``, ``Ny_total``, ``col_offset``,
``Nx_total``) of the solid blocks and the RK4 update, and the kernels'
device guard.

- Each plain twin (``rmt_block_plain``: bilinear, bicubic, two solids with
  the clamp; ``advext_block_plain``: bilinear, bicubic; ``momentum_core``
  with the lid and with the free-slip BC and a force) runs on every
  block of the (4, 1), (1, 4), (2, 2) and (2, 4) meshes, padded by the
  sharded step's halo as the exchange pads it (zeros beyond the domain),
  with the block's offsets; the blocks cut back and stitched equal the
  whole field's call to 1e-13 (they agree bit for bit: the samples take
  the global index, the ghost cell beyond a cut keeps the BC off the
  block).
- A slab's results are 0 outside the domain and within the stale depth
  of a cut (``cut_depth``, 8 for the RK4 update), as the CUDA kernels
  leave them; the wrappers take the offsets on a CPU tensor to the plain
  twins; the periodic box takes none.
- ``_build.launch`` calls a launcher inside ``torch.cuda.device`` of the
  tensors' device, and every kernel wrapper launches through it.
"""
import inspect

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.kernels import _build
from pyrmt_tpu_torch.kernels import extrapolate_fused as ef
from pyrmt_tpu_torch.kernels import momentum_rhs as mr
from pyrmt_tpu_torch.kernels import momentum_rk4 as mk
from pyrmt_tpu_torch.kernels import projection_stencils as ps
from pyrmt_tpu_torch.kernels import rmt_block as rb
from pyrmt_tpu_torch.parallel.sharding import Mesh, slab_of
from pyrmt_tpu_torch.physics import RK4_HALO, momentum_core

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
KW = dict(dtype=torch.float64, device=DEV)

N = 64
L = 3
MESHES = [(4, 1), (1, 4), (2, 2), (2, 4)]
DISC = pt.Disc(0.35, 0.6, 0.2)
TOUCHING = (pt.Disc(0.38, 0.5, 0.14), pt.Disc(0.66, 0.5, 0.14))


def inputs(solids=(DISC,)):
    """Seeded fields on the N x N grid: a smooth velocity of a few random
    modes at a sub-cell displacement, the solids' maps with a sub-cell
    wobble, a pressure, a random force."""
    rng = np.random.default_rng(7)
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=1.0, eta_s=0.01,
                       mu_f=0.01, num_layers=L)
    X, Y = (a.numpy() for a in cfg.grid.coords(**KW))
    u = np.zeros((N, N))
    v = np.zeros((N, N))
    for _ in range(3):
        kx, ky = rng.integers(1, 4, size=2)
        a, b, c = rng.standard_normal(3)
        u += a * np.sin(np.pi * kx * X + c) * np.cos(np.pi * ky * Y)
        v += b * np.cos(np.pi * kx * X) * np.sin(np.pi * ky * Y + c)
    scale = 0.5 / max(np.abs(u).max(), np.abs(v).max())
    s = pt.make_init_state(cfg, solids, **KW)
    dx = cfg.grid.dx
    t = lambda a: torch.tensor(a, **KW)  # noqa: E731
    X1s = s.X1 + t(0.4 * dx * np.sin(3 * np.pi * Y))
    X2s = s.X2 - t(0.4 * dx * np.sin(2 * np.pi * X))
    phis = torch.stack([f(X1s[i], X2s[i]) for i, f in enumerate(solids)])
    return cfg, dict(u=t(u * scale), v=t(v * scale), X1s=X1s, X2s=X2s,
                     phis=phis, dt=t(0.4 * dx / 0.5),
                     params=t([cfg.mu_s, cfg.kappa, cfg.rho_s, cfg.rho_f]),
                     p=t(0.05 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)),
                     fx=t(0.01 * rng.standard_normal((N, N))),
                     fy=t(0.01 * rng.standard_normal((N, N))))


def rmt_case(mode, solids=(DISC,)):
    cfg, d = inputs(solids)
    g = cfg.grid
    kw = dict(phi_inits=solids, dx=g.dx, dy=g.dy, num_layers=L, w_t=cfg.w_t,
              params=d["params"], **mode)
    return (lambda *a, **o: rb.rmt_block_plain(*a, **kw, **o),
            [d["u"], d["v"], d["X1s"], d["X2s"]], [d["dt"]],
            4 * L + 4, rb.cut_depth(L, mode.get("sl_interp", "bilinear")))


def advext_case(mode):
    cfg, d = inputs()
    g = cfg.grid
    kw = dict(dx=g.dx, dy=g.dy, num_layers=L, **mode)
    return (lambda *a, **o: rb.advext_block_plain(*a, **kw, **o),
            [d["u"], d["v"], d["X1s"], d["X2s"], d["phis"]], [d["dt"]],
            4 * L + 4, rb.cut_depth(L, mode.get("sl_interp", "bilinear")))


def momentum_case(bc, force):
    cfg, d = inputs()
    g = cfg.grid
    out = rb.rmt_block_plain(d["u"], d["v"], d["X1s"], d["X2s"], d["dt"],
                             phi_inits=(DISC,), dx=g.dx, dy=g.dy,
                             num_layers=L, w_t=cfg.w_t, params=d["params"])
    Hf, rho, sbxx, sbxy, sbyy = out[7:]
    mkv = (out[2][0] <= 0.0).to(Hf.dtype) * (1.0 - Hf)
    fields = [d["u"], d["v"], d["p"], sbxx, sbxy, sbyy, Hf, rho, mkv]
    if force:
        fields += [d["fx"], d["fy"]]
    kw = dict(eta_s=cfg.eta_s, dx=g.dx, dy=g.dy,
              dt=torch.tensor(2e-3, **KW), mu_f=cfg.mu_f)

    def run(*a, **o):
        f = dict(f_ext_x=a[9], f_ext_y=a[10]) if force else {}
        return momentum_core(*a[:9], bc, **f, **kw, **o)

    return run, fields, [], RK4_HALO, RK4_HALO


TWINS = {
    "rmt_block": lambda: rmt_case({}),
    "rmt_block bicubic": lambda: rmt_case(
        dict(sl_interp="bicubic", sl_guard=3.0 / (N - 1))),
    "rmt_block two solids": lambda: rmt_case(dict(stress_clamp=4.0),
                                             TOUCHING),
    "advext_block": lambda: advext_case({}),
    "advext_block bicubic": lambda: advext_case(dict(sl_interp="bicubic")),
    "momentum lid": lambda: momentum_case(pt.make_lid_bc(1.0), False),
    "momentum free slip, force": lambda: momentum_case(pt.free_slip_box_bc,
                                                       True),
}


def as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("twin", list(TWINS))
def test_stitched_slabs_equal_whole_field(twin, mesh):
    fn, fields, scalars, halo, _ = TWINS[twin]()
    whole = as_tuple(fn(*fields, *scalars))
    ry, rx = mesh
    err = 0.0
    for iy in range(ry):
        for ix in range(rx):
            slabs = [slab_of(f, mesh, (iy, ix), halo) for f in fields]
            out = as_tuple(fn(*(s for s, _ in slabs), *scalars,
                              **slabs[0][1]))
            m = Mesh(mesh, (iy, ix))
            rows, cols = m.block(N, N)
            for o, w in zip(out, whole):
                err = max(err, float((m.unpad(o, halo)
                                      - w[..., rows, cols]).abs().max()))
    assert err <= 1e-13


@pytest.mark.parametrize("twin", ["rmt_block bicubic", "advext_block",
                                  "momentum free slip, force"])
def test_slab_zeros_outside_domain_and_at_cuts(twin):
    """Block (0, 1) of the (2, 2) mesh: its slab's rows and columns beyond
    the domain (the first rows, the last columns) and its cells within the
    stale depth of its two cuts (the last rows, the first columns) are 0;
    the rest is the whole field's."""
    fn, fields, scalars, halo, depth = TWINS[twin]()
    whole = as_tuple(fn(*fields, *scalars))
    slabs = [slab_of(f, (2, 2), (0, 1), halo) for f in fields]
    out = as_tuple(fn(*(s for s, _ in slabs), *scalars, **slabs[0][1]))
    ly = lx = N // 2
    for o, w in zip(out, whole):
        assert o.shape[-2:] == (ly + 2 * halo, lx + 2 * halo)
        assert not o[..., :halo, :].any()          # beyond the top edge
        assert not o[..., :, halo + lx:].any()     # beyond the right edge
        assert not o[..., 2 * halo + ly - depth:, :].any()  # the lower cut
        assert not o[..., :, :depth].any()         # the left cut
        kept = o[..., halo:2 * halo + ly - depth, depth:halo + lx]
        ref = w[..., :ly + halo - depth, lx - halo + depth:]
        assert torch.equal(kept, ref)


def test_wrappers_take_offsets_to_the_plain_twins_on_cpu():
    fn, fields, scalars, halo, _ = TWINS["rmt_block"]()
    cfg, d = inputs()
    g = cfg.grid
    slabs = [slab_of(f, (2, 2), (1, 0), halo) for f in fields]
    kw = dict(phi_inits=(DISC,), dx=g.dx, dy=g.dy, num_layers=L, w_t=cfg.w_t,
              params=d["params"], **slabs[0][1])
    a = rb.rmt_block_fused(*(s for s, _ in slabs), d["dt"], **kw)
    b = rb.rmt_block_plain(*(s for s, _ in slabs), d["dt"], **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, mfields, _, mh, _ = TWINS["momentum lid"]()
    ms = [slab_of(f, (1, 4), (0, 2), mh) for f in mfields]
    mkw = dict(eta_s=0.01, dx=g.dx, dy=g.dy, dt=torch.tensor(2e-3, **KW),
               mu_f=0.01, **ms[0][1])
    a = mk.momentum_rk4_fused(*(s for s, _ in ms), pt.make_lid_bc(1.0), **mkw)
    b = momentum_core(*(s for s, _ in ms), pt.make_lid_bc(1.0), **mkw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_periodic_box_takes_no_offsets():
    _, fields, _, _, _ = TWINS["momentum lid"]()
    kw = dict(eta_s=0.0, dx=1.0 / 63, dy=1.0 / 63,
              dt=torch.tensor(1e-3, **KW), mu_f=0.01, row_offset=-8,
              Ny_total=N)
    with pytest.raises(ValueError, match="periodic"):
        mk.momentum_rk4_fused(*fields, pt.periodic_bc, periodic=True, **kw)
    with pytest.raises(ValueError, match="periodic"):
        momentum_core(*fields, pt.periodic_bc, periodic=True, **kw)


@pytest.mark.parametrize("shape, offsets, expect", [
    ((32, 48), (None, None, None, None), ((0, 0, 32, 48), False)),
    ((48, 32), (-8, 64, None, None), ((-8, 0, 64, 32), True)),
    ((4, 40, 40), (24, 64, -8, 64), ((24, -8, 64, 64), True)),
    ((40, 40), (0, 40, 0, 40), ((0, 0, 40, 40), False)),
])
def test_slab_operands(shape, offsets, expect):
    assert _build.slab_operands(shape, *offsets) == expect


def test_slab_outside_the_domain_raises():
    with pytest.raises(ValueError, match="holds no cell"):
        _build.slab_operands((16, 16), 64, 64, None, None)


def test_launch_enters_the_tensors_device(monkeypatch):
    """``_build.launch`` runs the launcher inside ``torch.cuda.device`` of
    the device it is given, with that device's stream, and raises on an
    error code."""
    seen = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            seen.append(("enter", self.device))

        def __exit__(self, *exc):
            seen.append(("exit", self.device))

    class Lib:
        @staticmethod
        def pyrmt_cuda_error_string(err):
            return b"bad launch"

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(_build, "stream_handle", lambda dev: ("stream", dev))
    dev = torch.device("cuda", 1)

    def launcher(*args):
        seen.append(("call", args))
        return 0

    _build.launch(Lib, launcher, "test", dev, 1, 2.0)
    assert seen == [("enter", dev), ("call", (1, 2.0, ("stream", dev))),
                    ("exit", dev)]
    with pytest.raises(RuntimeError, match="bad launch"):
        _build.launch(Lib, lambda *a: 1, "test", dev)


@pytest.mark.parametrize("fn", [rb._rmt_block_cuda, rb._advext_cuda,
                                mk._momentum_rk4_cuda, ef._extrapolate_cuda,
                                mr._velocity_rhs_cuda, ps._rc_rhs_cuda,
                                ps._grad_correct_cuda])
def test_every_wrapper_launches_through_the_device_guard(fn):
    """Each wrapper's one launch goes through ``_build.launch`` (so it
    enters its tensors' device); none takes a stream of its own."""
    src = inspect.getsource(fn)
    assert src.count("_build.launch(") == 1
    assert "stream_handle" not in src
