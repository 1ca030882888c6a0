"""The halos of the sharded general tier, on the CPU without a world
(float64, N=64).

A rank of ``parallel.make_sharded_step`` runs the general tier on its
block of the grid padded by exchanged cells:

- WENO5 and central2: the three SSP-RK3 stages on the block padded by
  ``ops.advect.RK3_REACH`` cells (9 and 3) (``Mesh.stencil``): on every
  block of four meshes the block equals the whole field's bit for bit,
  and one cell less of halo differs on some block, so the near-edge
  fallbacks need no global index;
- the extrapolation on the block padded by 4 num_layers cells with the
  sharding offsets (``ops.extrapolate.extrapolate_reference_map``'s plain
  twin on the slab, ``parallel.sharding.make_extrapolate_sharded``): the
  blocks stitched equal the unsharded plain version bit for bit, one cell
  less of halo differs;
- the gather path: the backtrace and the gather of a block's nodes from
  the whole fields (``at``) equal the whole field's, bilinear and bicubic
  under the band guard, with a backtrace longer than a cell;
- the stress of ``physics.momentum_step_rk4_multi`` on a block, and the
  forces the sharded step hands it (the contact and the cell CSF on
  ``force_halo`` slabs, ``sim._on_mesh_slabs``), equal the whole field's.

The halo exchange is ``CutMesh``'s: each padded block cut from the whole
field it came from (``parallel.sharding.slab_of``).
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.ops.advect import (
    RK3_REACH,
    advect_central2_rk3,
    advect_semilagrangian_rk4_multi,
    advect_weno5_rk3,
)
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.parallel.sharding import (
    Mesh,
    force_halo,
    make_extrapolate_sharded,
    slab_of,
)
from pyrmt_tpu_torch.physics import body_forces, momentum_step_rk4_multi
from pyrmt_tpu_torch.sim import _on_mesh_slabs

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
MESHES = ((4, 1), (1, 4), (2, 2), (2, 4))
# two solids whose contact bands touch, each crossing the meshes' cuts
DISCS = (pt.Disc(0.36, 0.5, 0.2), pt.Disc(0.7, 0.45, 0.12))
LAYERS = 3


@dataclasses.dataclass
class CutMesh(Mesh):
    """A Mesh whose halo exchange cuts each padded block from the whole
    field it came from (the blocks made by ``cut``), in place of the
    messages of a world of ranks."""

    wholes: dict = dataclasses.field(default_factory=dict)

    def cut(self, whole):
        rows, cols = self.block(*whole.shape[-2:])
        block = whole[..., rows, cols].contiguous()
        self.wholes[id(block)] = whole
        return block

    def pad(self, fields, halo, wrap=False):
        out = []
        for f in fields:
            out.append(slab_of(self.wholes[id(f)], self.shape, self.coords,
                               halo)[0])
        return out


def blocks():
    for shape in MESHES:
        for iy, ix in itertools.product(*map(range, shape)):
            yield shape, (iy, ix)


def inputs():
    """Seeded maps near the identity (2 solids), their level sets, a swirl
    strong enough that the advection moves every band, and dt."""
    g = pt.Grid(N, N, 1.0, 1.0)
    X, Y = g.coords(dtype=torch.float64, device=DEV)
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.uniform(0.02, 0.05, (2, 2)))
    X1s = torch.stack([X + a[0, s] * torch.sin(3 * np.pi * Y)
                       for s in range(2)])
    X2s = torch.stack([Y + a[1, s] * torch.cos(2 * np.pi * X)
                       for s in range(2)])
    phis = torch.stack([d(X1s[s], X2s[s]) for s, d in enumerate(DISCS)])
    u = torch.sin(np.pi * X) * torch.cos(np.pi * Y)
    v = -torch.cos(np.pi * X) * torch.sin(np.pi * Y)
    return g, X, Y, X1s, X2s, phis, u, v, 0.6 * g.dx


def worst_over_blocks(run, wholes, want, halo):
    """The largest max-abs over the blocks of MESHES between ``run(mesh,
    *blocks of wholes, halo)`` and the block of ``want``."""
    worst = 0.0
    for shape, coords in blocks():
        mesh = CutMesh(shape, coords)
        rows, cols = mesh.block(N, N)
        got = run(mesh, *(mesh.cut(w) for w in wholes), halo=halo)
        worst = max(worst, float((got - want[..., rows, cols]).abs().max()))
    return worst


@pytest.mark.parametrize("scheme", ["weno5", "central2"])
def test_rk3_on_slabs_of_its_reach_is_the_whole_field(scheme):
    """The three stages on a block padded by RK3_REACH cells equal the
    whole field's bit for bit on every block of the four meshes; one cell
    less differs on some block (the reach is 3 x 3 and 3 x 1 cells)."""
    g, _, _, X1s, X2s, phis, u, v, dt = inputs()
    rk3 = advect_weno5_rk3 if scheme == "weno5" else advect_central2_rk3
    qs, phi2 = torch.cat([X1s, X2s]), torch.cat([phis, phis])
    want = rk3(qs, u, v, g.dx, g.dy, dt, phi2)
    assert float((want - qs).abs().max()) > 1e-4  # the maps move

    def run(mesh, q, a, b, p, halo):
        def stages(q, a, b, p):
            return rk3(q, a, b, g.dx, g.dy, dt, p)
        return mesh.stencil(stages, halo)(q, a, b, p)

    reach = RK3_REACH[scheme]
    assert reach == {"weno5": 9, "central2": 3}[scheme]
    wholes = (qs, u, v, phi2)
    assert worst_over_blocks(run, wholes, want, reach) == 0.0
    assert worst_over_blocks(run, wholes, want, reach - 1) > 0.0


def test_extrapolation_on_slabs_with_offsets_is_the_whole_field():
    """make_extrapolate_sharded with the plain twin: each solid's masked
    maps on every block of the four meshes, padded by 4 num_layers cells,
    stitched equal the unsharded plain extrapolation bit for bit; a halo
    one cell short differs on some block."""
    g, _, _, X1s, X2s, phis, u, v, dt = inputs()
    masks = (phis <= 0.0).to(torch.float64)
    X1a, X2a = X1s * masks, X2s * masks
    for s in range(2):
        want = torch.stack(extrapolate_reference_map(
            X1a[s], X2a[s], phis[s], g.dx, g.dy, LAYERS))
        assert float((want - torch.stack([X1a[s], X2a[s]])).abs().max()) \
            > 0.1  # the layers grow

        def run(mesh, x1, x2, p, halo):
            if halo == 4 * LAYERS:  # the sharded step's
                impl = make_extrapolate_sharded(mesh, N, N, LAYERS,
                                                extrapolate_reference_map)
                return torch.stack(impl(x1, x2, p, g.dx, g.dy, LAYERS))
            out = extrapolate_reference_map(*mesh.pad([x1, x2, p], halo),
                                            g.dx, g.dy, LAYERS,
                                            **mesh.offsets(N, N, halo))
            return torch.stack([mesh.unpad(o, halo) for o in out])

        wholes = (X1a[s], X2a[s], phis[s])
        assert worst_over_blocks(run, wholes, want, 4 * LAYERS) == 0.0
        assert worst_over_blocks(run, wholes, want, 4 * LAYERS - 1) > 0.0


def test_extrapolation_twin_with_offsets_leaves_the_cut_zero():
    """The plain twin on a slab: 0 within 4 num_layers cells of a cut and
    beyond the domain, as the kernel leaves them; the whole field with
    offsets (0, N, 0, N) is the unsharded result."""
    g, _, _, X1s, X2s, phis, _, _, _ = inputs()
    args = (X1s[0] * (phis[0] <= 0), X2s[0] * (phis[0] <= 0), phis[0])
    halo = 4 * LAYERS
    slabs = [slab_of(f, (2, 2), (1, 0), halo) for f in args]
    offs = slabs[0][1]
    assert offs == dict(row_offset=N // 2 - halo, Ny_total=N,
                        col_offset=-halo, Nx_total=N)
    x1, _ = extrapolate_reference_map(*(a for a, _ in slabs), g.dx, g.dy,
                                      LAYERS, **offs)
    # rows 0 .. halo - 1 lie within 4L of the cut above, the first halo
    # columns beyond the domain's edge
    assert not x1[:halo].any() and not x1[:, :halo].any()
    assert x1[halo:, halo:].abs().max() > 0.0
    whole = extrapolate_reference_map(*args, g.dx, g.dy, LAYERS)
    same = extrapolate_reference_map(*args, g.dx, g.dy, LAYERS, row_offset=0,
                                     Ny_total=N, col_offset=0, Nx_total=N)
    for a, b in zip(whole, same):
        assert torch.equal(a, b)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_gather_path_of_a_block_is_the_whole_fields(interp):
    """The backtrace and gather of a block's nodes from the whole fields
    (``at``) equal the whole field's advection there bit for bit, with
    departure points 2.4 cells away and the bicubic band guard from the
    block's level sets."""
    g, X, Y, X1s, X2s, phis, u, v, dt = inputs()
    dt = 2.4 * g.dx
    qs = torch.cat([X1s, X2s])
    guard = phis < -3 * g.dx
    mask = torch.cat([guard, guard]) if interp == "bicubic" else None
    want = advect_semilagrangian_rk4_multi(qs, u, v, X, Y, dt, g.dx, g.dy,
                                           interp=interp, cubic_mask=mask)
    assert float((want - qs).abs().max()) > 2 * g.dx
    for shape, coords in blocks():
        rows, cols = Mesh(shape, coords).block(N, N)
        got = advect_semilagrangian_rk4_multi(
            qs, u, v, X[rows, cols], Y[rows, cols], dt, g.dx, g.dy,
            interp=interp, at=(rows, cols),
            cubic_mask=None if mask is None else mask[:, rows, cols])
        assert torch.equal(got, want[:, rows, cols]), (shape, coords)


@pytest.mark.parametrize("gamma", [0.0, 0.1])
def test_momentum_step_stress_and_forces_on_a_block(gamma):
    """``momentum_step_rk4_multi`` with a mesh: the stresses, J and the
    force its update receives (the contact of two solids, with gamma the
    cell CSF too, built as the sharded general tier builds them: on
    ``force_halo`` slabs, passed as ``ext_override``) on every block of
    the four meshes equal the whole field's (the forces computed inside
    the step) bit for bit."""
    g, _, _, X1s, X2s, phis, u, v, dt = inputs()
    w_t = 2.0 * g.dx
    kw = dict(mu_s=0.1, kappa=1.0, eta_s=0.0, dx=g.dx, dy=g.dy, dt=dt,
              rho_s=1.0, rho_f=1.0, mu_f=0.01, w_t=w_t, gamma=gamma,
              stress_clamp=4.0, k_rep=2.0, w_c=3 * g.dx)
    cfg = pt.RMTConfig(grid=g, gamma=gamma, k_rep=2.0)  # w_t, w_c as kw
    forces = functools.partial(
        body_forces, dx=g.dx, dy=g.dy, gamma=gamma, k_rep=2.0, w_c=3 * g.dx,
        w_t=w_t, with_faces=True)

    def update(u, v, p, sxx, sxy, syy, Hf, rho, mkv, bc, *, f_ext_x,
               f_ext_y, **_):
        return f_ext_x, f_ext_y

    def run(mesh, *fields):
        ext = None
        if mesh is not None:
            ext = _on_mesh_slabs(mesh, forces, force_halo(cfg))(
                fields[5], None)[:2]
        out = momentum_step_rk4_multi(*fields[:3], *fields[3:6],
                                      pt.noop_bc, momentum_fn=update,
                                      mesh=mesh, ext_override=ext, **kw)
        return torch.cat([torch.stack(out[:2]), *out[2:]])

    p = torch.zeros_like(u)
    want = run(None, u, v, p, X1s, X2s, phis)
    assert float(want[:2].abs().max()) > 0.0  # a force acts
    worst = 0.0
    for shape, coords in blocks():
        mesh = CutMesh(shape, coords)
        rows, cols = mesh.block(N, N)
        got = run(mesh, *(mesh.cut(f) for f in (u, v, p, X1s, X2s, phis)))
        worst = max(worst, float((got - want[..., rows, cols]).abs().max()))
    assert worst == 0.0
