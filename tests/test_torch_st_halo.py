"""The halo of the sharded surface tension, on the CPU without a world
(float64, N=64, the capillary drop's ellipse).

A rank computes the step's body forces on its block padded by
``parallel.sharding.force_halo(cfg)`` cells (``sim._on_mesh_slabs``), so
the force and the balanced CSF's faces of a cell must read phi no further
than that halo:

- the curvature's reach is exactly ``physics.surface_tension_reach`` of
  the cell CSF: 2 cells for fd (kappa* is pointwise), hh + 1 for the
  height function (hh = max(3, ceil(sqrt(2) w_t / dx) + 2): 5 at
  w_t_cells 1.5, 7 at 3);
- a change of phi in one cell changes the force and the faces (each
  cell's east and north face, ``ops.poisson.faces_to_cells``) no further
  than the halo: exactly 2 (cell CSF) and 3 (balanced) cells with fd;
  less than the curvature's reach with the height function, whose far
  curvature changes fall where grad H is 0;
- on every block of the (2, 4) and (4, 1) meshes, padded by the halo as
  the exchange pads it (``parallel.sharding.slab_of``), the forces and
  faces equal the whole field's bit for bit; with fd one cell less of
  halo does not;
- ``make_sharded_step`` names that halo in ``step.paths['forces']``.

The probes lie inside the domain, farther than the reach from its edge:
at the edge the one-sided closures reach a cell further in, where a slab
computes exactly what the whole field does.
"""
import dataclasses
import itertools

import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.ops.poisson import faces_from_cells, faces_to_cells
from pyrmt_tpu_torch.parallel import Mesh, make_sharded_step
from pyrmt_tpu_torch.parallel.sharding import force_halo, slab_of
from pyrmt_tpu_torch.physics import (
    _solid_curvature,
    body_forces,
    surface_tension_reach,
)
from pyrmt_tpu_torch.sim import _on_mesh_slabs

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
ELLIPSE = pt.Ellipse(0.5, 0.5, 0.2 * 1.15, 0.2 / 1.15)
# (st_curvature, st_hf_smooth)
CURVATURES = [("fd", 0), ("hf", 0), ("hf", 2)]
# cells on the interface and a few inside and outside it, all farther than
# any reach from the domain's edge
PROBES = [(32, 44), (32, 45), (40, 42), (20, 38), (44, 40), (32, 20),
          (50, 32), (32, 32)]
KINDS = list(itertools.product(CURVATURES, [False, True], [1.5, 3.0]))
KIND_IDS = [f"{c}{s}-{'kstar' if k else 'raw'}-w{w}"
            for (c, s), k, w in KINDS]


def config(curvature, smooth, kstar, w_t_cells, st_method="csf"):
    return pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), gamma=0.1,
                        st_method=st_method, st_curvature=curvature,
                        st_hf_smooth=smooth, st_kappa_interface=kstar,
                        w_t_cells=w_t_cells, num_layers=4)


def level_sets():
    X, Y = pt.Grid(N, N, 1.0, 1.0).coords(dtype=torch.float64, device=DEV)
    return ELLIPSE(X, Y)[None]


def forces_of(cfg):
    """The step's body-force partial (``sim.make_step``'s) of cfg."""
    g = cfg.grid

    def forces(phis, rho_local, **kw):
        return body_forces(
            phis, rho_local, g.dx, g.dy, k_rep=cfg.k_rep, w_c=cfg.w_c,
            w_t=cfg.w_t, st_method=cfg.st_method,
            st_curvature=cfg.st_curvature,
            st_kappa_interface=cfg.st_kappa_interface,
            st_hf_smooth=cfg.st_hf_smooth, with_faces=True,
            st_enabled=True, **kw)

    return forces


def fields(cfg, phis):
    """(f_x, f_y[, the four face fields]) stacked, the faces in the block
    layout."""
    fx, fy, faces = forces_of(cfg)(phis, None, gamma=cfg.gamma)
    out = [fx, fy] + ([] if faces is None else list(faces_to_cells(faces)))
    return torch.stack(out)


def reach_of(fn, phis):
    """The farthest (Chebyshev) cell at which ``fn`` changes when phi
    changes by 0.3 dx in one probe cell, over the probes."""
    base, worst = fn(phis), -1
    for j, i in PROBES:
        p = phis.clone()
        p[..., j, i] += 0.3 / (N - 1)
        d = (fn(p) - base).abs()
        while d.dim() > 2:
            d = d.amax(0)
        jj, ii = torch.nonzero(d > 0, as_tuple=True)
        if len(jj):
            worst = max(worst, int(torch.maximum((jj - j).abs(),
                                                 (ii - i).abs()).max()))
    return worst


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_curvature_reach_is_surface_tension_reach(kind):
    (curvature, smooth), kstar, w = kind
    cfg = config(curvature, smooth, kstar, w)
    g = cfg.grid

    def kap(phis):
        return _solid_curvature(phis[0], g.dx, g.dy, cfg.w_t, curvature,
                                kstar, hf_smooth=smooth)

    want = surface_tension_reach(g.dx, g.dy, cfg.w_t, "csf", curvature,
                                 smooth)
    assert reach_of(kap, level_sets()) == want
    assert want == (2 if curvature == "fd" else
                    {1.5: 6, 3.0: 8}[w])


@pytest.mark.parametrize("st_method", ["csf", "balanced"])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_force_and_faces_stay_within_the_halo(kind, st_method):
    """The change of the force and of the faces from a change of phi in
    one cell stays within force_halo(cfg), the halo of the forces'
    exchange; with fd it reaches exactly that far."""
    (curvature, smooth), kstar, w = kind
    cfg = config(curvature, smooth, kstar, w, st_method)
    halo = force_halo(cfg)
    got = reach_of(lambda p: fields(cfg, p), level_sets())
    assert 0 < got <= halo
    if curvature == "fd":
        assert got == halo == (3 if st_method == "balanced" else 2)


@dataclasses.dataclass
class SlabMesh(Mesh):
    """A Mesh whose halo exchange cuts each padded block from the whole
    field it came from (``slab_of``: the neighbours' cells, zeros beyond
    the domain), in place of the messages of a world of ranks."""

    wholes: tuple = ()

    def pad(self, fields, halo, wrap=False):
        rows, cols = self.block(*self.wholes[0].shape[-2:])
        out = []
        for f in fields:
            whole = next(w for w in self.wholes
                         if w.shape[:-2] == f.shape[:-2]
                         and torch.equal(w[..., rows, cols], f))
            out.append(slab_of(whole, self.shape, self.coords, halo)[0])
        return out


@pytest.mark.parametrize("st_method", ["csf", "balanced"])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_forces_on_halo_slabs_are_the_whole_fields(kind, st_method):
    """sim._on_mesh_slabs on every block of the (2, 4) and (4, 1) meshes,
    padded by force_halo(cfg): the force and the faces of the block equal
    the whole field's bit for bit (the faces in the block layout, whose
    last column and row are 0 beyond the domain); with fd, a halo one
    cell short differs on some block."""
    (curvature, smooth), kstar, w = kind
    cfg = config(curvature, smooth, kstar, w, st_method)
    phis = level_sets()
    rho = 1.0 + 0.5 * torch.rand((N, N), dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(1))
    want = fields(cfg, phis)
    halo = force_halo(cfg)
    if st_method == "balanced":
        _, _, faces = forces_of(cfg)(phis, None, gamma=cfg.gamma)
        assert torch.equal(want[2][:, -1], torch.zeros(N, dtype=want.dtype))
        assert torch.equal(want[3][-1, :], torch.zeros(N, dtype=want.dtype))
        for a, b in zip(faces_from_cells(list(want[2:])), faces):
            assert torch.equal(a, b)
    for h in (halo, halo - 1):
        worst = 0.0
        for shape in ((2, 4), (4, 1)):
            for iy, ix in itertools.product(*map(range, shape)):
                mesh = SlabMesh(shape, (iy, ix), wholes=(phis, rho))
                rows, cols = mesh.block(N, N)
                run = _on_mesh_slabs(mesh, forces_of(cfg), h)
                f_x, f_y, faces = run(phis[..., rows, cols].contiguous(),
                                      rho[rows, cols].contiguous(),
                                      gamma=cfg.gamma)
                got = [f_x, f_y] + ([] if faces is None else list(faces))
                assert len(got) == want.shape[0]
                worst = max(worst, max(float((g - w[rows, cols]).abs().max())
                                       for g, w in zip(got, want)))
        if h == halo:
            assert worst == 0.0, (h, worst)
        elif curvature == "fd":
            assert worst > 0.0, h


@pytest.mark.filterwarnings("ignore:st_curvature='hf'")
@pytest.mark.parametrize("st_method", ["csf", "balanced"])
@pytest.mark.parametrize("curvature, smooth", CURVATURES)
def test_make_sharded_step_exchanges_the_force_halo(curvature, smooth,
                                                    st_method):
    """make_sharded_step builds a surface-tension step on walls (no world:
    a Mesh without groups plans) and names its forces' halo,
    force_halo(cfg), which the halo its blocks must hold covers."""
    cfg = config(curvature, smooth, True, 3.0, st_method)
    step, _ = make_sharded_step(cfg, pt.free_slip_box_bc, (ELLIPSE,),
                                Mesh((2, 2)), dtype=torch.float64,
                                device=DEV)
    halo = force_halo(cfg)
    assert step.paths["forces"].endswith(f"on {halo}-cell halo slabs")
    assert halo <= 4 * cfg.num_layers + 4
    # blocks of 16 rows hold no halo of 4 num_layers + 4 = 20 cells: the
    # ValueError names the step's halo
    with pytest.raises(ValueError, match="halo of 20 cells"):
        make_sharded_step(cfg, pt.free_slip_box_bc, (ELLIPSE,),
                          Mesh((4, 1)), dtype=torch.float64, device=DEV)
