"""The collectives of ``parallel.sharding`` differentiate: each ``Mesh``
primitive's adjoint, and the sharded step's gradient against one device.

One gloo world of 4 CPU processes (``parallel.launch.run_world``) runs
every case, its ranks importing this module from its directory (so it
imports nothing of JAX):

- the dot-product test of each primitive on the (2, 2), (4, 1) and (1, 4)
  meshes, float64: with x and y drawn on each rank, the sum over the ranks
  of <J x, y> equals the sum over the ranks of <x, J^T y> to 1e-12
  relative, J x the primitive's forward and J^T y its autograd backward.
  ``pad`` at halos 1, 3 and 8 with the zero and the wrap halo,
  ``overlap_copy`` with ``tile`` False and True, ``gather_rows``,
  ``gather_cols``, ``gather``, ``sum``, ``mean``, ``replicate`` (whose
  input is one value that every rank holds: <x, J^T y> counts it once), and
  ``max`` / ``min`` with ties inside a block and across blocks, both per
  element and of a block's reduction (``count``: J x is then the mean of
  x over the cells that attain the result, as ``torch.amax`` shares it on
  one device). Each forward with a gradient equals the plain one bit for
  bit;
- the sharded step's gradient (the fault that the collectives' adjoints
  fix: with plain collectives autograd kept each rank's own path and
  dropped every path through a neighbour, a gather or a reduction, and
  returned a wrong gradient without raising): the flagship from a swirl
  at N=32 float64 on the (2, 1) mesh, 2 steps, ``rmt_method='xla'``; the
  derivative of the ranks' summed block losses sum(u^2 + v^2) with respect
  to a factor on the initial velocity equals the single-device port's to
  1e-10 relative (with the plain collectives the ranks' gradients summed
  to 80.0842 against 80.1840).
"""
import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.io import state_to_numpy
from pyrmt_tpu_torch.parallel.launch import run_world

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
F64 = torch.float64

MESHES = ((2, 2), (4, 1), (1, 4))
BLOCK = (12, 10)  # a rank's block: the wrap halo of 8 needs 9 cells
RTOL = 1e-12
PRIMITIVES = (
    [f"pad halo {h}{' wrap' if w else ''}" for h in (1, 3, 8)
     for w in (False, True)]
    + ["overlap_copy", "overlap_copy tile", "gather_rows", "gather_cols",
       "gather", "sum", "mean", "replicate", "max", "min", "max of blocks",
       "min of blocks"])
# the F6 case: the flagship from a swirl at N=32 on (2, 1), 2 steps
F6_N = 32
F6_STEPS = 2
FLAGSHIP = dict(mu_s=0.1, eta_s=0.01, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                num_layers=3, CFL=0.2, dt_min_cap=1e-3)


def f6_case():
    """(cfg, bc, shapes, state) of the F6 case, a swirl of 0.3 under the
    lid."""
    cfg = pt.RMTConfig(grid=pt.Grid(F6_N, F6_N, 1.0, 1.0), **FLAGSHIP)
    shapes = (pt.Disc(0.6, 0.5, 0.2),)
    X, Y = cfg.grid.coords(dtype=F64, device=DEV)
    state = pt.make_init_state(
        cfg, shapes, u0=0.3 * torch.sin(math.pi * X) * torch.cos(math.pi * Y),
        v0=-0.3 * torch.cos(math.pi * X) * torch.sin(math.pi * Y),
        dtype=F64, device=DEV)
    return cfg, pt.make_lid_bc(1.0), shapes, state


def velocity_loss(s):
    return torch.sum(s.u ** 2 + s.v ** 2)


def f6_gradient(mesh=None, state0=None):
    """(loss, d loss / d scale): the single-device step, or with ``mesh`` a
    rank's sharded step (its block loss, the gradient of the global
    one)."""
    from pyrmt_tpu_torch.io import state_from_numpy
    from pyrmt_tpu_torch.parallel import make_sharded_step

    cfg, bc, shapes, state = f6_case()
    scale = torch.ones((), dtype=F64, requires_grad=True)
    if mesh is None:
        step = pt.make_step(cfg, bc, shapes, dtype=F64, device=DEV)
        factor = scale
    else:
        step, shard = make_sharded_step(cfg, bc, shapes, mesh, dtype=F64,
                                        device=DEV, rmt_method="xla")
        state = shard(state_from_numpy(state0, dtype=F64, device=DEV))
        factor = mesh.replicate(scale)
    s = dataclasses.replace(state, u=state.u * factor, v=state.v * factor)
    for _ in range(F6_STEPS):
        s = step(s, 1.0)[0]
    loss = velocity_loss(s)
    loss.backward()
    return loss.item(), scale.grad.item()


def _fields(name, rng, ly, lx):
    """The inputs of a primitive case on a rank."""
    def field(*lead):
        return torch.tensor(rng.standard_normal((*lead, ly, lx)), dtype=F64)

    if name.startswith("pad"):
        return [field(), field(2)]
    if name.startswith("overlap"):
        return [field(), field()]
    if name.startswith("gather"):
        return [field(2)]
    if name == "sum":
        return [torch.tensor(rng.standard_normal(), dtype=F64)]
    if name == "replicate":  # one value, the same on every rank
        return [torch.tensor(np.random.RandomState(7).standard_normal(),
                             dtype=F64)]
    if name == "mean":
        return [field()]
    if name in ("max", "min"):
        # element 0 tied on every rank, element 2 on ranks 0 and 2
        sign = 1.0 if name == "max" else -1.0
        x = rng.uniform(-1.0, 1.0, 5)
        x[0] = 3.0 * sign
        x[2] = 7.0 * sign if rng.rank in (0, 2) else x[2]
        return [torch.tensor(x, dtype=F64)]
    # of blocks: the extremum twice on rank 0, once on rank 3
    sign = 1.0 if name.startswith("max") else -1.0
    f = rng.uniform(-1.0, 1.0, (ly, lx))
    if rng.rank == 0:
        f[1, 2] = f[5, 7] = 5.0 * sign
    if rng.rank == 3:
        f[0, 0] = 5.0 * sign
    return [torch.tensor(f, dtype=F64)]


def _apply(mesh, name, xs):
    """The primitive on the inputs: a list of outputs."""
    if name.startswith("pad"):
        return mesh.pad(xs, int(name.split()[2]), wrap=name.endswith("wrap"))
    if name.startswith("overlap"):
        return mesh.overlap_copy(xs, tile=name.endswith("tile"))
    if name.startswith("gather"):
        return [getattr(mesh, name)(xs[0])]
    if name in ("sum", "mean", "replicate", "max", "min"):
        return [getattr(mesh, name)(xs[0])]
    m = (torch.amax if name.startswith("max") else torch.amin)(xs[0])
    reduce = mesh.max if name.startswith("max") else mesh.min
    return [reduce(m, count=torch.sum(xs[0] == m))]


class _Rng(np.random.RandomState):
    def __init__(self, seed, rank):
        super().__init__(seed)
        self.rank = rank


def adjoint_checks():
    """A rank body: every primitive case on every mesh of ``MESHES``, and
    the F6 case on (2, 1); on rank 0 ({(mesh, case): (sum <J x, y>, sum
    <x, J^T y>, the forward with a gradient equal to the plain one)}, the
    F6 result), None on the others."""
    import torch.distributed as dist

    from pyrmt_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape=shape)
        for k, name in enumerate(PRIMITIVES):
            rng = _Rng(1000 * k + 10 * rank + shape[0], rank)
            xs = _fields(name, rng, *BLOCK)
            plain = _apply(mesh, name, xs)
            xs = [x.clone().requires_grad_(True) for x in xs]
            ys = _apply(mesh, name, xs)
            same = all(torch.equal(a, b) for a, b in zip(plain, ys))
            cts = [torch.tensor(rng.standard_normal(tuple(y.shape)),
                                dtype=F64) for y in ys]
            grads = torch.autograd.grad(ys, xs, cts)
            # the direction: x itself for a linear primitive
            dxs = [x.detach() for x in xs]
            lhs = sum(torch.sum(y.detach() * c).item()
                      for y, c in zip(ys, cts))
            if "max" in name or "min" in name:
                # J dx from the ties, in numpy: the mean of dx over the
                # cells of all ranks that attain the result at x
                dxs = [torch.tensor(rng.standard_normal(tuple(xs[0].shape)),
                                    dtype=F64)]
                rows = [None] * mesh.size
                dist.all_gather_object(
                    rows, (xs[0].detach().numpy(), dxs[0].numpy(),
                           cts[0].numpy()), group=mesh.group)
                lhs = _extremum_lhs(name, rows)
            rhs = sum(torch.sum(dx * g).item() for dx, g in zip(dxs, grads))
            got = [None] * mesh.size
            dist.all_gather_object(got, (lhs, rhs, same), group=mesh.group)
            # a replicated input is one value: <x, J^T y> counts it once
            out[(shape, name)] = (
                sum(g[0] for g in got) if "max" not in name
                and "min" not in name else lhs,
                sum(g[1] for g in got) / (mesh.size if name == "replicate"
                                          else 1),
                all(g[2] for g in got))
    f6 = None
    mesh = make_mesh(shape=(2, 1))
    if mesh is not None:
        _, _, _, state = f6_case()
        loss, grad = f6_gradient(mesh, state_to_numpy(state))
        got = [None] * mesh.size
        dist.all_gather_object(got, (loss, grad), group=mesh.group)
        f6 = (sum(g[0] for g in got), got[0][1], got[1][1])
    return (out, f6) if rank == 0 else None


def _extremum_lhs(name, rows):
    """sum over the ranks of <J dx, y> for a max or min case from the
    ranks' (x, dx, y): J dx the mean of dx over the cells (of all ranks)
    that attain the result at x, per element or of the blocks'
    reduction."""
    xs, dxs, ys = (np.stack([r[i] for r in rows]) for i in range(3))
    best = (np.max if name.startswith("max") else np.min)
    if name in ("max", "min"):
        hit = xs == best(xs, axis=0)
        jdx = np.sum(np.where(hit, dxs, 0.0), axis=0) / np.sum(hit, axis=0)
        return float(np.sum(ys * jdx))
    hit = xs == best(xs)
    return float(np.sum(ys) * np.sum(dxs[hit]) / np.sum(hit))


@pytest.fixture(scope="module")
def world():
    """The world of 4 ranks (every case), and the single-device F6
    gradient."""
    here = str(Path(__file__).resolve().parent)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (here, old) if p)
    try:
        out, f6 = run_world(4, "test_torch_sharding_grad:adjoint_checks",
                            backend="gloo")[0]
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    return out, f6, f6_gradient()


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", PRIMITIVES)
def test_collective_adjoint_dot_product(world, shape, name):
    """sum_ranks <J x, y> = sum_ranks <x, J^T y>, and the forward with a
    gradient is the plain collective's bit for bit."""
    lhs, rhs, same = world[0][(shape, name)]
    assert same, (shape, name)
    assert abs(lhs) > 0.0
    assert abs(lhs - rhs) <= RTOL * abs(lhs), (shape, name, lhs, rhs)


def test_f6_sharded_gradient_equals_single_device(world):
    """The F6 case (ROADMAP.md section 3): the ranks' summed block
    losses and the gradient of the global loss (each rank's leaf holds
    all of it) equal the single-device port's."""
    _, (loss, g0, g1), (want_loss, want) = world[0], world[1], world[2]
    assert loss == pytest.approx(want_loss, rel=1e-13)
    assert g0 == g1
    assert abs(g0 - want) <= 1e-10 * abs(want), (g0, want)


def test_sharded_traced_params_names_are_checked():
    """A name outside ``sim._TRACEABLE_PARAMS`` raises, as
    ``sim.make_step``'s traced step does; a known one builds, with the
    adjoint collectives named."""
    from pyrmt_tpu_torch.parallel import Mesh, make_sharded_step

    cfg, bc, shapes, _ = f6_case()
    with pytest.raises(ValueError, match="not traceable"):
        make_sharded_step(cfg, bc, shapes, Mesh((2, 1)), dtype=F64,
                          device=DEV, traced_params=("mu_f",))
    step, _ = make_sharded_step(cfg, bc, shapes, Mesh((2, 1)), dtype=F64,
                                device=DEV, traced_params=("mu_s", "gamma"))
    assert step.paths["grad"] == "adjoint collectives, direct"
