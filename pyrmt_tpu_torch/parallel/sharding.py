"""Domain decomposition over ``torch.distributed`` (counterpart of
``pyrmt_tpu.parallel.sharding``).

The (Ny, Nx) grid is cut into a (ry, rx) mesh of blocks, one per rank,
rank = iy * rx + ix. The step is ``sim.make_step``'s, built for one block
with a ``Mesh`` (``make_sharded_step``). JAX hands the partitioner all that
lies outside its two shard_mapped kernels; here each of those becomes an
explicit collective or a halo exchange:

  * the kernels (``make_rmt_block_sharded``, ``make_advext_block_sharded``
    for the split tier, ``make_momentum_rk4_sharded``) run per rank on its
    block plus an exchanged halo (4 num_layers + 4 cells, and 8), with the
    sharding offsets, as in JAX; their plain twins take the same offsets;
  * the stencils of the projection, the contact force and the split
    tier's stress run on a block plus a 1- or 2-cell halo
    (``Mesh.stencil``), the BC and the one-sided closures at the global
    domain's edge only; the PDE reinitialisation 8 iterations per
    exchange of an 8-cell halo;
  * surface tension (walls): the body forces on a block plus the force's
    reach (``force_halo``: 2 cells for the fd curvature and kappa*, hh +
    1 for the height function, one more for the balanced CSF's faces),
    the curvatures' edge replication and closures at the global domain's
    edge only. A rank holds the balanced CSF's faces as four (ly, lx)
    fields (``ops.poisson.faces_to_cells``): each cell's east face Fx
    and north face Fy, 0 in the global domain's last column and row,
    where the face lies beyond the domain, and the cell forces, each the
    mean of its two faces with the zero face beyond the domain's edge as
    on one device. The projection exchanges them with the velocity and
    the pressure and takes the faces back off its slabs
    (``faces_from_cells``);
  * the max speed of the adaptive dt is an all-reduce (MAX), so dt, t and
    the no-op decision are the same on every rank, and so is a rebase's
    least J (MIN);
  * the means of the density and the pressure, the area fix's area and
    perimeter and the CG's dot products and norms are sums of the ranks'
    partial sums, added in rank order on every rank, so every rank reads
    the same CG stopping test;
  * the DCT-I solve's C_y @ rhs @ C_x^T becomes distributed products: the
    column strip gathered over the ranks that share ix, times this rank's
    rows of C_y; the row strip gathered over the ranks that share iy,
    times this rank's rows of C_x, transposed; the same again for the
    inverse. The CG's preconditioner is this solve, its matvec a stencil;
  * the doubly-periodic box: the FFT solve's 1D FFTs along the whole rows
    and columns of gathered strips of the reduced grid (the overlap row
    and column belong to the last rank of each axis); its stencils, and
    the momentum's stage loop, on slabs padded by a wrap halo
    (``Mesh.pad(wrap=True)``); the BC's overlap copy from the rank of row
    or column 0 (``Mesh.overlap_copy``);
  * the global sweeps and samples gather the whole field on every rank:
    the fast-sweeping redistance ('fmm' reinit, each rebase with its
    extrapolation) and the rebuild's sample of phis0 under rebasing.

The halo exchange is JAX's ``_halo_pad_fns``: rows first, then the columns
of the row-padded slab, so that the corners carry the diagonal
neighbour's cells; an edge rank gets zeros beyond the domain, which the
kernels and their twins never read as data. With the gloo backend and
CUDA tensors every exchange and gather goes through host copies (gloo has
no send, receive or gather of CUDA tensors), and ``step.paths['halo']``
says so; NCCL (one rank per card) exchanges on the device.

The configurations that JAX's shard_map path takes are sharded, and of
those that only GSPMD shards in JAX the variable-density CG, the split
tier (reinit, area fix, map rebasing, any level set), the
doubly-periodic box and surface tension on walls (the cell and the
balanced CSF, fd, kappa* and height-function curvature). The general
tier, ``traced_params`` and surface tension on the periodic box raise
NotImplementedError (``check_slice``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

# the halo of the step's plain stencils: the projection's Rhie-Chow
# divergence reads 2 cells, its gradient and the contact force's 1
STENCIL_HALO = 2
# where the configurations outside this slice are to be ported
ROADMAP_ITEM = "ROADMAP.md section 2, modules item 16"


def force_halo(cfg) -> int:
    """The halo of the step's body forces on a rank's block: the contact
    force reads 1 cell, gravity none, surface tension (gamma > 0) as far
    as ``physics.surface_tension_reach`` says (the fd curvature and
    kappa* 2 cells, the height function hh + 1, the balanced CSF's faces
    one more); at least ``STENCIL_HALO``."""
    from pyrmt_tpu_torch.physics import surface_tension_reach

    g = cfg.grid
    reach = 0
    if cfg.gamma > 1e-12:
        reach = surface_tension_reach(g.dx, g.dy, cfg.w_t, cfg.st_method,
                                      cfg.st_curvature, cfg.st_hf_smooth)
    return max(STENCIL_HALO, reach)


@dataclasses.dataclass
class Mesh:
    """A (ry, rx) mesh of ranks and this rank's place (iy, ix) in it.

    ``group`` is the process group of the mesh's ry * rx ranks (None: the
    default group, its ranks 0 .. ry rx - 1 in row-major order);
    ``row_group`` holds the ranks that share iy, ``col_group`` those that
    share ix; ``backend`` is the group's. A Mesh without groups plans and
    checks (the supported tests, ``make_sharded_step``'s checks) but does
    not communicate."""

    shape: tuple[int, int]
    coords: tuple[int, int] = (0, 0)
    group: Any = None
    row_group: Any = None
    col_group: Any = None
    backend: str | None = None

    def staged(self, device) -> bool:
        """Do exchanges of tensors on ``device`` go through host copies?
        Under gloo, which sends, receives and gathers CPU tensors only."""
        return self.backend == "gloo" and torch.device(device).type != "cpu"

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def rank_at(self, iy: int, ix: int) -> int:
        """The global rank of mesh place (iy, ix)."""
        r = iy * self.shape[1] + ix
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def block(self, Ny: int, Nx: int) -> tuple[slice, slice]:
        """This rank's rows and columns of a (Ny, Nx) field."""
        (ry, rx), (iy, ix) = self.shape, self.coords
        ly, lx = Ny // ry, Nx // rx
        return slice(iy * ly, (iy + 1) * ly), slice(ix * lx, (ix + 1) * lx)

    def offsets(self, Ny: int, Nx: int, halo: int) -> dict:
        """The kernels' sharding operands of this rank's block padded by
        ``halo`` (JAX's make_rmt_block_sharded): the global (row, column)
        of the padded slab's (0, 0) and the domain's extents, None along an
        axis the mesh does not split."""
        (ry, rx), (iy, ix) = self.shape, self.coords
        return dict(
            row_offset=iy * (Ny // ry) - halo if ry > 1 else None,
            Ny_total=Ny if ry > 1 else None,
            col_offset=ix * (Nx // rx) - halo if rx > 1 else None,
            Nx_total=Nx if rx > 1 else None)

    # -- communication ------------------------------------------------------

    def _host(self, t):
        return t.cpu() if self.staged(t.device) else t

    def _back(self, t, like):
        return t.to(like.device)

    def pad(self, fields, halo: int, wrap: bool = False):
        """The halo exchange of the tensors ``fields`` (each (..., ly, lx)),
        in one exchange per axis: rows first, then the columns of the
        row-padded slabs. Returns the padded tensors, zeros beyond the
        domain along each split axis (an unsplit axis is not padded).

        ``wrap``: the doubly-periodic overlap grid, whose row Ny - 1 is row
        0 (period Ny - 1, and Nx - 1 for the columns): both axes are
        padded, split or not, and beyond an edge the halo holds the
        opposite side's cells, rows 1, 2, ... above row Ny - 1 and rows
        Ny - 2, Ny - 3, ... below row 0 (``ops.fd.wrap_pad_x``'s ghosts)."""
        ly, lx = fields[0].shape[-2:]
        flat = torch.cat([f.reshape(-1, ly, lx) for f in fields])
        (ry, rx), (iy, ix) = self.shape, self.coords
        if ry > 1 or wrap:
            flat = self._exchange(flat, halo, -2, iy, ry,
                                  lambda k: self.rank_at(k, ix), wrap)
        if rx > 1 or wrap:
            flat = self._exchange(flat, halo, -1, ix, rx,
                                  lambda k: self.rank_at(iy, k), wrap)
        out, i = [], 0
        for f in fields:
            n = math.prod(f.shape[:-2])
            out.append(flat[i:i + n].reshape(*f.shape[:-2],
                                             *flat.shape[-2:]))
            i += n
        return out

    def _exchange(self, f, halo, axis, i, n, peer, wrap=False):
        """f with ``halo`` cells of each neighbour along ``axis`` on either
        side: the last cells of rank i - 1 before, the first of rank i + 1
        after; at the domain's edge zeros, or with ``wrap`` the opposite
        side's cells past the overlap cell (cells 1 .. halo of rank 0
        after the last rank, the cells before the last one of the last
        rank before rank 0)."""
        m = f.shape[axis]
        if m < halo + wrap:
            raise ValueError(f"a block of {m} cells cannot give its "
                             f"neighbours a halo of {halo}")
        # what goes down (to rank i - 1) and up (to rank i + 1): past the
        # edge of a wrap, the cells beside the overlap cell
        down = f.narrow(axis, 1 if wrap and i == 0 else 0, halo)
        up = f.narrow(axis, m - halo - (1 if wrap and i == n - 1 else 0),
                      halo)
        if n == 1:
            parts = (up, down) if wrap else (torch.zeros_like(up),
                                             torch.zeros_like(down))
            return torch.cat([parts[0], f, parts[1]], dim=axis)
        down, up = self._host(down.contiguous()), self._host(up.contiguous())
        before, after = torch.zeros_like(up), torch.zeros_like(down)
        lo, hi = wrap or i > 0, wrap or i < n - 1
        below, above = peer((i - 1) % n), peer((i + 1) % n)
        # tags tell apart the two messages between the ranks of a 2-rank
        # wrap; NCCL matches a pair's messages in this order
        ops = []
        if lo:
            ops.append(dist.P2POp(dist.isend, down, below, self.group, 1))
        if hi:
            ops += [dist.P2POp(dist.irecv, after, above, self.group, 1),
                    dist.P2POp(dist.isend, up, above, self.group, 2)]
        if lo:
            ops.append(dist.P2POp(dist.irecv, before, below, self.group, 2))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.cat([self._back(before, f), f, self._back(after, f)],
                         dim=axis)

    def unpad(self, o, halo: int, wrap: bool = False):
        """The block of a slab padded by ``halo`` (JAX's ``_unpad``): along
        the split axes, or with ``wrap`` along both."""
        ry, rx = self.shape
        if ry > 1 or wrap:
            o = o[..., halo:-halo, :]
        if rx > 1 or wrap:
            o = o[..., :, halo:-halo]
        return o.contiguous()

    def overlap_copy(self, fields, tile: bool = False):
        """The doubly-periodic box's overlap copy on the blocks of the
        same-shape tensors ``fields``: the last column takes column 0 (from
        the rank that holds it), then the last row takes row 0 as it was
        before the column copy (``bcs.periodic_bc``'s order: the corner
        takes the old (0, Nx - 1)), or with ``tile`` as it is after it
        (``ops.poisson.tile_overlap``'s: the corner takes (0, 0)). Returns
        new tensors."""
        (ry, rx), (iy, ix) = self.shape, self.coords
        f = torch.stack(fields)
        row0 = f[..., :1, :].clone() if iy == 0 and not tile else None
        col = self._send_line(f[..., :, :1] if ix == 0 else None,
                              (iy, 0), (iy, rx - 1), f, -1)
        if ix == rx - 1:
            f[..., :, -1:] = col
        if iy == 0 and tile:
            row0 = f[..., :1, :]
        row = self._send_line(row0, (0, ix), (ry - 1, ix), f, -2)
        if iy == ry - 1:
            f[..., -1:, :] = row
        return list(f.unbind(0))

    def _send_line(self, line, src, dst, like, axis):
        """The tensor ``line`` (``like``'s shape, one cell along ``axis``)
        of mesh place ``src`` at mesh place ``dst``: returned there, None
        elsewhere."""
        me = self.coords
        if src == dst or me not in (src, dst):
            return line if me == dst else None
        if me == src:
            dist.send(self._host(line.contiguous()), self.rank_at(*dst),
                      self.group)
            return None
        shape = list(like.shape)
        shape[axis] = 1
        t = self._host(torch.empty(shape, dtype=like.dtype,
                                   device=like.device))
        dist.recv(t, self.rank_at(*src), self.group)
        return self._back(t, like)

    def _gather(self, t, group, n, axis):
        if n == 1:
            return t
        parts = [torch.empty_like(self._host(t)) for _ in range(n)]
        dist.all_gather(parts, self._host(t.contiguous()), group=group)
        return self._back(torch.cat(parts, dim=axis), t)

    def gather_rows(self, f):
        """The column strip (..., Ny, lx): the blocks of the ranks that
        share this rank's ix, in iy order."""
        return self._gather(f, self.col_group, self.shape[0], -2)

    def gather_cols(self, f):
        """The row strip (..., ly, Nx): the blocks of the ranks that share
        this rank's iy, in ix order."""
        return self._gather(f, self.row_group, self.shape[1], -1)

    def gather(self, f):
        """The whole field from every rank's block (on every rank)."""
        return self.gather_cols(self.gather_rows(f))

    def _reduce(self, x, op):
        t = self._host(x.reshape(-1).clone())
        dist.all_reduce(t, op=op, group=self.group)
        return self._back(t, x).reshape(x.shape)

    def max(self, x):
        """The elementwise max of ``x`` over the ranks, on the device."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def min(self, x):
        """The elementwise min of ``x`` over the ranks, on the device."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def sum(self, x):
        """The 0-d sum of ``x`` over the ranks, added in rank order on every
        rank, so that every rank holds the same value."""
        t = self._host(x.reshape(1))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return self._back(total, x).reshape(())

    def mean(self, f):
        """The mean of a field over the whole grid from the blocks."""
        return self.sum(torch.sum(f)) / (f.numel() * self.size)

    def stencil(self, fn, halo: int = STENCIL_HALO):
        """``fn`` (a plain op of whole fields: its array edges are the
        domain's) on this rank's blocks: every (ly, lx) tensor argument is
        padded by ``halo`` (one exchange), ``fn`` runs on the domain's cells
        of the slabs (``ops.slab.on_slab``: the BC and the closures at the
        domain's edge, a ghost beyond each cut) and each slab result is cut
        back to the block. ``fn`` must read no further than ``halo``."""
        from pyrmt_tpu_torch.ops.slab import on_slab

        def run(*args):
            ref = next(a for a in args if isinstance(a, torch.Tensor)
                       and a.dim() >= 2)
            shape = tuple(ref.shape[-2:])
            idx = [i for i, a in enumerate(args)
                   if isinstance(a, torch.Tensor) and a.dim() >= 2
                   and tuple(a.shape[-2:]) == shape]
            padded = self.pad([args[i] for i in idx], halo)
            slabs = list(args)
            for i, p in zip(idx, padded):
                slabs[i] = p
            ly, lx = shape
            ry, rx = self.shape
            out = on_slab(fn, slabs, {}, **self.offsets(ly * ry, lx * rx,
                                                         halo))
            full = tuple(padded[0].shape[-2:])
            if isinstance(out, (tuple, list)):
                return type(out)(
                    self.unpad(o, halo) if isinstance(o, torch.Tensor)
                    and tuple(o.shape[-2:]) == full else o for o in out)
            return self.unpad(out, halo)

        return run


def mesh_shape(n: int) -> tuple[int, int]:
    """The near-square (ry, rx) mesh of n ranks, JAX's factoring: ry the
    largest divisor of n not above sqrt(n)."""
    ry = int(math.sqrt(n))
    while n % ry:
        ry -= 1
    return ry, n // ry


def slab_of(f, shape, coords, halo: int):
    """Mesh place ``coords`` of a ``shape`` mesh: its block of the whole
    field ``f`` (..., Ny, Nx) padded by ``halo`` cells along each split
    axis as ``Mesh.pad`` pads it (the neighbours' cells, zeros beyond the
    domain), and the kernels' sharding operands of that slab. The
    one-process view of the halo exchange, for checks."""
    import torch.nn.functional as F

    Ny, Nx = f.shape[-2:]
    mesh = Mesh(tuple(shape), tuple(coords))
    rows, cols = mesh.block(Ny, Nx)
    hy = halo if shape[0] > 1 else 0
    hx = halo if shape[1] > 1 else 0
    padded = F.pad(f, (hx, hx, hy, hy))
    slab = padded[..., rows.start:rows.stop + 2 * hy,
                  cols.start:cols.stop + 2 * hx].contiguous()
    return slab, mesh.offsets(Ny, Nx, halo)


def make_mesh(world_size: int | None = None, shape=None,
              group=None) -> Mesh | None:
    """This rank's place in the (ry, rx) mesh of the group's ranks
    (``mesh_shape``, or ``shape``), with its row and column groups. Every
    rank of the group must call it (it creates the sub-groups). A
    ``shape`` of fewer ranks than the default group's takes its first
    ry * rx ranks (a group of its own), and the others get None."""
    n = dist.get_world_size(group) if world_size is None else world_size
    ry, rx = mesh_shape(n) if shape is None else shape
    sub = group is None and world_size is None and ry * rx < n
    if sub:
        n = ry * rx
        group = dist.new_group(list(range(n)))
    if ry * rx != n:
        raise ValueError(f"a {ry}x{rx} mesh needs {ry * rx} ranks, not {n}")
    if group is None or sub:
        ranks = list(range(n))
    else:
        ranks = [dist.get_global_rank(group, r) for r in range(n)]
    rank = dist.get_rank() if sub else dist.get_rank(group)
    iy, ix = divmod(rank, rx)
    row_group = col_group = None
    for y in range(ry):  # every rank creates every group, in one order
        g = dist.new_group([ranks[y * rx + x] for x in range(rx)])
        if y == iy:
            row_group = g
    for x in range(rx):
        g = dist.new_group([ranks[y * rx + x] for y in range(ry)])
        if x == ix:
            col_group = g
    if sub and rank >= n:
        return None
    return Mesh(shape=(ry, rx), coords=(iy, ix), group=group,
                row_group=row_group, col_group=col_group,
                backend=dist.get_backend(group))


def state_sharding(mesh: Mesh, Ny: int, Nx: int, rebasing: bool = False,
                   S: int = 1):
    """This rank's block of each SimState field as an index, None for a
    replicated one (JAX's NamedShardings): the fields' rows and columns,
    the solid stacks' on their grid axes, the scalars replicated, and an
    empty stack replicated (the (0, Ny, Nx) maps of a pure-fluid state,
    phis0 without rebasing)."""
    from pyrmt_tpu_torch.sim import SimState

    rows, cols = mesh.block(Ny, Nx)
    field = (rows, cols)
    stack = (slice(None), rows, cols)
    maps = stack if S > 0 else None
    return SimState(u=field, v=field, p=field, X1=maps, X2=maps, t=None,
                    step=None, phis0=stack if rebasing else None)


def _normalize_phis0(state):
    """A legacy ``phis0=None`` as the canonical empty (0, Ny, Nx) stack."""
    if state.phis0 is not None:
        return state
    return dataclasses.replace(
        state, phis0=torch.zeros((0,) + tuple(state.u.shape),
                                 dtype=state.u.dtype, device=state.u.device))


def shard_state(state, mesh: Mesh):
    """This rank's block of a whole SimState (``state_sharding``), each
    block a contiguous copy."""
    state = _normalize_phis0(state)
    Ny, Nx = state.u.shape
    spec = state_sharding(mesh, Ny, Nx, rebasing=state.phis0.shape[0] > 0,
                          S=state.X1.shape[0])
    out = {}
    for f in dataclasses.fields(state):
        val, idx = getattr(state, f.name), getattr(spec, f.name)
        out[f.name] = val if idx is None else val[idx].contiguous()
    return type(state)(**out)


def gather_state(state, mesh: Mesh):
    """The whole SimState from every rank's block (on every rank; for
    tests and I/O); an empty stack comes back as (0, Ny, Nx)."""
    Ny, Nx = (n * r for n, r in zip(state.u.shape, mesh.shape))
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is not None and val.dim() >= 2:
            val = (mesh.gather(val) if val.numel() else
                   val.new_zeros(val.shape[:-2] + (Ny, Nx)))
        out[f.name] = val
    return type(state)(**out)


def make_rmt_block_sharded(mesh: Mesh, Ny: int, Nx: int, num_layers: int,
                           impl=None):
    """An ``rmt_block_impl`` for ``sim.make_step`` that runs ``impl``
    (default ``kernels.rmt_block.rmt_block_fused``: the kernel on a CUDA
    block, its plain twin on a CPU one; ``rmt_block_plain`` for the plain
    twin on either) per rank on its block padded by 4 num_layers + 4
    exchanged cells on both mesh axes, with the sharding offsets, and cuts
    the halo off the 12 results."""
    from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_fused

    impl = impl or rmt_block_fused
    halo = 4 * num_layers + 4
    offsets = mesh.offsets(Ny, Nx, halo)

    def rmt_impl(u, v, X1s, X2s, dt, **kw):
        outs = impl(*mesh.pad([u, v, X1s, X2s], halo), dt, **kw, **offsets)
        return tuple(mesh.unpad(o, halo) for o in outs)

    return rmt_impl


def make_advext_block_sharded(mesh: Mesh, Ny: int, Nx: int, num_layers: int,
                              impl=None):
    """An ``advext_impl`` for ``sim.make_step`` (the split tier): ``impl``
    (default ``kernels.rmt_block.advext_block_fused``: the kernel on a
    CUDA block, its plain twin on a CPU one; ``advext_block_plain`` for
    the plain twin on either) per rank on its block of u, v, the maps and
    the level sets padded by 4 num_layers + 4 exchanged cells on both mesh
    axes, with the sharding offsets, the halo cut off the two results."""
    from pyrmt_tpu_torch.kernels.rmt_block import advext_block_fused

    impl = impl or advext_block_fused
    halo = 4 * num_layers + 4
    offsets = mesh.offsets(Ny, Nx, halo)

    def advext_impl(u, v, X1s, X2s, phis, dt, **kw):
        outs = impl(*mesh.pad([u, v, X1s, X2s, phis], halo), dt, **kw,
                    **offsets)
        return tuple(mesh.unpad(o, halo) for o in outs)

    return advext_impl


def make_momentum_rk4_sharded(mesh: Mesh, Ny: int, Nx: int, impl=None):
    """A ``momentum_rk4_impl`` for ``sim.make_step``: ``impl`` (default
    ``kernels.momentum_rk4.momentum_rk4_fused``; ``physics.momentum_core``
    for the plain twin) per rank on its block of the 9 fields and the
    force padded by the RK4 kernel's 8-cell halo (JAX's _HALO), with the
    sharding offsets.

    On the doubly-periodic box (``periodic=True``) the plain stage loop
    (``physics.momentum_core(periodic=True)``) whatever ``impl`` is, as
    JAX keeps XLA there: the overlap copy of u and v across the ranks
    (``Mesh.overlap_copy``, the periodic BC), the fields padded by an
    8-cell wrap halo on both axes, the stage loop on the slabs (its wrap
    stencils read the halo, its BC the identity: the stage values stay
    overlap-consistent), the halo cut off and the overlap copy again."""
    from pyrmt_tpu_torch.bcs import noop_bc
    from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_fused
    from pyrmt_tpu_torch.physics import RK4_HALO, momentum_core

    impl = impl or momentum_rk4_fused
    halo = RK4_HALO
    offsets = mesh.offsets(Ny, Nx, halo)

    def momentum_impl(u, v, p, sxx, sxy, syy, Hf, rho, mkv, velocity_bc, *,
                      f_ext_x=None, f_ext_y=None, periodic=False, **kw):
        if periodic:
            u, v = mesh.overlap_copy([u, v])
        fields = [u, v, p, sxx, sxy, syy, Hf, rho, mkv]
        if f_ext_x is not None:
            fields += [f_ext_x, f_ext_y]
        padded = mesh.pad(fields, halo, wrap=periodic)
        force = (dict(f_ext_x=padded[9], f_ext_y=padded[10])
                 if f_ext_x is not None else {})
        if periodic:
            u_new, v_new = momentum_core(*padded[:9], noop_bc, **force,
                                         **kw, periodic=True)
            return mesh.overlap_copy([mesh.unpad(u_new, halo, wrap=True),
                                      mesh.unpad(v_new, halo, wrap=True)])
        u_new, v_new = impl(*padded[:9], velocity_bc, **force, **kw,
                            **offsets)
        return mesh.unpad(u_new, halo), mesh.unpad(v_new, halo)

    return momentum_impl


def _local(mesh: Mesh, Ny: int, Nx: int, halo: int):
    """(ly, lx), or None where the grid does not divide the mesh or a
    split axis's block is smaller than ``halo``."""
    ry, rx = mesh.shape
    if Ny % ry or Nx % rx:
        return None
    ly, lx = Ny // ry, Nx // rx
    if (ry > 1 and ly < halo) or (rx > 1 and lx < halo):
        return None
    return ly, lx


def rmt_block_sharded_supported(mesh: Mesh, Ny: int, Nx: int,
                                num_layers: int, S: int, phi_inits=None):
    """The sharded solid-block kernel needs at least one solid, the grid to
    divide both mesh axes and blocks of at least the exchange halo
    (4 num_layers + 4) along each split axis; with ``phi_inits`` the
    level sets the kernel evaluates (``rmt_block_supported``). JAX's row
    tiling condition is its TPU kernel's: the CUDA kernel tiles any
    extent."""
    from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_supported

    if S < 1 or _local(mesh, Ny, Nx, 4 * num_layers + 4) is None:
        return False
    return phi_inits is None or rmt_block_supported(phi_inits)


def advext_block_sharded_supported(mesh: Mesh, Ny: int, Nx: int,
                                   num_layers: int, S: int):
    """The sharded split-tier kernel needs at least one solid, the grid to
    divide both mesh axes and blocks of at least the exchange halo
    (4 num_layers + 4) along each split axis; it takes phi as a field, so
    any level set."""
    return S >= 1 and _local(mesh, Ny, Nx, 4 * num_layers + 4) is not None


def momentum_rk4_sharded_supported(mesh: Mesh, Ny: int, Nx: int,
                                   velocity_bc):
    """The sharded RK4 kernel needs a wall BC with a ``kernel_spec`` (the
    periodic box's wrap is the whole field's), the grid to divide both
    mesh axes and blocks of at least 8 cells along each split axis."""
    from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_supported
    from pyrmt_tpu_torch.physics import RK4_HALO

    spec = getattr(velocity_bc, "kernel_spec", None)
    if spec is None or spec[0] == "periodic":
        return False
    return (_local(mesh, Ny, Nx, RK4_HALO) is not None
            and momentum_rk4_supported(velocity_bc))


def check_slice(cfg, velocity_bc, phi_inits, traced_params=None) -> None:
    """Raise NotImplementedError for a configuration that this port does
    not shard yet (JAX shards it by GSPMD alone), naming its ROADMAP item:
    ``traced_params`` (16.6), the general tier (16.4) and surface tension
    on the periodic box (16.7); ValueError for a periodic box whose BC and
    ``bc_type`` disagree (the sharded box's overlap copy is
    ``bcs.periodic_bc``'s)."""
    from pyrmt_tpu_torch.sim import _rmt_advect_fusible

    S = len(phi_inits)
    why = None
    if traced_params is not None:
        why = "traced_params (sharded gradients)", 6
    elif S > 0 and not _rmt_advect_fusible(cfg, S):
        why = ("the general tier (WENO5, central2, sl_local=False, "
               "CFL >= 1)"), 4
    elif cfg.gamma > 1e-12 and cfg.bc_type == "periodic":
        why = "surface tension on the periodic box", 7
    if why is not None:
        raise NotImplementedError(
            f"the sharded step does not yet take {why[0]}: JAX shards it "
            f"by GSPMD alone; see {ROADMAP_ITEM}.{why[1]}")
    wrap_bc = (getattr(velocity_bc, "kernel_spec", None) or ("",))[0] \
        == "periodic"
    if wrap_bc != (cfg.bc_type == "periodic"):
        raise ValueError(
            "the sharded periodic box takes bc_type='periodic' with "
            "bcs.periodic_bc, and periodic_bc only there")


def make_sharded_step(cfg, velocity_bc, phi_inits, mesh: Mesh, dtype=None,
                      rmt_method=None, device="cuda", traced_params=None):
    """The FSI step of ``sim.make_step`` on this rank's block of the grid
    (JAX's make_sharded_step). Returns (step, shard): ``step(state,
    t_end)`` takes and returns this rank's block of the state
    (``shard_state``; ``gather_state`` puts the blocks together), and
    ``shard`` cuts a whole state.

    ``rmt_method``: 'pallas' runs the fused tier's solid-block kernel and
    the RK4 kernel per rank on an exchanged halo with the sharding offsets
    (the RK4 kernel where it applies the BC,
    ``momentum_rk4_sharded_supported``); 'xla' runs their plain twins
    with the same offsets; None picks 'pallas' on a CUDA state where it
    is supported, else 'xla', and on a CUDA state the RK4 kernel wherever
    it is supported (a pure-fluid step too) and the split tier's
    ``advext_block`` kernel (``make_advext_block_sharded``). An explicit
    'pallas' that is not supported (the split tier among others) raises
    ValueError, as in JAX. Everything else runs as plain ops
    (``extrap_method``, ``projection_method``, ``use_pallas_rhs`` forced
    to their plain paths, as JAX forces them) with the collectives of the
    module note. ``step.paths`` gains 'mesh' (the mesh and the process
    group's backend) and 'halo' ('host-staged' where the exchanges and
    gathers go through host copies, else 'direct').

    Sharded: walls (any BC; the kernels' where it has a ``kernel_spec``)
    and the doubly-periodic box (``bcs.periodic_bc``, its momentum the
    plain stage loop on wrap-padded slabs, its FFT solve distributed);
    the pure fluid; the fused tier (1 to 16 discs or ellipses, bilinear
    or bicubic); the split tier (reinit 'pde' on exchanged halos, 'fmm'
    on the gathered level set, the area fix, map rebasing, any level
    set); contact and gravity; surface tension on walls (the cell CSF or
    the balanced CSF with its face forces, any curvature; the forces on
    ``force_halo`` slabs, ``step.paths['forces']``); the Neumann DCT
    projection and the variable-density CG. ``check_slice`` raises for
    the rest. A split axis's blocks must hold the largest halo the step
    exchanges (the ValueError names it).
    """
    from pyrmt_tpu_torch.kernels.rmt_block import (
        advext_block_plain,
        rmt_block_plain,
        rmt_block_supported,
    )
    from pyrmt_tpu_torch.ops.levelset import REINIT_CHUNK
    from pyrmt_tpu_torch.physics import RK4_HALO, momentum_core
    from pyrmt_tpu_torch.sim import (
        make_step,
        rmt_block_fusible,
        rmt_block_split_eligible,
    )

    dtype = dtype or torch.float32
    phi_inits = tuple(phi_inits)
    S = len(phi_inits)
    Ny, Nx = cfg.grid.Ny, cfg.grid.Nx
    supported = (rmt_block_fusible(cfg, S) and rmt_block_sharded_supported(
        mesh, Ny, Nx, cfg.num_layers, S, phi_inits))
    on_card = torch.device(device).type == "cuda"
    auto = rmt_method is None
    if auto:
        rmt_method = "pallas" if on_card and supported else "xla"
    if rmt_method not in ("pallas", "xla"):
        raise ValueError(f"unknown rmt_method {rmt_method!r}")
    if rmt_method == "pallas" and not supported:
        # an explicit 'pallas' request never silently downgrades
        raise ValueError(
            "sharded solid-block kernel unsupported for this config/mesh/"
            "grid; see sim.rmt_block_fusible + rmt_block_sharded_supported")
    check_slice(cfg, velocity_bc, phi_inits, traced_params)
    periodic = cfg.bc_type == "periodic"
    # the split tier, as make_step picks it: post-processing of phi, or a
    # level set the fused kernel does not evaluate
    split = rmt_block_split_eligible(cfg, S) or (
        rmt_block_fusible(cfg, S) and not rmt_block_supported(phi_inits))
    halo = max(4 * cfg.num_layers + 4 if S else 0, RK4_HALO,
               force_halo(cfg),
               REINIT_CHUNK if split and cfg.reinit_method == "pde" else 0)
    # the periodic box's wrap halo (the RK4 stage loop's 8 cells) goes
    # along both axes, and its edge rank sends the cells beside its
    # overlap cell
    if _local(mesh, Ny, Nx, halo) is None or (
            periodic and min(Ny // mesh.shape[0], Nx // mesh.shape[1])
            < RK4_HALO + 1):
        raise ValueError(
            f"a {Ny}x{Nx} grid on a {mesh.shape} mesh: the grid must divide "
            f"the mesh and each split axis's block hold at least the halo "
            f"of {halo} cells that its neighbours exchange (the periodic "
            f"box's blocks {RK4_HALO + 1} along both axes)")
    kernels = rmt_method == "pallas"
    # the RK4 kernel on its own support test, so that a step whose solid
    # block takes no kernel (a pure-fluid one) still takes it on the card
    mom_kernel = (kernels or (auto and on_card)) and \
        momentum_rk4_sharded_supported(mesh, Ny, Nx, velocity_bc)
    adv_kernel = auto and on_card and split and \
        advext_block_sharded_supported(mesh, Ny, Nx, cfg.num_layers, S)
    rmt_impl = make_rmt_block_sharded(
        mesh, Ny, Nx, cfg.num_layers, impl=None if kernels
        else rmt_block_plain)
    mom_impl = make_momentum_rk4_sharded(
        mesh, Ny, Nx, impl=None if mom_kernel else momentum_core)
    adv_impl = make_advext_block_sharded(
        mesh, Ny, Nx, cfg.num_layers, impl=None if adv_kernel
        else advext_block_plain)
    cfg = dataclasses.replace(
        cfg, extrap_method="xla", momentum_method="auto", rmt_method="xla",
        projection_method="xla", use_pallas_rhs=False)
    # no solid-block hook on the split tier: make_step then sends a level
    # set the fused kernel does not evaluate there
    step = make_step(cfg, velocity_bc, phi_inits, dtype=dtype, device=device,
                     rmt_block_impl=None if split else rmt_impl,
                     momentum_rk4_impl=mom_impl, advext_impl=adv_impl,
                     mesh=mesh)
    where = "slabs with offsets"
    if S == 0:
        solid = "none"
    elif split:
        solid = (f"split, advext_block "
                 f"{'kernel' if adv_kernel else 'plain twin'} on {where}")
    else:
        solid = f"fused, {'kernel' if kernels else 'plain twin'} on {where}"
    momentum = ("stage loop on wrap-padded slabs" if periodic else
                f"rk4 {'kernel' if mom_kernel else 'plain twin'} on {where}")
    projection = {"fft": "wrap-padded stencils, distributed FFT",
                  "cg": "stencils on halo slabs, CG with a distributed DCT "
                        "preconditioner",
                  "faces": "stencils and face forces on halo slabs, "
                           "distributed DCT"}.get(
        step.paths["projection"], "stencils on halo slabs, distributed DCT")
    if cfg.gamma > 1e-12 and S > 0:
        csf = ("balanced CSF, faces in the block layout"
               if cfg.st_method == "balanced" else "cell CSF")
        step.paths["forces"] = (f"surface tension ({csf}, "
                                f"{cfg.st_curvature} curvature) on "
                                f"{force_halo(cfg)}-cell halo slabs")
    step.paths.update(
        solid=solid, momentum=momentum, projection=projection,
        mesh=f"{mesh.shape[0]}x{mesh.shape[1]} {mesh.backend}",
        halo="host-staged" if mesh.staged(device) else "direct")

    def shard(state):
        return shard_state(state, mesh)

    return step, shard
