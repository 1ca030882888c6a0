"""The halos that the tile kernels rely on, held to the plain versions on
the CPU (float64, seeded numpy inputs).

The CUDA tile kernels (``rmt_block_fused``, ``momentum_rk4_fused``,
``advext_block_fused``, ``velocity_rhs_blended_fused``, ``rc_rhs_fused``,
``grad_correct_fused``, ``extrapolate_reference_map_fused``) compute each
output tile from a panel of the tile plus a halo; a result there is right
only if no input
outside the halo can reach it. So each plain function's dependency radius
is the halo its kernel relies on:

- ``rmt_block_plain``: 4L + 4 cells (L = num_layers): the stress reads the
  map at +-1, each extrapolation sweep a 9x9 window, the advection +-1 of
  a sub-cell backtrace;
- ``physics.momentum_core``: 8 cells (four stages, +-2 each) off the
  domain's edge, and 9 inward from a cell on it (the one-sided closures
  reach 3 cells in, where the interior stencils reach 2); the kernel
  widens a tile cut short by the domain's end for that reason;
- ``advext_block_plain``: 4L + 1 cells: the sweeps' 9x9 windows and the
  advection's +-1 (the kernel's panel is the tile plus 4L + 1 each side);
- ``physics.velocity_rhs_blended``: 2 cells off the domain's edge (the
  3rd-order upwind, the divergence of a stress of central differences),
  3 inward from a cell on it (the one-sided closures);
- ``extrapolate_reference_map``: exactly 4L cells from a cell filled in
  the last sweep (each sweep reads a 9x9 window; the kernel's panel is the
  tile plus 4L each side);
- ``rc_rhs_plain``: exactly 2 cells from a cell off the boundary ring
  (the Rhie-Chow face at i + 1/2 reads the cell-centred dp/dx at i + 1,
  which reads p at i + 2), and 0 on the ring, where it is 0 for any
  finite rho;
- ``grad_correct_plain``: 1 cell off the domain's edge; on it, by BC: the
  no-op BC's one-sided closures reach 2 cells inward, the free-slip copy
  of row 1 (column 1) reaches 1 cell diagonally, and the lid (and the
  free-slip corner) gives constants;
- the tile-activity skips: where no disc(X1, X2) <= 0 lies within 4L + 4
  cells, the block's outputs are those of the zero map, which is what
  ``rmt_block_plain`` gives for X1 = X2 = 0, for any disc; where no
  phis <= 0 lies within 4L + 1 cells and the inputs are finite,
  ``advext_block_plain`` gives X1e = X2e = 0 for every solid; a cell that
  is known (phi < 0) or farther than L cells from every known cell keeps
  its X1, X2 in ``extrapolate_reference_map``, whatever they hold (the
  extrapolation kernel's tiles copy where no cell can change).

Also: the entry points run on the card unless told otherwise, so without
CUDA their default device raises (with CUDA it is the card).
"""
import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.kernels.projection_stencils import (
    grad_correct_plain,
    rc_rhs_plain,
)
from pyrmt_tpu_torch.kernels.rmt_block import (
    advext_block_plain,
    rmt_block_plain,
)
from pyrmt_tpu_torch.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu_torch.physics import momentum_core, velocity_rhs_blended

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 64
FLAGSHIP = pt.Disc(0.6, 0.5, 0.2)
EDGE = pt.Disc(0.08, 0.9, 0.15)      # clipped by the domain's corner
ORIGIN = pt.Disc(0.1, 0.15, 0.3)     # holds the map's origin (0, 0)
SECOND = pt.Disc(0.25, 0.3, 0.12)    # a second solid, clear of FLAGSHIP


def t(a):
    return torch.tensor(a, dtype=torch.float64)


def outside(probe, h, shape=(N, N)):
    """1.0 outside the (2h+1)^2 window around probe, 0.0 inside."""
    j, i = probe
    m = np.ones(shape)
    m[max(0, j - h):j + h + 1, max(0, i - h):i + h + 1] = 0.0
    return m


def velocity(rng, shape=(N, N), amp=0.5):
    """A few random Fourier modes, max |u|, |v| = amp."""
    Ny, Nx = shape
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    u, v = np.zeros(shape), np.zeros(shape)
    for _ in range(4):
        kx, ky = rng.integers(1, 4, size=2)
        a, b, c = rng.standard_normal(3)
        u += a * np.sin(np.pi * kx * X + c) * np.cos(np.pi * ky * Y)
        v += b * np.cos(np.pi * kx * X) * np.sin(np.pi * ky * Y + c)
    s = amp / max(np.abs(u).max(), np.abs(v).max())
    return u * s, v * s


def block_case(disc, num_layers, seed=0, identity_map=False):
    """rmt_block_plain's operands: the disc's initial map (or the identity
    map everywhere) plus a sub-cell wobble, a velocity that moves 0.4
    cells per step."""
    rng = np.random.default_rng(seed)
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, kappa=0.5,
                       rho_s=1.3, mu_f=0.01, num_layers=num_layers)
    g = cfg.grid
    if identity_map:
        X, Y = g.coords(dtype=torch.float64, device=DEV)
        X1, X2 = X[None], Y[None]
    else:
        s = pt.make_init_state(cfg, (disc,), dtype=torch.float64, device=DEV)
        X1, X2 = s.X1, s.X2
    wob = 0.3 * g.dx * rng.standard_normal((2, N, N))
    u, v = velocity(rng)
    args = [t(u), t(v), X1 + t(wob[0]), X2 + t(wob[1]),
            t(0.4 * g.dx / 0.5)]
    kw = dict(phi_inits=(disc,), dx=g.dx, dy=g.dy, num_layers=num_layers,
              w_t=cfg.w_t, params=t([cfg.mu_s, cfg.kappa, cfg.rho_s,
                                     cfg.rho_f]))
    return args, kw


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("disc, probe", [
    (FLAGSHIP, (32, 51)),   # on the interface, x = 0.8
    (EDGE, (63, 12)),       # the interface where it meets the top edge
    (EDGE, (63, 0)),        # the solid's corner cell
], ids=["interface", "edge", "corner"])
def test_rmt_block_reaches_4L_plus_4(disc, probe, num_layers):
    """Perturbing u, v, X1, X2 only outside the (2h+1)^2 window, h = 4L+4,
    leaves all 12 outputs at the probe bit for bit."""
    args, kw = block_case(disc, num_layers)
    h = 4 * num_layers + 4
    rng = np.random.default_rng(7)
    far = t(outside(probe, h))
    pert = list(args)
    pert[0] = args[0] + far * t(0.5 * rng.standard_normal((N, N)))
    pert[1] = args[1] + far * t(0.5 * rng.standard_normal((N, N)))
    dX = 3.0 * kw["dx"] * rng.standard_normal((2, N, N))
    pert[2] = args[2] + far * t(dX[0])
    pert[3] = args[3] + far * t(dX[1])
    ref = rmt_block_plain(*args, **kw)
    out = rmt_block_plain(*pert, **kw)
    j, i = probe
    assert float(ref[0][0, j, i]) != 0.0  # the probe is in the map's band
    for o, r in zip(out, ref):
        assert torch.equal(o[..., j, i], r[..., j, i])
    # the perturbation reached everything outside the window
    assert not torch.equal(out[0], ref[0])


def momentum_case(seed=0, shape=(40, 40)):
    """momentum_core's nine fields: a velocity, a pressure, the blended
    fields of a disc at (0.6, 0.5) and seeded noise."""
    rng = np.random.default_rng(seed)
    Ny, Nx = shape
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    dx = 1.0 / (Nx - 1)
    u, v = velocity(rng, shape, amp=0.3)
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    phi = np.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2
    H = 0.5 * (1 + np.tanh(phi / (2 * dx)))
    sxx = (1.0 - H) * (1.0 + 0.1 * rng.standard_normal(shape))
    sxy = (1.0 - H) * 0.05 * rng.standard_normal(shape)
    syy = (1.0 - H) * (1.0 - 0.1 * X * Y)
    rho = H + (1.0 - H) * 1.2
    mkv = (phi <= 0).astype(np.float64) * (1.0 - H)
    return dx, [t(f) for f in (u, v, p, sxx, sxy, syy, H, rho, mkv)]


@pytest.mark.parametrize("probe", [(20, 21), (1, 17), (0, 23), (39, 0)],
                         ids=["interior", "next_to_edge", "on_edge",
                              "corner"])
@pytest.mark.parametrize("eta_s", [0.0, 0.01])
@pytest.mark.parametrize("bc", [pt.make_lid_bc(0.7), pt.free_slip_box_bc,
                                pt.noop_bc], ids=["lid", "free_slip", "noop"])
def test_momentum_reaches_8(bc, eta_s, probe):
    """Perturbing the nine fields only outside the (2h+1)^2 window leaves
    u_new, v_new at the probe bit for bit: h = 8 off the domain's edge,
    9 on it (its one-sided closures reach a cell further in)."""
    dx, fields = momentum_case()
    Ny, Nx = fields[0].shape
    j, i = probe
    h = 9 if j in (0, Ny - 1) or i in (0, Nx - 1) else 8
    rng = np.random.default_rng(3)
    far = t(outside(probe, h, (Ny, Nx)))
    pert = [f + far * t(0.1 * rng.standard_normal((Ny, Nx))) for f in fields]
    kw = dict(eta_s=eta_s, dx=dx, dy=dx, dt=t(2e-3), mu_f=0.01)
    ref = momentum_core(*fields, bc, **kw)
    out = momentum_core(*pert, bc, **kw)
    for o, r in zip(out, ref):
        assert torch.equal(o[j, i], r[j, i])
        assert not torch.equal(o, r)


@pytest.mark.parametrize("probe", [(20, 21), (1, 17), (0, 23), (39, 0)],
                         ids=["interior", "next_to_edge", "on_edge",
                              "corner"])
def test_velocity_rhs_reaches_2_off_the_edge_3_on_it(probe):
    """Perturbing the ten fields of the one RHS (with a random force) only
    outside the (2h+1)^2 window leaves rhs_u, rhs_v at the probe bit for
    bit, h = 2 off the domain's edge and 3 on it; perturbing them outside
    the window one cell smaller moves both."""
    dx, fields = momentum_case()
    u, v, p, sxx, sxy, syy, Hf, rho, _ = fields
    Ny, Nx = u.shape
    rng = np.random.default_rng(4)
    fx, fy = (t(0.01 * rng.standard_normal((Ny, Nx))) for _ in range(2))
    ins = [u, v, p, sxx, sxy, syy, Hf, rho, fx, fy]

    def rhs(f):
        return velocity_rhs_blended(*f[:6], dx, dx, 0.01, *f[6:])

    j, i = probe
    h = 3 if j in (0, Ny - 1) or i in (0, Nx - 1) else 2
    noise = [t(0.1 * rng.standard_normal((Ny, Nx))) for _ in ins]
    ref = rhs(ins)
    for r, same in ((h, True), (h - 1, False)):
        far = t(outside(probe, r, (Ny, Nx)))
        out = rhs([f + far * n for f, n in zip(ins, noise)])
        for o, q in zip(out, ref):
            assert torch.equal(o[j, i], q[j, i]) == same
            assert not torch.equal(o, q)


STENCIL_PROBES = {"interior": (20, 21), "next_to_edge": (1, 17),
                  "next_to_corner": (1, 1), "on_edge": (0, 23),
                  "on_side": (17, 0), "corner": (39, 0)}


def stencil_case(seed=0, shape=(40, 40)):
    """The projection stencils' fields: a*, b* (a few Fourier modes), a
    smooth pressure plus noise, a pressure correction of noise, a density
    1 .. 1.3 across a disc."""
    rng = np.random.default_rng(seed)
    Ny, Nx = shape
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny))
    a, b = velocity(rng, shape, amp=0.3)
    p = 0.05 * np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    p = p + 1e-3 * rng.standard_normal(shape)
    pc = 1e-3 * rng.standard_normal(shape)
    rho = 1.0 + 0.3 * (np.hypot(X - 0.6, Y - 0.5) < 0.2)
    return 1.0 / (Nx - 1), [t(f) for f in (a, b, p, pc, rho)]


def assert_stencil_reach(fn, ins, probe, h, seed):
    """Perturbing ``ins`` only outside the (2h+1)^2 window around the probe
    leaves every output of fn at the probe bit for bit, and perturbing them
    outside the window one cell smaller moves one; h None: the outputs at
    the probe do not move however every input moves, the probe's own
    included."""
    Ny, Nx = ins[0].shape
    j, i = probe
    rng = np.random.default_rng(seed)
    noise = [t(0.1 * rng.standard_normal((Ny, Nx))) for _ in ins]
    ref = fn(ins)
    cases = ((-1, True),) if h is None else ((h, True), (h - 1, False))
    for r, same in cases:
        far = t(outside(probe, r, (Ny, Nx))) if r >= 0 else 1.0
        out = fn([f + far * n for f, n in zip(ins, noise)])
        assert all(torch.equal(o[j, i], q[j, i])
                   for o, q in zip(out, ref)) == same
        assert not all(torch.equal(o, q) for o, q in zip(out, ref))


RC_RHS_REACH = {"interior": 2, "next_to_edge": 2, "next_to_corner": 2,
                "on_edge": None, "on_side": None, "corner": None}


@pytest.mark.parametrize("where", list(STENCIL_PROBES))
def test_rc_rhs_reaches_2_and_the_ring_is_0(where):
    """rc_rhs_plain at a cell off the boundary ring reads a*, b*, p and rho
    within exactly 2 cells; on the ring it is 0 whatever its inputs."""
    dx, (a, b, p, _, rho) = stencil_case()
    dt = t(2e-3)
    d = dt / rho.mean()

    def rc(f):
        return (rc_rhs_plain(*f, dt, d, dx, dx),)

    probe = STENCIL_PROBES[where]
    assert_stencil_reach(rc, [a, b, p, rho], probe, RC_RHS_REACH[where], 5)
    if RC_RHS_REACH[where] is None:
        assert float(rc([a, b, p, rho])[0][probe]) == 0.0


# (probe -> radius) of grad_correct_plain under each BC; None: constant
GRAD_CORRECT_REACH = {
    "noop": {"interior": 1, "next_to_edge": 1, "next_to_corner": 1,
             "on_edge": 2, "on_side": 2, "corner": 2},
    "lid": {"interior": 1, "next_to_edge": 1, "next_to_corner": 1,
            "on_edge": None, "on_side": None, "corner": None},
    "free_slip": {"interior": 1, "next_to_edge": 1, "next_to_corner": 1,
                  "on_edge": 1, "on_side": 1, "corner": None},
}
STENCIL_BCS = {"noop": pt.noop_bc, "lid": pt.make_lid_bc(0.7),
               "free_slip": pt.free_slip_box_bc}


@pytest.mark.parametrize("where", list(STENCIL_PROBES))
@pytest.mark.parametrize("bc_name", list(STENCIL_BCS))
def test_grad_correct_reach_by_bc(bc_name, where):
    """grad_correct_plain reads p_corr, a*, b* and rho within 1 cell of a
    cell off the domain's edge; on the edge the no-op BC's one-sided
    gradients reach 2 cells inward, the free-slip copy of row 1 (column 1)
    1 cell diagonally, and the lid gives constants."""
    dx, (a, b, _, pc, rho) = stencil_case(seed=1)
    dt = t(2e-3)
    bc = STENCIL_BCS[bc_name]

    def gc(f):
        return grad_correct_plain(*f, dt, dx, dx, bc)

    assert_stencil_reach(gc, [pc, a, b, rho], STENCIL_PROBES[where],
                         GRAD_CORRECT_REACH[bc_name][where], 6)


def advext_case(num_layers, solids, seed=0):
    """advext_block_plain's operands for the discs ``solids``: their
    initial maps plus a sub-cell wobble, each pre-advection phi the disc
    plus a sub-cell wobble, a velocity that moves 0.4 cells per step."""
    rng = np.random.default_rng(seed)
    cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1,
                       num_layers=num_layers)
    g = cfg.grid
    s = pt.make_init_state(cfg, solids, dtype=torch.float64, device=DEV)
    X, Y = g.coords(dtype=torch.float64, device=DEV)
    S = len(solids)
    wob = 0.3 * g.dx * rng.standard_normal((3, S, N, N))
    phis = torch.stack([d(X, Y) for d in solids]) + t(0.5 * wob[2])
    u, v = velocity(rng)
    args = [t(u), t(v), s.X1 + t(wob[0]), s.X2 + t(wob[1]), phis,
            t(0.4 * g.dx / 0.5)]
    return args, dict(dx=g.dx, dy=g.dy, num_layers=num_layers)


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("solids", [(FLAGSHIP,), (FLAGSHIP, SECOND)],
                         ids=["S1", "S2"])
def test_advext_block_reaches_4L_plus_1(solids, num_layers):
    """Perturbing u, v and every solid's X1, X2 and phi only outside the
    (2h+1)^2 window, h = 4L+1, leaves X1e, X2e of every solid at the probe
    (on the first disc's interface) bit for bit."""
    args, kw = advext_case(num_layers, solids)
    h = 4 * num_layers + 1
    probe = (32, 51)
    rng = np.random.default_rng(7)
    far = t(outside(probe, h))
    S = len(solids)
    pert = list(args)
    pert[0] = args[0] + far * t(0.5 * rng.standard_normal((N, N)))
    pert[1] = args[1] + far * t(0.5 * rng.standard_normal((N, N)))
    for k in (2, 3, 4):
        pert[k] = args[k] + far * t(3.0 * kw["dx"]
                                    * rng.standard_normal((S, N, N)))
    ref = advext_block_plain(*args, **kw)
    out = advext_block_plain(*pert, **kw)
    j, i = probe
    assert float(ref[0][0, j, i]) != 0.0  # the probe is in the map's band
    for o, r in zip(out, ref):
        assert torch.equal(o[:, j, i], r[:, j, i])
        assert not torch.equal(o, r)


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("solids", [(FLAGSHIP,), (FLAGSHIP, SECOND)],
                         ids=["S1", "S2"])
def test_advext_skip_is_the_zero_map(solids, num_layers):
    """Where no phis <= 0 of any solid lies within 4L + 1 cells and the
    inputs are finite, advext_block_plain gives X1e = X2e = 0 for every
    solid (by value: the plain version may hold -0.0 there)."""
    args, kw = advext_case(num_layers, solids)
    h = 4 * num_layers + 1
    solid = (args[4] <= 0.0).any(dim=0).to(torch.float64)
    near = torch.nn.functional.max_pool2d(solid[None, None], 2 * h + 1,
                                          stride=1, padding=h)[0, 0] > 0
    quiet = ~near
    assert 0 < int(quiet.sum()) < N * N - int(solid.sum())
    for out in advext_block_plain(*args, **kw):
        assert bool((out[:, quiet] == 0.0).all())
        assert bool((out[:, near] != 0.0).any())


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("disc, identity_map", [(FLAGSHIP, False),
                                                (ORIGIN, True)],
                         ids=["flagship", "origin_disc"])
def test_skip_is_the_zero_map(disc, identity_map, num_layers):
    """Where no disc(X1, X2) <= 0 lies within 4L + 4 cells, all 12 outputs
    equal rmt_block_plain's on the zero map X1 = X2 = 0. For a disc that
    holds the origin the zero map is solid (phi = disc(0, 0) <= 0), so
    the skip is not a constant fluid state."""
    args, kw = block_case(disc, num_layers, identity_map=identity_map)
    h = 4 * num_layers + 4
    solid = (disc(args[2][0], args[3][0]) <= 0.0).to(torch.float64)
    near = torch.nn.functional.max_pool2d(solid[None, None], 2 * h + 1,
                                          stride=1, padding=h)[0, 0] > 0
    quiet = ~near
    assert 0 < int(quiet.sum()) < N * N - int(solid.sum())
    zero = torch.zeros_like(args[2])
    out = rmt_block_plain(*args, **kw)
    ref = rmt_block_plain(args[0], args[1], zero, zero, args[4], **kw)
    assert (float(ref[2].max()) <= 0.0) == (disc is ORIGIN)
    for o, r in zip(out, ref):
        assert torch.equal(o[..., quiet], r[..., quiet])


def extrap_case(disc, seed=0):
    """extrapolate_reference_map's operands: the identity map and the disc,
    each plus a sub-cell wobble, so no two cells of a window agree."""
    rng = np.random.default_rng(seed)
    g = pt.Grid(N, N, 1.0, 1.0)
    X, Y = g.coords(dtype=torch.float64, device=DEV)
    wob = 0.3 * g.dx * rng.standard_normal((3, N, N))
    return [X + t(wob[0]), Y + t(wob[1]), disc(X, Y) + t(wob[2])], g.dx


@pytest.mark.parametrize("num_layers", [1, 3])
def test_extrapolate_reaches_4L(num_layers):
    """Perturbing X1, X2 and phi only outside the (2h+1)^2 window, h = 4L,
    leaves both outputs at the probe (on the interface's band, filled in
    the last sweep) bit for bit; perturbing them outside the window one
    cell smaller moves both."""
    args, dx = extrap_case(FLAGSHIP)
    L = num_layers
    probe = (32, 50 + L)  # the disc's edge is at i = 50.4 on row 32
    j, i = probe
    ref = extrapolate_reference_map(*args, dx, dx, L)
    before = extrapolate_reference_map(*args, dx, dx, L - 1)
    assert all(float(r[j, i]) != float(b[j, i]) for r, b in zip(ref, before))
    rng = np.random.default_rng(7)
    noise = [t(3.0 * dx * rng.standard_normal((N, N))) for _ in args]
    for h, same in ((4 * L, True), (4 * L - 1, False)):
        far = t(outside(probe, h))
        out = extrapolate_reference_map(
            *(a + far * n for a, n in zip(args, noise)), dx, dx, L)
        for o, r in zip(out, ref):
            assert torch.equal(o[j, i], r[j, i]) == same
            assert not torch.equal(o, r)


def bits(x):
    return x.view(torch.int64)


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("disc", [FLAGSHIP, EDGE], ids=["flagship", "edge"])
def test_extrapolate_skip_is_the_copy(disc, num_layers):
    """Known cells, and cells farther than L (Chebyshev) from every known
    cell, keep their X1, X2 bit for bit, NaN and infinities placed far from
    the solid included; the cells in between are the only ones that
    move."""
    (X1, X2, phi), dx = extrap_case(disc, seed=1)
    L = num_layers
    X1, X2 = X1.clone(), X2.clone()
    X1[2, 40], X2[5, 60] = float("nan"), float("inf")
    X1[60, 60], X2[3, 3] = float("-inf"), float("nan")
    known = phi < 0.0
    near = torch.nn.functional.max_pool2d(
        known.to(torch.float64)[None, None], 2 * L + 1, stride=1,
        padding=L)[0, 0] > 0
    keep = known | ~near
    assert 0 < int(keep.sum()) < N * N
    out = extrapolate_reference_map(X1, X2, phi, dx, dx, L)
    for o, x in zip(out, (X1, X2)):
        assert torch.equal(bits(o[keep]), bits(x[keep]))
        assert not torch.equal(bits(o[~keep]), bits(x[~keep]))
        assert bool(torch.isfinite(o[~keep]).all())


@pytest.mark.parametrize("entry", ["make_step", "make_init_state",
                                   "make_rebase_runner", "state_from_numpy",
                                   "create_grid"])
def test_entry_points_default_to_the_card(entry):
    """Without device=, an entry point puts its tensors on the card; on a
    machine without CUDA that raises (never a quiet CPU run)."""
    cfg = pt.RMTConfig(grid=pt.Grid(16, 16, 1.0, 1.0), mu_s=0.1,
                       map_rebase_minj=0.5)
    disc = pt.Disc(0.5, 0.5, 0.25)
    calls = {
        "make_step": lambda: pt.make_step(cfg, pt.make_lid_bc(1.0), (disc,)),
        "make_init_state": lambda: pt.make_init_state(cfg, (disc,)).u,
        "make_rebase_runner": lambda: pt.make_rebase_runner(
            cfg, pt.make_lid_bc(1.0), (disc,), 2).X,
        "state_from_numpy": lambda: pt.state_from_numpy(
            pt.state_to_numpy(pt.make_init_state(cfg, (disc,),
                                                 device=DEV))).u,
        "create_grid": lambda: pt.create_grid(16, 16, 1.0, 1.0)[0],
    }
    if torch.cuda.is_available():
        out = calls[entry]()
        if isinstance(out, torch.Tensor):
            assert out.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()
