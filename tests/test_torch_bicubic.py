"""Bicubic sampling in the port against the JAX package.

- The four interp ops (``cubic_convolution``, ``gather_bicubic_local`` with
  and without ``cubic_mask``, ``gather_bicubic_multi``,
  ``bicubic_interpolate``) and the bicubic
  ``advect_semilagrangian_rk4_local`` on float64 inputs made from a numpy
  seed: displacements past the +-1 clip, queries outside the domain,
  stencils clipped at every edge, non-finite displacements and queries.
  1e-13.
- ``rmt_block_plain`` with ``sl_interp='bicubic'`` against the JAX kernel
  ``rmt_block_fused(..., interpret=True)``: the recipe of
  tests/test_pallas.py (N=64, the disc overlapping the right edge, so the
  stencil clips there), band-guarded (``sl_guard`` 3 dx) and raw
  (``sl_guard=None``): 1e-13 (J 1e-12). Two solids with the clamp are in
  tests/test_torch_bicubic_two_solids.py.

The CUDA kernels are held to these plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py). The split tier's block and the
steps are in tests/test_torch_bicubic_step.py, so that the files run side
by side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.kernels.rmt_block as jrb
import pyrmt_tpu.ops.advect as jadv
import pyrmt_tpu.ops.interp as jint
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.kernels.rmt_block as rb
import pyrmt_tpu_torch.ops.advect as tadv
import pyrmt_tpu_torch.ops.interp as tint
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu.sim import RMTConfig as JConfig
from pyrmt_tpu.sim import make_init_state as j_init
from test_torch_bicubic_step import bent_advext_case

torch.set_num_threads(1)

ATOL = 1e-13
NAMES = ("X1e", "X2e", "phis", "sxx", "sxy", "syy", "J", "Hf", "rho_local",
         "sig_sxx_el", "sig_sxy_el", "sig_syy_el")
K, NY, NX = 2, 13, 17


def close(t, j, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol, err_msg=what)


def samples(seed=0):
    """A (K, NY, NX) stack, displacements in (-1.3, 1.3) with NaN and inf
    planted, and a random band-guard mask."""
    rng = np.random.default_rng(seed)
    us = rng.standard_normal((K, NY, NX))
    sx, sy = rng.uniform(-1.3, 1.3, (2, NY, NX))
    sx[2, 3] = np.nan
    sy[5, 0] = np.inf
    sx[NY - 1, 4] = -np.inf
    mask = rng.uniform(size=(K, NY, NX)) < 0.6
    return us, sx, sy, mask


def queries(seed=1, n=(9, 11)):
    """Physical query points over and past the unit domain, with NaN and
    inf planted, and the spacings of a (NY, NX) grid on it."""
    rng = np.random.default_rng(seed)
    xq, yq = rng.uniform(-0.15, 1.15, (2,) + n)
    xq[1, 2] = np.nan
    yq[4, 7] = np.inf
    xq[0, 0], yq[0, 0] = 1.0, 1.0  # the last node itself
    return xq, yq, 1.0 / (NX - 1), 1.0 / (NY - 1)


def test_cubic_convolution_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((5, 7, 3))
    t = rng.uniform(size=(7, 3))
    close(tint.cubic_convolution(*torch.tensor(v[:4]), torch.tensor(t)),
          jint.cubic_convolution(*jnp.asarray(v[:4]), jnp.asarray(t)))


@pytest.mark.parametrize("masked", [False, True], ids=["raw", "guarded"])
def test_gather_bicubic_local_matches_jax(masked):
    us, sx, sy, mask = samples()
    m = mask if masked else None
    ref = jint.gather_bicubic_local(
        jnp.asarray(us), jnp.asarray(sx), jnp.asarray(sy),
        cubic_mask=None if m is None else jnp.asarray(m))
    out = tint.gather_bicubic_local(
        torch.tensor(us), torch.tensor(sx), torch.tensor(sy),
        cubic_mask=None if m is None else torch.tensor(m))
    assert tuple(out.shape) == (K, NY, NX)
    nan = np.isnan(np.asarray(ref))
    assert np.array_equal(np.isnan(out.numpy()), nan) and nan.any()
    close(np.nan_to_num(out.numpy()), np.nan_to_num(np.asarray(ref)))
    # the sample stays inside its stencil's range: no overshoot
    assert np.nanmax(np.abs(out.numpy())) <= np.abs(us).max()
    if masked:  # where the mask is False the sample is the bilinear one
        raw = tint.gather_bicubic_local(
            torch.tensor(us), torch.tensor(sx), torch.tensor(sy)).numpy()
        differ = (np.nan_to_num(raw) != np.nan_to_num(out.numpy()))
        assert differ.any() and not (differ & mask).any()


@pytest.mark.parametrize("masked", [False, True], ids=["raw", "guarded"])
def test_gather_bicubic_multi_matches_jax(masked):
    us, _, _, _ = samples()
    # the JAX function takes queries of the fields' shape only
    xq, yq, dx, dy = queries(n=(NY, NX))
    m = np.random.default_rng(3).uniform(size=(K,) + xq.shape) < 0.5
    ref = jint.gather_bicubic_multi(
        jnp.asarray(us), jnp.asarray(xq), jnp.asarray(yq), dx, dy,
        cubic_mask=jnp.asarray(m) if masked else None)
    out = tint.gather_bicubic_multi(
        torch.tensor(us), torch.tensor(xq), torch.tensor(yq), dx, dy,
        cubic_mask=torch.tensor(m) if masked else None)
    assert tuple(out.shape) == (K,) + xq.shape
    assert np.array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(ref)))
    close(np.nan_to_num(out.numpy()), np.nan_to_num(np.asarray(ref)))


def test_bicubic_interpolate_matches_jax():
    us, _, _, _ = samples()
    xq, yq, dx, dy = queries(seed=4)
    ref = jint.bicubic_interpolate(jnp.asarray(us[0]), jnp.asarray(xq),
                                   jnp.asarray(yq), dx, dy)
    out = pt.bicubic_interpolate(torch.tensor(us[0]), torch.tensor(xq),
                                 torch.tensor(yq), dx, dy)
    assert np.array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(ref)))
    close(np.nan_to_num(out.numpy()), np.nan_to_num(np.asarray(ref)))
    # the node itself is reproduced exactly
    assert float(out[0, 0]) == us[0, -1, -1]


def advection_case(seed=5, N=24):
    """A smooth velocity at a sub-cell CFL, a stack of two smooth fields
    with noise, and a band-guard mask."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    a, b, c = rng.standard_normal(3)
    u = 0.4 * np.sin(np.pi * X + c) * np.cos(np.pi * Y)
    v = -0.4 * np.cos(np.pi * X) * np.sin(np.pi * Y + a)
    qs = np.stack([np.sin(3 * X + b) * Y, np.cos(2 * Y) + X * X])
    qs = qs + 0.05 * rng.standard_normal(qs.shape)
    dx = 1.0 / (N - 1)
    dt = 0.8 * dx / 0.4
    mask = np.broadcast_to(rng.uniform(size=(N, N)) < 0.5, qs.shape)
    return qs, u, v, dt, dx, mask


@pytest.mark.parametrize("masked", [False, True], ids=["raw", "guarded"])
def test_bicubic_advection_matches_jax(masked):
    qs, u, v, dt, dx, mask = advection_case()
    ref = jadv.advect_semilagrangian_rk4_local(
        *(jnp.asarray(a) for a in (qs, u, v)), dt, dx, dx, interp="bicubic",
        cubic_mask=jnp.asarray(mask) if masked else None)
    out = tadv.advect_semilagrangian_rk4_local(
        *(torch.tensor(a) for a in (qs, u, v)), dt, dx, dx, interp="bicubic",
        cubic_mask=torch.tensor(mask) if masked else None)
    close(out, ref)
    bil = tadv.advect_semilagrangian_rk4_local(
        *(torch.tensor(a) for a in (qs, u, v)), dt, dx, dx)
    assert float((out - bil).abs().max()) > 1e-4  # the samples differ


def test_unknown_interpolant_raises_as_in_jax():
    qs, u, v, dt, dx, _ = advection_case()
    with pytest.raises(ValueError, match="Unknown semi-Lagrangian"):
        jadv.advect_semilagrangian_rk4_local(
            *(jnp.asarray(a) for a in (qs, u, v)), dt, dx, dx,
            interp="quintic")
    with pytest.raises(ValueError, match="Unknown semi-Lagrangian"):
        tadv.advect_semilagrangian_rk4_local(
            *(torch.tensor(a) for a in (qs, u, v)), dt, dx, dx,
            interp="quintic")


def j_disc(x0, y0, R):
    return lambda X, Y: jnp.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R


def block_case(discs, N=64):
    """The fused tier's operands in both packages: the maps of
    ``discs`` from the JAX package's make_init_state, a Taylor-Green
    velocity, dt = 1e-3 (tests/test_pallas.py's recipe), with the maps
    bent by a smooth third of a cell (on the identity map the bicubic and
    the bilinear samples agree)."""
    g = JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    cfg = JConfig(grid=g, mu_s=0.1, eta_s=0.01, rho_s=1.0, mu_f=0.01,
                  rho_f=1.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    jphis = tuple(j_disc(*d) for d in discs)
    state = j_init(cfg, jphis, dtype=jnp.float64)
    X, Y = g.coords(dtype=jnp.float64)
    u = 0.3 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v = -0.3 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    bend = g.dx / 3 * jnp.sin(3 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    jargs = (u, v, state.X1 + bend, state.X2 - bend.T, 1e-3)
    jkw = dict(phi_inits=jphis, dx=g.dx, dy=g.dy, num_layers=3, w_t=cfg.w_t,
               mu_s=0.1, kappa=0.0, rho_s=1.0, rho_f=1.0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    targs = tuple(t(a) for a in jargs)
    tkw = dict(phi_inits=tuple(pt.Disc(*d) for d in discs), dx=g.dx,
               dy=g.dy, num_layers=3, w_t=cfg.w_t,
               params=t([0.1, 0.0, 1.0, 1.0]))
    return g, (jargs, jkw), (targs, tkw)


EDGE = ((0.85, 0.5, 0.2),)  # overlaps the right edge
TWO = ((0.3, 0.45, 0.15), (0.68, 0.55, 0.15))


def block_runs_of(case):
    """(JAX kernel in interpret mode, the port's plain version, the plain
    version with the bilinear sample) outputs of a bicubic ``case``:
    'guarded' or 'raw' on the edge disc, or 'two solids' (guarded, with
    the two-solid clamp 4) at N=32: the interpret-mode kernel takes ~3x
    as long per solid."""
    two = case == "two solids"
    g, (jargs, jkw), (targs, tkw) = block_case(TWO if two else EDGE,
                                               32 if two else 64)
    guard = None if case == "raw" else 3.0 * g.dx
    clamp = 4.0 if two else 0.0
    ref = jrb.rmt_block_fused(*jargs, **jkw, stress_clamp=clamp,
                              sl_interp="bicubic", sl_guard=guard,
                              interpret=True)
    out = rb.rmt_block_plain(*targs, **tkw, stress_clamp=clamp,
                             sl_interp="bicubic", sl_guard=guard)
    bil = rb.rmt_block_plain(*targs, **tkw, stress_clamp=clamp)
    return ([np.asarray(r) for r in ref], [o.numpy() for o in out],
            [o.numpy() for o in bil])


@pytest.fixture(scope="module", params=["guarded", "raw"])
def block_runs(request):
    return block_runs_of(request.param)


def check_block(runs, i):
    ref, out, _ = runs
    assert out[i].shape == ref[i].shape
    close(out[i], ref[i], 1e-12 if NAMES[i] == "J" else ATOL, NAMES[i])


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_plain_bicubic_rmt_block_matches_pallas_interpret(block_runs, i):
    check_block(block_runs, i)


def test_bicubic_block_differs_from_bilinear(block_runs):
    _, out, bil = block_runs
    assert np.abs(out[0] - bil[0]).max() > 1e-8


def test_wrappers_take_the_plain_versions_and_refuse_unknown_samples():
    """On CPU tensors both wrappers run their plain versions with the new
    sample and launch nothing; an unknown sl_interp raises ValueError."""
    u, v, X1s, X2s, phis, dt = (torch.tensor(np.asarray(a))
                                for a in bent_advext_case())
    dx = 1.0 / (u.shape[0] - 1)
    kw = dict(dx=dx, dy=dx, num_layers=3, sl_interp="bicubic",
              sl_guard=3 * dx)
    before = (rb.launches, rb.advext_launches)
    for a, b in zip(rb.advext_block_fused(u, v, X1s, X2s, phis, dt, **kw),
                    rb.advext_block_plain(u, v, X1s, X2s, phis, dt, **kw)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sl_interp"):
        rb.advext_block_fused(u, v, X1s, X2s, phis, dt,
                              **dict(kw, sl_interp="quintic"))
    params = torch.tensor([0.1, 0.0, 1.0, 1.0], dtype=torch.float64)
    bkw = dict(phi_inits=(pt.Disc(0.6, 0.5, 0.2),), dx=dx, dy=dx,
               num_layers=3, w_t=2 * dx, params=params)
    with pytest.raises(ValueError, match="sl_interp"):
        rb.rmt_block_fused(u, v, X1s, X2s, dt, **bkw, sl_interp="Bicubic")
    for a, b in zip(rb.rmt_block_fused(u, v, X1s, X2s, dt, **bkw,
                                       sl_interp="bicubic"),
                    rb.rmt_block_plain(u, v, X1s, X2s, dt, **bkw,
                                       sl_interp="bicubic")):
        assert torch.equal(a, b)
    assert (rb.launches, rb.advext_launches) == before
