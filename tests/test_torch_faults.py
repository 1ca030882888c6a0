"""The port's faults F1-F4 (ROADMAP §3), each held where it was wrong.

- F1: a velocity BC without a ``kernel_spec`` takes the plain RK4 stage
  loop (and, with ``projection_method='pallas'``, the plain projection
  stencils), as the JAX step takes XLA's where ``momentum_rk4_supported``
  and ``projection_stencils_supported`` are False; it steps to the result
  of the same BC with its spec. The kernels themselves keep raising.
- F2: a level set the fused tier's kernel does not evaluate (a torch
  callable that is neither a Disc nor an Ellipse, or more than 16 solids)
  takes the split tier, which gives ``rmt_block_plain``'s results.
- F3: the port stepping a state made by the JAX package under the 'cond'
  rebuild: phis0 within a few ulps of the port's seed reads as the seed,
  so three steps agree with JAX to 1e-12 (p to 1e-11); before, every
  solid read as rebased (u off by 1.2e-9).
- F4: ``make_run_chunk`` and ``make_rebase_runner`` take ``donate=`` as
  ``bench.py`` passes it.
- F7: a float32 run whose ``t_end`` rounds down (0.01) stops at t_end as
  float32 holds it (``sim.stop_time``): ``run_until`` and the
  ``taylor_green_decay`` and ``density_contrast`` loops. Each test bounds
  the steps at 10x the float64 run's, so it fails, and does not hang,
  where the loop would run no-op steps forever.
- F8: positional calls in the JAX package's order bind JAX's parameters
  (``reinitialize_phi_PDE``'s ``apply_phi_BCs_func``, ``solve_poisson_dct``'s
  ``dct_mats, precision, demean``, ``pressure_projection``'s ``bc_type``
  to ``st_faces``, ``make_step``'s ``rmt_block_impl``) and give JAX's
  results.
- F9: the interpolators take JAX's ``Nx, Ny``, checked against the field.
The card's side of F1 and F2 is in tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch.kernels import _build
from pyrmt_tpu_torch.kernels.momentum_rk4 import momentum_rk4_supported
from pyrmt_tpu_torch.kernels.rmt_block import (
    rmt_block_plain,
    rmt_block_supported,
)
from test_torch_split_step import (
    assert_trajectories_match,
    jax_config,
    trajectories,
)

torch.set_num_threads(1)
DEV = "cpu"
N = 48
KW = dict(dtype=torch.float64, device=DEV)
LID = pt.make_lid_bc(1.0)


def lid_without_spec(u, v):
    """The lid BC as a user would write it: no kernel_spec."""
    return LID(u, v)


def rounded_square(X1, X2):
    """A rounded square of half-width 0.15 about (0.55, 0.5), radius 0.05:
    a level set the fused tier's kernel does not evaluate."""
    qx = torch.clamp(torch.abs(X1 - 0.55) - 0.1, min=0.0)
    qy = torch.clamp(torch.abs(X2 - 0.5) - 0.1, min=0.0)
    inside = torch.clamp(torch.maximum(torch.abs(X1 - 0.55),
                                       torch.abs(X2 - 0.5)) - 0.1, max=0.0)
    return torch.sqrt(qx * qx + qy * qy) + inside - 0.05


def flagship(**over):
    return pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                        mu_f=0.01, **over)


def run(step, state, n=3):
    for _ in range(n):
        state, aux = step(state, 1.0)
    return state, aux


def assert_states_equal(a, b):
    for k in ("u", "v", "p", "X1", "X2", "t"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("projection", ["auto", "pallas"])
def test_f1_bc_without_spec_takes_the_plain_blocks(projection):
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    cfg = flagship(projection_method=projection)
    assert momentum_rk4_supported(LID)
    assert not momentum_rk4_supported(lid_without_spec)
    step = pt.make_step(cfg, lid_without_spec, disc, **KW)
    assert step.paths["momentum"] == "stage loop"
    assert step.paths["projection"] == "stencils"
    ref = pt.make_step(cfg, LID, disc, **KW)
    assert ref.paths["momentum"] == "rk4 kernel"
    assert ref.paths["projection"] == ("stencil kernels"
                                       if projection == "pallas"
                                       else "stencils")
    s0 = pt.make_init_state(cfg, disc, **KW)
    assert_states_equal(run(step, s0)[0], run(ref, s0)[0])
    with pytest.raises(ValueError, match="kernel_spec"):
        _build.bc_operands("momentum_rk4", lid_without_spec)


def test_f2_other_level_sets_take_the_split_tier():
    cfg = flagship()
    assert not rmt_block_supported((rounded_square,))
    assert rmt_block_supported((pt.Ellipse(0.5, 0.5, 0.2, 0.15),))
    step = pt.make_step(cfg, LID, (rounded_square,), **KW)
    assert step.paths["solid"] == "split"
    ref = pt.make_step(cfg, LID, (rounded_square,),
                       rmt_block_impl=rmt_block_plain, **KW)
    assert ref.paths["solid"] == "fused"
    s0 = pt.make_init_state(cfg, (rounded_square,), **KW)
    (s, aux), (s_ref, aux_ref) = run(step, s0), run(ref, s0)
    assert_states_equal(s, s_ref)
    for k in ("phis", "J", "sxx", "rho_local"):
        assert torch.equal(aux[k], aux_ref[k]), k
    assert float(s.u.abs().max()) > 0.0


def test_f2_more_solids_than_the_kernel_takes():
    discs = tuple(pt.Disc(0.15 + 0.2 * (i % 4), 0.15 + 0.2 * (i // 4), 0.04)
                  for i in range(17))
    cfg = flagship(num_layers=3)
    assert not rmt_block_supported(discs)
    assert rmt_block_supported(discs[:16])
    assert pt.make_step(cfg, LID, discs, **KW).paths["solid"] == "split"
    assert pt.make_step(cfg, LID, discs[:16], **KW).paths["solid"] == "fused"


@pytest.mark.parametrize("minj", [1e-9, 10.0])
def test_f3_jax_made_state_steps_as_in_jax(minj):
    """tests/test_torch_rebase.py's recipe under the 'cond' rebuild, from
    the JAX package's make_init_state (its phis0 a few cells an ulp off
    the port's seed): no rebase fires (1e-9) or one fires every step
    (10), and the port follows JAX either way."""
    jcfg = jax_config(mu_s=0.02, map_rebase_minj=minj,
                      map_rebase_rebuild="cond")
    j_traj, t_traj = trajectories(jcfg)
    assert_trajectories_match(j_traj, t_traj)
    fired = [bool(aux["rebased"].any()) for _, aux in t_traj]
    assert fired == [minj == 10.0] * len(fired)


def test_f3_a_rebased_phis0_still_reads_as_rebased():
    """A phis0 moved by more than the seed tolerance in one cell takes the
    sampled rebuild; within it, the analytic one."""
    disc = pt.Disc(0.55, 0.5, 0.2)
    cfg = flagship(map_rebase_minj=1e-9)
    X, Y = cfg.grid.coords(**KW)
    seed = disc(X, Y)
    rebuild = pt.sim._make_rebuild(cfg, (disc,), X, Y, torch.float64)
    X1 = (X + 0.3 * cfg.grid.dx)[None]
    X2 = Y[None]
    analytic = disc(X1[0], X2[0])
    eps = torch.finfo(torch.float64).eps
    near = seed + eps * seed.abs()           # an ulp off: the seed
    far = seed.clone()
    far[10, 10] += 1e-9                      # a rebased field
    assert torch.equal(rebuild(X1, X2, near[None])[0], analytic)
    assert not torch.equal(rebuild(X1, X2, far[None])[0], analytic)


def test_f4_runners_take_donate():
    """bench.py's call shapes: make_run_chunk(step, n, donate=...) and
    make_rebase_runner(..., dtype=..., donate=...); the caller chains
    states, and the input state stays valid."""
    disc = (pt.Disc(0.6, 0.5, 0.2),)
    cfg = flagship()
    step = pt.make_step(cfg, LID, disc, **KW)
    s0 = pt.make_init_state(cfg, disc, **KW)
    u0 = s0.u.clone()
    chunk = pt.make_run_chunk(step, 2, donate=True)
    s, t = chunk(s0, 1.0)
    assert int(s.step) == 2 and float(t) > 0.0 and torch.equal(s0.u, u0)
    rcfg = dataclasses.replace(cfg, map_rebase_minj=1e-9)
    runner = pt.make_rebase_runner(rcfg, LID, disc, 2, dtype=torch.float64,
                                   device=DEV, donate=True)
    s, _ = runner(pt.make_init_state(rcfg, disc, **KW), 1.0)
    assert int(s.step) == 2 and not runner.post
    np.testing.assert_array_equal(s.X1.shape, (1, N, N))


# F7: a float32 run to a t_end that float32 rounds down

T_END = 0.01
F32 = dict(dtype=torch.float32, device=DEV)


def bounded(make_step, limit, calls):
    """``make_step`` whose steps raise past ``limit`` calls in all (a
    loop that would run no-op steps forever fails instead)."""

    def make(*args, **kw):
        step = make_step(*args, **kw)

        def counted(state, t_end):
            calls.append(1)
            if len(calls) > limit:
                raise RuntimeError(f"the loop ran past {limit} steps")
            return step(state, t_end)

        return counted

    return make


def tg_box(dtype):
    """The S = 0 doubly-periodic box at N=17 with the Taylor-Green
    vortex: (step, state)."""
    from pyrmt_tpu_torch.validation import gates

    cfg = gates.taylor_green_config(17)
    kw = dict(dtype=dtype, device=DEV)
    u0, v0 = gates.taylor_green_velocity(cfg, 0.5, **kw)
    return (pt.make_step(cfg, pt.periodic_bc, (), **kw),
            pt.make_init_state(cfg, (), u0=u0, v0=v0, **kw))


def test_f7_run_until_stops_at_float32_t_end():
    """10 steps (dt 1e-3), as in float64, not max_steps; the state is the
    10th step's, the last that advanced t."""
    t_stop = float(torch.tensor(T_END, dtype=torch.float32))
    counts = {}
    for dtype in (torch.float64, torch.float32):
        step, s0 = tg_box(dtype)
        calls = []
        s, bad = pt.run_until(bounded(lambda: step, 100, [])(), s0, T_END,
                              callback=lambda s, aux: calls.append(1))
        counts[dtype] = len(calls)
        assert not bad
    assert counts[torch.float32] == counts[torch.float64] == 10
    assert float(s.t) == t_stop < T_END
    assert pt.sim.stop_time(T_END, torch.float32) == t_stop
    ref = s0
    for _ in range(10):
        ref, _ = step(ref, T_END)
    assert_states_equal(s, ref)


@pytest.mark.parametrize("case", ["taylor_green_decay", "density_contrast"])
def test_f7_gate_loops_stop_at_float32_t_end(case, monkeypatch):
    """The two loops of ``validation.gates`` end at float32(t_end) after
    the chunks of the float64 run; the last row's time and state are the
    last advancing step's (5 steps a chunk)."""
    from pyrmt_tpu_torch.validation import gates

    fn = getattr(gates, case)
    kw = dict(N=17 if case == "taylor_green_decay" else 24, t_end=T_END,
              log_every=5, device=DEV)
    rows64, s64 = fn(dtype=torch.float64, **kw)
    calls = []
    monkeypatch.setattr(gates, "make_step",
                        bounded(gates.make_step, 10 * s64["steps"], calls))
    rows, s = fn(dtype=torch.float32, **kw)
    assert s["steps"] == s64["steps"] == len(calls)
    assert rows[-1]["t"] == pt.sim.stop_time(T_END, torch.float32)
    assert len(rows) == len(rows64)


# F8: JAX-order positional calls


def test_f8_reinitialize_phi_pde_takes_the_hook_fifth():
    import jax.numpy as jnp
    import pyrmt_tpu.ops.levelset as jls

    from pyrmt_tpu_torch.ops import levelset as tls

    X, Y = pt.Grid(24, 24, 1.0, 1.0).coords(**KW)
    phi = torch.sqrt((X - 0.45) ** 2 + (Y - 0.5) ** 2) ** 1.3 - 0.2
    dx = 1.0 / 23
    out = tls.reinitialize_phi_PDE(phi, dx, dx, 5, tls.apply_phi_BCs, 0.3)
    ref = jls.reinitialize_phi_PDE(jnp.asarray(phi.numpy()), dx, dx, 5,
                                   jls.apply_phi_BCs, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13)
    mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        tls.reinitialize_phi_PDE(phi, dx, dx, 5, tls.apply_phi_BCs,
                                 mesh=mesh)


def test_f8_solve_poisson_dct_takes_jax_s_order():
    import jax.numpy as jnp
    import pyrmt_tpu.ops.poisson as jp

    from pyrmt_tpu_torch.ops import poisson as tp

    rng = np.random.default_rng(0)
    Ny, Nx, dx, dy = 17, 21, 0.05, 1.0 / 16
    rhs = rng.standard_normal((Ny, Nx))
    eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, device=DEV)
    jeig = jp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    for demean in (True, False):
        ref = np.asarray(jp.solve_poisson_dct(jnp.asarray(rhs), jeig, None,
                                              "highest", demean))
        for m in (None, mats):
            out = tp.solve_poisson_dct(torch.tensor(rhs), eig, m, "highest",
                                       demean)
            np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                       atol=1e-13 * np.abs(ref).max())
    for precision in ("high", "default"):
        with pytest.raises(ValueError, match="precision"):
            tp.solve_poisson_dct(torch.tensor(rhs), eig, mats, precision)


@pytest.mark.parametrize("variant", ["incremental", "variable_rho",
                                     "no p_prev"])
def test_f8_pressure_projection_takes_jax_s_order(variant):
    """Every JAX parameter positionally, bc_type to st_faces included."""
    import jax.numpy as jnp
    import pyrmt_tpu.bcs as jbcs
    import pyrmt_tpu.ops.poisson as jp
    from pyrmt_tpu.ops.projection import pressure_projection as jproj

    from pyrmt_tpu_torch.ops import poisson as tp
    from pyrmt_tpu_torch.ops.projection import pressure_projection

    rng = np.random.default_rng(1)
    n = 25
    dx = 1.0 / (n - 1)
    X, Y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    a = 0.3 * np.sin(2 * np.pi * X) * np.cos(np.pi * Y) + 0.01 * \
        rng.standard_normal((n, n))
    b = -0.2 * np.cos(np.pi * X) * np.sin(2 * np.pi * Y)
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    rho = 1.0 + 0.3 * (np.hypot(X - 0.6, Y - 0.5) <= 0.2)
    var = variant == "variable_rho"
    p_prev = None if variant == "no p_prev" else p
    common = ("neumann", var, 1e-10, 100)
    ref = jproj(jnp.asarray(a), jnp.asarray(b), dx, dx, 2e-3,
                jnp.asarray(rho), jbcs.make_lid_bc(1.0),
                None if p_prev is None else jnp.asarray(p_prev),
                jp.precompute_poisson_eigenvalues(n, n, dx, dx), *common,
                None, None, False, "highest", var, None)
    t = torch.tensor
    out = pressure_projection(
        t(a), t(b), dx, dx, t(2e-3, dtype=torch.float64), t(rho), LID,
        None if p_prev is None else t(p_prev),
        tp.precompute_poisson_eigenvalues(n, n, dx, dx, device=DEV), *common,
        tp.precompute_dct_matrices(n, n, torch.float64, DEV), None, False,
        "highest", var, None)
    assert len(out) == len(ref) == (4 if var else 3)
    for o, r in zip(out[:3], ref[:3]):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-11 * max(1.0, np.abs(r).max()))
    if var:
        assert int(out[3][0]) == int(ref[3][0]) > 0


def test_f8_stencil_bc_spec_takes_the_stencil_pair_and_its_bc():
    """A ``stencil_bc_spec`` takes the stencil kernels' wrappers (their
    plain versions on a CPU tensor) with the spec's BC, as JAX's applies
    the BC from the spec; on the card it launches the kernels
    (tests/test_torch_cuda.py)."""
    from pyrmt_tpu_torch.ops import poisson as tp
    from pyrmt_tpu_torch.ops.projection import pressure_projection

    rng = np.random.default_rng(2)
    n, dx = 17, 1.0 / 16
    a, b, p = (torch.tensor(rng.standard_normal((n, n))) for _ in range(3))
    eig = tp.precompute_poisson_eigenvalues(n, n, dx, dx, device=DEV)
    args = (a, b, dx, dx, torch.tensor(1e-3, dtype=torch.float64), 1.2)
    lid = pressure_projection(*args, LID, p, eig)
    spec = pressure_projection(*args, pt.noop_bc, p, eig,
                               stencil_bc_spec=("lid", 1.0),
                               stencil_interpret=True)
    for x, y in zip(lid, spec):
        assert torch.equal(x, y)


# F9: the interpolators' Nx, Ny


@pytest.mark.parametrize("name", ["bilinear_interpolate",
                                  "bicubic_interpolate"])
def test_f9_interpolators_take_nx_ny(name):
    import jax.numpy as jnp
    import pyrmt_tpu.ops.interp as jint

    rng = np.random.default_rng(3)
    Ny, Nx, dx, dy = 13, 17, 1.0 / 16, 1.0 / 12
    u = rng.standard_normal((Ny, Nx))
    xq, yq = rng.uniform(-0.1, 1.1, (2, 40))
    ref = getattr(jint, name)(jnp.asarray(u), jnp.asarray(xq),
                              jnp.asarray(yq), dx, dy, Nx, Ny)
    out = getattr(pt, name)(torch.tensor(u), torch.tensor(xq),
                            torch.tensor(yq), dx, dy, Nx, Ny)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13)
    with pytest.raises(ValueError, match="Nx, Ny"):
        getattr(pt, name)(torch.tensor(u), torch.tensor(xq),
                          torch.tensor(yq), dx, dy, Ny, Nx)
