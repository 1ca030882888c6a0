"""The port's variable-density projection against ``pyrmt_tpu``.

``ops.poisson.apply_variable_poisson`` (to 1e-13 of its size), the
symmetrised DCT-preconditioned CG ``solve_variable_poisson_cg_counted``
(the same iteration count as the JAX while-loop, p to 1e-10 of max |p|,
the relative residual to 1e-8 of itself), and the projection's
``variable_rho`` branch with ``cg_info``, each against its JAX function on
the same float64 inputs made from a numpy seed: a disc ten times as dense
as the fluid with a smoothed interface, and a divergence field. The port
reads the CG's stopping test every few iterations; the count is the same
for every spacing of the reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as j_bcs
import pyrmt_tpu.ops.poisson as jp
import pyrmt_tpu_torch.bcs as t_bcs
import pyrmt_tpu_torch.ops.poisson as tp
from pyrmt_tpu.ops.projection import pressure_projection as j_projection
from pyrmt_tpu_torch.ops.projection import pressure_projection

torch.set_num_threads(1)
DEV = "cpu"


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def case(Ny=48, Nx=40, ratio=10.0, seed=0):
    """(rhs, inv_rho, u*, v*, p_prev, rho, dx, dy): a disc of density
    ``ratio`` in fluid of density 1, a tanh interface two cells wide."""
    rng = np.random.default_rng(seed)
    dx, dy = 1.0 / (Nx - 1), 1.0 / (Ny - 1)
    X, Y = np.meshgrid(np.arange(Nx) * dx, np.arange(Ny) * dy)
    phi = np.hypot(X - 0.45, Y - 0.6) - 0.2
    rho = 1.0 + (ratio - 1.0) * 0.5 * (1.0 - np.tanh(phi / (2 * dx)))
    u = 0.2 * np.sin(np.pi * X) * np.cos(np.pi * Y) + 0.01 * rng.standard_normal(
        X.shape)
    v = -0.1 * np.cos(np.pi * X) * np.sin(2 * np.pi * Y)
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    rhs = rng.standard_normal(X.shape) + np.sin(3 * X) * np.cos(2 * Y)
    return rhs, 1.0 / rho, u, v, p, rho, dx, dy


def test_apply_variable_poisson_matches_jax():
    rhs, inv_rho, _, _, p, _, dx, dy = case()
    ref = np.asarray(jp.apply_variable_poisson(jnp.asarray(p),
                                               jnp.asarray(inv_rho), dx, dy))
    out = tp.apply_variable_poisson(tt(p), tt(inv_rho), dx, dy).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


def test_preconditioner_zeroes_the_constant_mode():
    """The pinned eigenvalue is +inf: the dense DCT solve takes the
    constant mode to exactly 0, not NaN, and keeps the mean otherwise."""
    Ny, Nx = 33, 25
    eig = tp.precompute_poisson_eigenvalues(Nx, Ny, 0.1, 0.1, torch.float64,
                                            DEV)
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    pinned = tp._pin_null_mode(eig)
    assert float(pinned[0, 0]) == float("inf")
    assert torch.equal(pinned.flatten()[1:], eig.flatten()[1:])
    const = torch.full((Ny, Nx), 3.0, dtype=torch.float64)
    out = tp.solve_poisson_dct(const, pinned, mats, demean=False)
    assert torch.isfinite(out).all() and float(out.abs().max()) < 1e-12


@pytest.mark.parametrize("tol,maxiter,ratio", [
    (1e-6, 200, 10.0), (1e-10, 200, 10.0), (1e-6, 200, 100.0),
    (1e-8, 5, 10.0), (1e-6, 200, 1.0)])
def test_cg_matches_jax(tol, maxiter, ratio, monkeypatch):
    rhs, inv_rho, _, _, _, _, dx, dy = case(ratio=ratio)
    Ny, Nx = rhs.shape
    eig = jp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    p_j, it_j, rr_j = jp.solve_variable_poisson_cg_counted(
        jnp.asarray(rhs), jnp.asarray(inv_rho), eig, dx, dy, tol=tol,
        maxiter=maxiter)
    t_eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, torch.float64,
                                              DEV)
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    p_j = np.asarray(p_j)
    for every in (1, 4, 7):
        monkeypatch.setattr(tp, "CG_READ_EVERY", every)
        p_t, it_t, rr_t = tp.solve_variable_poisson_cg_counted(
            tt(rhs), tt(inv_rho), t_eig, dx, dy, tol=tol, maxiter=maxiter,
            dct_mats=mats)
        assert int(it_t) == int(it_j), (every, int(it_t), int(it_j))
        assert it_t.dtype == torch.int32
        np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0,
                                   atol=1e-10 * np.abs(p_j).max())
        if ratio == 1.0:
            # constant density: the preconditioner is the exact inverse and
            # one iteration leaves a residual of the transforms' roundoff,
            # which the dense-matmul and FFT DCTs round apart (measured
            # 8.5e-14 against 3.3e-14): both at roundoff
            assert float(rr_t) < 1e-12 and float(rr_j) < 1e-12
        else:
            np.testing.assert_allclose(float(rr_t), float(rr_j), rtol=1e-8)
    if maxiter == 5:
        assert int(it_j) == 5 and float(rr_j) > tol
    else:
        assert 0 < int(it_j) < maxiter and float(rr_j) <= tol
    p_only = tp.solve_variable_poisson_cg(tt(rhs), tt(inv_rho), t_eig, dx,
                                          dy, tol=tol, maxiter=maxiter,
                                          dct_mats=mats)
    assert torch.equal(p_only, p_t)


def test_cg_counts_its_host_reads():
    """One host read per CG_READ_EVERY iterations begun: the read after
    the iteration that meets the tolerance sees the stop."""
    rhs, inv_rho, _, _, _, _, dx, dy = case()
    Ny, Nx = rhs.shape
    eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, torch.float64,
                                            DEV)
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    tp.cg_host_reads = 0
    _, it, _ = tp.solve_variable_poisson_cg_counted(
        tt(rhs), tt(inv_rho), eig, dx, dy, dct_mats=mats)
    assert int(it) > 0
    assert tp.cg_host_reads == -(-int(it) // tp.CG_READ_EVERY)


@pytest.mark.parametrize("bc", ["free_slip", "lid"])
def test_variable_projection_matches_jax(bc):
    _, _, u, v, p, rho, dx, dy = case(seed=3)
    Ny, Nx = u.shape
    dt = 2e-3
    j_bc = (j_bcs.free_slip_box_bc if bc == "free_slip"
            else j_bcs.make_lid_bc(1.0))
    t_bc = (t_bcs.free_slip_box_bc if bc == "free_slip"
            else t_bcs.make_lid_bc(1.0))
    eig = jp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    ref = j_projection(jnp.asarray(u), jnp.asarray(v), dx, dy, dt,
                       jnp.asarray(rho), j_bc, p_prev=jnp.asarray(p),
                       eigenvalues=eig, variable_rho=True, cg_tol=1e-8,
                       cg_maxiter=100, cg_info=True)
    out = pressure_projection(
        tt(u), tt(v), dx, dy, tt(dt), tt(rho), t_bc, tt(p),
        tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, torch.float64,
                                          DEV),
        tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV),
        variable_rho=True, cg_tol=1e-8, cg_maxiter=100, cg_info=True)
    for o, r, atol in zip(out[:3], ref[:3], (1e-12, 1e-12, 1e-10)):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=atol * max(1.0, np.abs(r).max()))
    assert int(out[3][0]) == int(ref[3][0]) > 0
    np.testing.assert_allclose(float(out[3][1]), float(ref[3][1]), rtol=1e-8)
    with pytest.raises(ValueError, match="cg_info"):
        pressure_projection(tt(u), tt(v), dx, dy, tt(dt), tt(rho), t_bc,
                            tt(p), None, None, cg_info=True)
    with pytest.raises(ValueError, match="st_faces"):
        pressure_projection(tt(u), tt(v), dx, dy, tt(dt), tt(rho), t_bc,
                            tt(p), None, None, bc_type="periodic",
                            st_faces=(None,) * 4)
