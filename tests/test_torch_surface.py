"""The JAX package's public surface in the port: every name that
``pyrmt_tpu/__init__.py`` binds resolves in ``pyrmt_tpu_torch``, each
function takes JAX's parameters first, in JAX's order and under JAX's
names (the port's own follow as keywords; ``SIGNATURE_DEVIATIONS`` would
list a deviation with its reason), and the functions this slice
ported compute what their JAX twins compute, on the CPU in float64 at
N <= 33: 1e-13 of the field's size, ``create_grid`` bit for bit,
``build_poisson_matrix`` equal to JAX's ``.toarray()``.
"""
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu
import pyrmt_tpu.ops.fd as jfd
import pyrmt_tpu.ops.levelset as jls
import pyrmt_tpu.ops.poisson as jp
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.ops.fd as tfd
import pyrmt_tpu_torch.ops.levelset as tls
import pyrmt_tpu_torch.ops.poisson as tp
import pyrmt_tpu_torch.sim as tsim
from pyrmt_tpu.parallel import sharding as jsharding
from pyrmt_tpu_torch.parallel import sharding as tsharding

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

# every name the JAX package binds at its top level but its submodules
NAMES = sorted(n for n, v in vars(pyrmt_tpu).items()
               if not n.startswith("__")
               and not isinstance(v, types.ModuleType))
FUNCTIONS = [n for n in NAMES if inspect.isfunction(getattr(pyrmt_tpu, n))]
# the functions compared besides the top-level names: (JAX's, the port's)
RUNNERS = {"make_rebase_runner": (jsim.make_rebase_runner,
                                  tsim.make_rebase_runner),
           "make_sharded_step": (jsharding.make_sharded_step,
                                 tsharding.make_sharded_step)}
# name: the reason the port's leading parameters differ from JAX's (none
# does now: momentum_rk4_pallas takes the JAX kernel's and calls the port's
# momentum_rk4_fused)
SIGNATURE_DEVIATIONS = {}


def params(fn):
    return list(inspect.signature(fn).parameters)


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, rel=1e-13):
    """Within ``rel`` of the field's size (at least 1)."""
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                               atol=rel * max(1.0, np.abs(b).max()))


def field(Ny=33, Nx=25, seed=0):
    rng = np.random.default_rng(seed)
    x, y = np.linspace(0.0, 1.0, Nx), np.linspace(0.0, 1.0, Ny)
    X, Y = np.meshgrid(x, y)
    return (np.sin(3 * X) * np.cos(2 * Y) + 0.1 * rng.standard_normal(
        (Ny, Nx)), 1.0 / (Nx - 1), 1.0 / (Ny - 1))


@pytest.mark.parametrize("name", NAMES)
def test_every_jax_name_is_bound(name):
    assert hasattr(pt, name), name


def test_all_is_sorted_and_complete():
    public = {n for n, v in vars(pt).items() if not n.startswith("_")
              and not isinstance(v, types.ModuleType)}
    assert pt.__all__ == sorted(pt.__all__)
    assert set(pt.__all__) == public
    assert pt.__version__ == pyrmt_tpu.__version__ == "0.1.0"


@pytest.mark.parametrize("name", FUNCTIONS + sorted(RUNNERS))
def test_leading_parameters_are_jax_s(name):
    jfn, tfn = RUNNERS.get(name) or (getattr(pyrmt_tpu, name),
                                     getattr(pt, name))
    want, got = params(jfn), params(tfn)
    if name in SIGNATURE_DEVIATIONS:
        assert got[:len(want)] != want  # the entry is still needed
        return
    assert got[:len(want)] == want, (name, want, got)


@pytest.mark.parametrize("bc_spec, has_ext", [
    (("lid", 1.0), False), (("free_slip",), True), (("noop",), True)])
def test_momentum_rk4_pallas_takes_the_jax_kernel_s_call(bc_spec, has_ext):
    """The JAX kernel's positional call, its BC a ``bc_spec``, gives the
    JAX kernel's result (interpret mode) to 1e-13 of the field's size."""
    from pyrmt_tpu.kernels.momentum_rk4 import momentum_rk4_pallas

    rng = np.random.default_rng(1)
    N = 32
    u, v, p, sxx, sxy, syy, fx, fy = (
        field(N, N, seed)[0] for seed in range(8))
    Hf, mkv = rng.uniform(0.0, 1.0, (2, N, N))
    rho = 1.0 + 0.2 * rng.uniform(0.0, 1.0, (N, N))
    if not has_ext:
        fx = fy = np.zeros((N, N))
    args = (u, v, p, sxx, sxy, syy, Hf, rho, fx, fy, mkv)
    dx = 1.0 / (N - 1)
    scalars = (2e-4, dx, dx, 0.01, 0.05, bc_spec)
    want = momentum_rk4_pallas(*map(jnp.asarray, args), *scalars,
                               interpret=True, has_ext=has_ext)
    got = pt.momentum_rk4_pallas(*map(tt, args), *scalars, has_ext=has_ext)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("name", ["grad_central_x_4th", "grad_central_y_4th",
                                  "lap_2nd"])
def test_fd_stencils_match_jax(name):
    f, dx, dy = field()
    args = (dx, dy) if name == "lap_2nd" else (
        dx if name.endswith("x_4th") else dy,)
    close(getattr(tfd, name)(tt(f), *args),
          getattr(jfd, name)(jnp.asarray(f), *args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_create_grid_bit_for_bit(dtype):
    X, Y, dx, dy = pt.create_grid(25, 33, 1.0, 2.0, dtype=dtype, device=DEV)
    jX, jY, jdx, jdy = pyrmt_tpu.create_grid(
        25, 33, 1.0, 2.0, dtype=jnp.float32 if dtype == torch.float32
        else jnp.float64)
    gX, gY = pt.Grid(25, 33, 1.0, 2.0).coords(dtype=dtype, device=DEV)
    assert torch.equal(X, gX) and torch.equal(Y, gY)
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(Y.numpy(), np.asarray(jY))
    assert (dx, dy) == (jdx, jdy) and type(dx) is float


@pytest.mark.parametrize("name", ["dct1", "idct1", "dct1_2d", "idct1_2d"])
def test_fft_dct_matches_jax(name):
    f, _, _ = field()
    for kw in ({},) if name.endswith("2d") else ({}, {"axis": 0}):
        close(getattr(tp, name)(tt(f), **kw),
              getattr(jp, name)(jnp.asarray(f), **kw))


def test_matmul_dct_matches_jax():
    f, _, _ = field()
    Ny, Nx = f.shape
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    jmats = jp.precompute_dct_matrices(Nx, Ny, jnp.float64)
    for name in ("dct1_2d_matmul", "idct1_2d_matmul"):
        close(getattr(tp, name)(tt(f), mats),
              getattr(jp, name)(jnp.asarray(f), jmats))
    with pytest.raises(ValueError, match="precision"):
        tp.dct1_2d_matmul(tt(f), mats, "high")


@pytest.mark.parametrize("demean", [True, False])
def test_solve_poisson_dct_fft_path_matches_jax(demean):
    f, dx, dy = field()
    Ny, Nx = f.shape
    eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, device=DEV)
    jeig = jp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    ref = jp.solve_poisson_dct(jnp.asarray(f), jeig, demean=demean)
    close(tp.solve_poisson_dct(tt(f), eig, demean=demean), ref)
    # the matrix products give the same solve to roundoff
    mats = tp.precompute_dct_matrices(Nx, Ny, torch.float64, DEV)
    close(tp.solve_poisson_dct(tt(f), eig, mats, "highest", demean), ref)


def test_build_poisson_matrix_equals_jax():
    for Nx, Ny in ((5, 4), (9, 7)):
        dx, dy = 1.0 / (Nx - 1), 0.7 / (Ny - 1)
        A = tp.build_poisson_matrix(Nx, Ny, dx, dy, device=DEV)
        assert A.layout == torch.sparse_csr and A.dtype == torch.float64
        np.testing.assert_array_equal(
            A.to_dense().numpy(),
            jp.build_poisson_matrix(Nx, Ny, dx, dy).toarray())
    # the DCT eigenvalues diagonalise it: A applied to a DCT-I mode
    Nx, Ny, dx, dy = 9, 7, 0.125, 0.2
    A = tp.build_poisson_matrix(Nx, Ny, dx, dy, device=DEV)
    eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, device=DEV)
    ky, kx = 2, 3
    n = {N: torch.arange(N, dtype=torch.float64) for N in (Nx, Ny)}
    mode = torch.outer(torch.cos(torch.pi * ky * n[Ny] / (Ny - 1)),
                       torch.cos(torch.pi * kx * n[Nx] / (Nx - 1)))
    close((A @ mode.reshape(-1, 1)).reshape(Ny, Nx), eig[ky, kx] * mode,
          1e-12)


def test_compute_divergence_matches_jax():
    f, dx, dy = field()
    g, _, _ = field(seed=1)
    close(tp.compute_divergence(tt(f), tt(g), dx, dy),
          jp.compute_divergence(jnp.asarray(f), jnp.asarray(g), dx, dy))


def test_reinitialize_phi_fmm_matches_jax():
    f, dx, dy = field(17, 21)
    phi = f - 0.3
    out = pt.reinitialize_phi_fmm(tt(phi), dx, dy)
    close(out, pyrmt_tpu.reinitialize_phi_fmm(jnp.asarray(phi), dx, dy))
    # its 200 iterations: the PDE reinitialisation's
    assert torch.equal(out, tls.reinitialize_phi_PDE(tt(phi), dx, dy, 200))


def test_pde_reinit_periodic_hook_matches_jax():
    """JAX's ``apply_phi_BCs_func`` after each iteration, with the 3-cell
    periodic wrap of phi."""
    f, dx, dy = field(24, 24)
    phi = f - 0.3
    for fn in ("reinitialize_phi_PDE", "reinitialize_level_set"):
        if fn == "reinitialize_phi_PDE":
            args = (dx, dy, 6, None, 0.4)
        else:
            args = (dx, dy, "pde", 6, 0.4, None)
        t_args = [tls.apply_phi_BCs if a is None else a for a in args]
        j_args = [jls.apply_phi_BCs if a is None else a for a in args]
        out = getattr(tls, fn)(tt(phi), *t_args)
        close(out, getattr(jls, fn)(jnp.asarray(phi), *j_args))
        assert not torch.equal(out, getattr(tls, fn)(tt(phi), *args))


def test_sim_helpers_match_jax():
    for w_t, dx in ((0.05, 0.01), (2.0 / 63, 1.0 / 63), (0.031, 0.01)):
        assert (tsim.required_extrapolation_layers(w_t, dx)
                == jsim.required_extrapolation_layers(w_t, dx))
        need = jsim.check_narrow_band(w_t, dx, 10)
        assert tsim.check_narrow_band(w_t, dx, 10) == need
        with pytest.raises(ValueError, match="Narrow-band"):
            tsim.check_narrow_band(w_t, dx, need - 1)
    # the compat name is the extrapolation itself (held to JAX's in
    # tests/test_torch_ops.py)
    f, dx, dy = field()
    phi = f - 0.5
    X1, X2 = tt(f * (phi < 0)), tt((f + 1.0) * (phi < 0))
    out = tsim.extrapolate_reference_map_compat(X1, X2, tt(phi), dx, dy, 3)
    ref = pt.extrapolate_reference_map(X1, X2, tt(phi), dx, dy, 3)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
