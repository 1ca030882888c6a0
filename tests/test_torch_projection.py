"""The port's Neumann projection against ``pyrmt_tpu.ops`` in float64:
the dense-matrix DCT-I solve against the JAX rFFT solve, the Rhie-Chow
divergence, the pressure gradient and the whole incremental projection,
atol 1e-12.
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
DEV = "cpu"  # the entry points default to the card

ATOL = 1e-12


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def fields(Ny, Nx, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, Nx)
    y = np.linspace(0.0, 1.0, Ny)
    X, Y = np.meshgrid(x, y)
    a = 0.3 * np.sin(2 * np.pi * X) * np.cos(np.pi * Y)
    b = -0.2 * np.cos(np.pi * X) * np.sin(2 * np.pi * Y)
    a += 0.01 * rng.standard_normal((Ny, Nx))
    b += 0.01 * rng.standard_normal((Ny, Nx))
    p = 0.05 * np.cos(np.pi * X) * np.cos(np.pi * Y)
    phi = np.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2
    rho = 1.0 + 0.3 * (phi <= 0)
    return a, b, p, rho, 1.0 / (Nx - 1), 1.0 / (Ny - 1)


@pytest.mark.parametrize("Ny,Nx", [(64, 64), (48, 64)])
def test_solve_poisson_dct_matches_jax_fft(Ny, Nx):
    a, _, _, _, dx, dy = fields(Ny, Nx)
    rhs = a - a.mean()
    eig = jp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    t_eig = tp.precompute_poisson_eigenvalues(Nx, Ny, dx, dy, device=DEV)
    close(t_eig, eig, 0)
    ref = jp.solve_poisson_dct(jnp.asarray(rhs), eig)
    out = tp.solve_poisson_dct(tt(rhs), t_eig,
                               tp.precompute_dct_matrices(Nx, Ny,
                                                          torch.float64, DEV))
    close(out, ref)


def test_dct1_matrix_matches_jax():
    close(tp.dct1_matrix(33, torch.float64, DEV),
          jp.dct1_matrix(33, dtype=jnp.float64), 0)


def test_divergence_and_gradient_match_jax():
    a, b, p, rho, dx, dy = fields(64, 64)
    dt = 2e-3
    close(tp.compute_divergence_rc(tt(a), tt(b), tt(p), tt(dt), tt(rho), dx,
                                   dy),
          jp.compute_divergence_rc(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(p), dt, jnp.asarray(rho), dx,
                                   dy, False))
    for t, j in zip(tp.compute_pressure_gradient(tt(p), dx, dy),
                    jp.compute_pressure_gradient(jnp.asarray(p), dx, dy)):
        close(t, j)


@pytest.mark.parametrize("bc_name", ["lid", "free_slip"])
def test_pressure_projection_matches_jax(bc_name):
    a, b, p, rho, dx, dy = fields(64, 64, seed=2)
    N = 64
    dt = 2e-3
    j_bc = j_bcs.make_lid_bc(1.0) if bc_name == "lid" else j_bcs.free_slip_box_bc
    t_bc = t_bcs.make_lid_bc(1.0) if bc_name == "lid" else t_bcs.free_slip_box_bc
    eig = jp.precompute_poisson_eigenvalues(N, N, dx, dy)
    ref = j_projection(jnp.asarray(a), jnp.asarray(b), dx, dy, dt,
                       jnp.asarray(rho), j_bc, p_prev=jnp.asarray(p),
                       eigenvalues=eig)
    out = pressure_projection(
        tt(a), tt(b), dx, dy, tt(dt), tt(rho), t_bc, tt(p),
        tp.precompute_poisson_eigenvalues(N, N, dx, dy, device=DEV),
        dct_mats=tp.precompute_dct_matrices(N, N, torch.float64, DEV))
    for t, j in zip(out, ref):
        close(t, j)
