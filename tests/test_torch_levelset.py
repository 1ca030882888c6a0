"""The port's level-set operators and general bilinear gather against
``pyrmt_tpu.ops.levelset`` and ``pyrmt_tpu.ops.interp``.

The same float64 inputs, made with numpy from a seed, go through the JAX
function and the port's at N=64; they agree to 1e-13. The fast-sweeping
cases are those of tests/test_reinit.py: a signed-distance disc, a
corrupted one, and a level set with exact zeros on the grid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.ops.interp as j_interp
import pyrmt_tpu.ops.levelset as j_ls
import pyrmt_tpu_torch.ops.interp as t_interp
import pyrmt_tpu_torch.ops.levelset as t_ls

torch.set_num_threads(1)

N = 64
ATOL = 1e-13
DX = 1.0 / (N - 1)
W_T = 2.0 * DX


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def level_sets(seed=0):
    """name -> (Ny, Nx) level set: the disc's signed distance, the same
    disc corrupted to sign(d)(d^2 + 0.3), a wobbly (non-distance) disc,
    and a half plane through a grid column (exact zeros)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    sdf = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.25
    a, b = rng.uniform(0.02, 0.05, size=2)
    wobbly = (np.sqrt((X - 0.55) ** 2 + (Y - 0.45) ** 2) - 0.22
              + a * np.sin(5 * np.pi * X) * np.cos(3 * np.pi * Y)) * (1.0 + b)
    return {"disc": sdf, "corrupted": np.sign(sdf) * (sdf**2 + 0.3),
            "wobbly": wobbly, "zeros": X - X[:, 31:32]}


CASES = ["disc", "corrupted", "wobbly", "zeros"]


@pytest.mark.parametrize("case", CASES)
def test_smoothed_solid_area(case):
    phi = level_sets()[case]
    close(t_ls.smoothed_solid_area(tt(phi), DX, DX, W_T),
          j_ls.smoothed_solid_area(jnp.asarray(phi), DX, DX, W_T))


@pytest.mark.parametrize("shift", [0.0, 0.3 * DX, -0.7 * DX])
def test_area_conserving_shift(shift):
    """Newton shift back onto the target area from a displaced level set;
    with the interface gone (phi > w_t everywhere) the shift is 0."""
    phi = level_sets()["wobbly"]
    target = float(j_ls.smoothed_solid_area(jnp.asarray(phi), DX, DX, W_T))
    for p in (phi + shift, np.abs(phi) + 2 * W_T):
        out = t_ls.area_conserving_shift(tt(p), DX, DX, W_T, target)
        close(out, j_ls.area_conserving_shift(jnp.asarray(p), DX, DX, W_T,
                                              target))
    def miss(p):
        return abs(float(t_ls.smoothed_solid_area(p, DX, DX, W_T)) - target)

    fixed = t_ls.area_conserving_shift(tt(phi + shift), DX, DX, W_T, target)
    assert miss(fixed) <= 1e-3 * miss(tt(phi + shift)) + 1e-15
    gone = np.abs(phi) + 2 * W_T
    assert torch.equal(
        t_ls.area_conserving_shift(tt(gone), DX, DX, W_T, target), tt(gone))


def test_edge_pad():
    phi = level_sets()["wobbly"]
    close(t_ls._edge_pad(tt(phi)), j_ls._edge_pad(jnp.asarray(phi)), 0.0)


@pytest.mark.parametrize("case", CASES)
def test_reinitialize_phi_pde(case):
    phi = level_sets()[case]
    close(t_ls.reinitialize_phi_PDE(tt(phi), DX, DX, 5),
          j_ls.reinitialize_phi_PDE(jnp.asarray(phi), DX, DX, 5))


def test_eikonal_update():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 0.2, size=500)
    b = a + rng.uniform(-2 * DX, 2 * DX, size=500)
    big = 4.0
    a[::7] = 10.0  # above big: clipped
    close(t_ls._eikonal_update(tt(a), tt(b), DX, 1.3 * DX, tt(big)),
          j_ls._eikonal_update(jnp.asarray(a), jnp.asarray(b), DX, 1.3 * DX,
                               jnp.asarray(big)))


def test_fsm_sweep():
    """One traversal from the frozen-front initial distances of the
    corrupted disc, on a non-square grid."""
    phi = level_sets()["corrupted"][:, :50]
    big = 4.0
    frozen = np.zeros(phi.shape, bool)
    frozen[:-1] |= phi[:-1] * phi[1:] < 0
    frozen[:, :-1] |= phi[:, :-1] * phi[:, 1:] < 0
    d = np.where(frozen, np.abs(phi), big)
    close(t_ls._fsm_sweep(tt(d), torch.tensor(frozen), DX, DX, tt(big)),
          j_ls._fsm_sweep(jnp.asarray(d), jnp.asarray(frozen), DX, DX,
                          jnp.asarray(big)))


@pytest.mark.parametrize("case", CASES)
def test_reinitialize_phi_fsm(case):
    phi = level_sets()[case]
    out = t_ls.reinitialize_phi_fsm(tt(phi), DX, DX)
    close(out, j_ls.reinitialize_phi_fsm(jnp.asarray(phi), DX, DX))
    assert torch.equal(torch.sign(out), torch.sign(tt(phi)))


@pytest.mark.parametrize("method", ["none", "pde", "fmm"])
def test_reinitialize_level_set(method):
    phi = level_sets()["corrupted"]
    close(t_ls.reinitialize_level_set(tt(phi), DX, DX, method=method),
          j_ls.reinitialize_level_set(jnp.asarray(phi), DX, DX,
                                      method=method))
    with pytest.raises(ValueError):
        t_ls.reinitialize_level_set(tt(phi), DX, DX, method="bogus")


def test_bilinear_interpolate():
    """Points inside, on the edges, outside, huge and non-finite."""
    rng = np.random.default_rng(5)
    f = level_sets()["wobbly"]
    xq = rng.uniform(-0.2, 1.2, size=(N, N))
    yq = rng.uniform(-0.2, 1.2, size=(N, N))
    xq[0, :4] = [0.0, 1.0, 1e30, -1e30]
    yq[1, :3] = [np.nan, np.inf, 1.0]
    got = t_interp.bilinear_interpolate(tt(f), tt(xq), tt(yq), DX, DX)
    ref = j_interp.bilinear_interpolate(jnp.asarray(f), jnp.asarray(xq),
                                        jnp.asarray(yq), DX, DX)
    close(got, ref)
    assert bool(torch.isnan(got[1, :2]).all())
    stack = np.stack([f, level_sets()["disc"]])
    close(t_interp.gather_bilinear_multi(tt(stack), tt(xq), tt(yq), DX, DX),
          j_interp.gather_bilinear_multi(jnp.asarray(stack), jnp.asarray(xq),
                                         jnp.asarray(yq), DX, DX))
