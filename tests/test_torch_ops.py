"""pyrmt_tpu_torch operators against their pyrmt_tpu counterparts.

The same float64 inputs, made with numpy from a seed and a smooth
Taylor-Green base, go through the JAX function and the port's; they agree
to 1e-13 (J to 1e-12: 1/det G amplifies the rounding of G).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.bcs as j_bcs
import pyrmt_tpu.grid as j_grid
import pyrmt_tpu.ops.advect as j_advect
import pyrmt_tpu.ops.extrapolate as j_extrap
import pyrmt_tpu.ops.fd as j_fd
import pyrmt_tpu.ops.interp as j_interp
import pyrmt_tpu.ops.stress as j_stress
import pyrmt_tpu_torch.bcs as t_bcs
import pyrmt_tpu_torch.grid as t_grid
import pyrmt_tpu_torch.ops.advect as t_advect
import pyrmt_tpu_torch.ops.extrapolate as t_extrap
import pyrmt_tpu_torch.ops.fd as t_fd
import pyrmt_tpu_torch.ops.interp as t_interp
import pyrmt_tpu_torch.ops.stress as t_stress
from pyrmt_tpu_torch.ops.levelset import Disc, rebuild_phi_from_reference_map

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

ATOL = 1e-13


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def fields(N, seed=0):
    """Taylor-Green velocity plus a small seeded perturbation, and a
    disc-shaped map: the identity inside phi <= 0, perturbed smoothly."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    u = 0.3 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    u += 0.01 * rng.standard_normal((N, N))
    v += 0.01 * rng.standard_normal((N, N))
    phi = np.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2
    a, b = rng.standard_normal(2)
    X1 = X + 0.02 * a * np.sin(3 * np.pi * Y)
    X2 = Y + 0.02 * b * np.sin(2 * np.pi * X)
    return dict(X=X, Y=Y, u=u, v=v, phi=phi, X1=X1, X2=X2, dx=1.0 / (N - 1))


@pytest.mark.parametrize("shape", [(64, 64, 1.0, 1.3), (1024, 1024, 1.0, 1.0),
                                   (80, 48, 2.5, 0.7), (129, 33, 1.0, 1.0)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_coords_bit_for_bit(shape, dtype):
    """The coordinates equal JAX's to the bit (torch.linspace was an ulp
    off in a quarter of the points, which flipped the 'cond' rebuild's
    has-this-solid-rebased test on a state made by JAX)."""
    jx = j_grid.Grid(*shape).coords(dtype=getattr(jnp, dtype))
    tx = t_grid.Grid(*shape).coords(dtype=getattr(torch, dtype), device=DEV)
    for a, b in zip(tx, jx):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["grad_central_x_2nd", "grad_central_y_2nd"])
def test_central_gradients(name):
    f = fields(32)
    close(getattr(t_fd, name)(tt(f["u"]), f["dx"]),
          getattr(j_fd, name)(jnp.asarray(f["u"]), f["dx"]))


@pytest.mark.parametrize("axis", [0, 1])
def test_upwind_3rd(axis):
    f = fields(32)
    close(t_fd.diff_upwind_3rd(tt(f["u"]), tt(f["v"]), f["dx"], axis),
          j_fd.diff_upwind_3rd(jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                               f["dx"], axis))


@pytest.mark.parametrize("k", [-2, -1, 1, 2])
def test_edge_shifts(k):
    f = fields(16)["u"]
    close(t_fd._shift_x(tt(f), k), j_fd._shift_x(jnp.asarray(f), k), 0)
    close(t_fd._shift_y(tt(f), k), j_fd._shift_y(jnp.asarray(f), k), 0)


@pytest.mark.parametrize("name", ["lid", "free_slip", "noop"])
def test_velocity_bcs(name):
    f = fields(16)
    make = {"lid": lambda m: m.make_lid_bc(0.7),
            "free_slip": lambda m: m.free_slip_box_bc,
            "noop": lambda m: m.noop_bc}[name]
    t_bc, j_bc = make(t_bcs), make(j_bcs)
    assert t_bc.kernel_spec == j_bc.kernel_spec
    for t, j in zip(t_bc(tt(f["u"]), tt(f["v"])),
                    j_bc(jnp.asarray(f["u"]), jnp.asarray(f["v"]))):
        close(t, j, 0)


def test_solve3x3_sym():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 8, 8))
    a[0] += 4.0  # diagonally dominant where possible
    a[3] += 4.0
    a[5] += 4.0
    a[:, 0, 0] = 0.0  # a singular cell: det 0 -> zeroed solution
    t_out = t_fd.solve3x3_sym(*(tt(x) for x in a))
    j_out = j_fd.solve3x3_sym(*(jnp.asarray(x) for x in a))
    for t, j in zip(t_out, j_out):
        close(t.to(torch.float64), np.asarray(j).astype(np.float64))


def test_gather_bilinear_local():
    N = 32
    rng = np.random.default_rng(1)
    us = rng.standard_normal((3, N, N))
    sx = rng.uniform(-1.2, 1.2, (N, N))  # some clipped, some leave the box
    sy = rng.uniform(-1.2, 1.2, (N, N))
    sx[3, 4] = np.nan  # non-finite displacement -> NaN
    out = t_interp.gather_bilinear_local(tt(us), tt(sx), tt(sy))
    ref = j_interp.gather_bilinear_local(jnp.asarray(us), jnp.asarray(sx),
                                         jnp.asarray(sy))
    assert bool(torch.isnan(out[:, 3, 4]).all())
    close(out, ref)


def test_advect_semilagrangian_rk4_local():
    f = fields(64)
    qs = np.stack([f["X1"], f["X2"]])
    dt = 0.5 * f["dx"] / 0.32  # about half a cell
    out = t_advect.advect_semilagrangian_rk4_local(
        tt(qs), tt(f["u"]), tt(f["v"]), dt, f["dx"], f["dx"])
    ref = j_advect.advect_semilagrangian_rk4_local(
        jnp.asarray(qs), jnp.asarray(f["u"]), jnp.asarray(f["v"]), dt,
        f["dx"], f["dx"])
    close(out, ref)


@pytest.mark.parametrize("layers", [1, 3])
def test_extrapolate_reference_map(layers):
    f = fields(64)
    mask = (f["phi"] <= 0).astype(np.float64)
    args = (f["X1"] * mask, f["X2"] * mask, f["phi"])
    X1e, X2e = t_extrap.extrapolate_reference_map(
        *(tt(a) for a in args), f["dx"], f["dx"], layers)
    J1, J2 = j_extrap.extrapolate_reference_map(
        *(jnp.asarray(a) for a in args), f["dx"], f["dx"], layers)
    close(X1e, J1)
    close(X2e, J2)
    # the band grew: cells just outside the disc got values
    assert float(torch.count_nonzero(X1e)) > float(np.count_nonzero(args[0]))


@pytest.mark.parametrize("w_cut_cells,clamp", [(0.0, 0.0), (2.0, 3.0)])
def test_solid_cauchy_stress(w_cut_cells, clamp):
    f = fields(64)
    w_cut = w_cut_cells * f["dx"]
    kw = dict(w_cut=w_cut, detg_clamp=clamp)
    t_out = t_stress.solid_cauchy_stress(
        tt(f["X1"]), tt(f["X2"]), f["dx"], f["dx"], 0.1, 0.3, tt(f["phi"]),
        **kw)
    j_out = j_stress.solid_cauchy_stress(
        jnp.asarray(f["X1"]), jnp.asarray(f["X2"]), f["dx"], f["dx"], 0.1,
        0.3, jnp.asarray(f["phi"]), **kw)
    for t, j, atol in zip(t_out, j_out, (ATOL, ATOL, ATOL, 1e-12)):
        close(t, j, atol)


def test_smoothed_heaviside():
    f = fields(64)
    w_t = 2.0 * f["dx"]
    close(t_stress.smoothed_heaviside(tt(f["phi"]), w_t),
          j_stress.smoothed_heaviside(jnp.asarray(f["phi"]), w_t))


def test_disc_rebuild():
    f = fields(64)
    disc = Disc(0.6, 0.5, 0.2)
    assert disc.kernel_spec == ("disc", 0.6, 0.5, 0.2)

    def j_phi(X, Y):  # the flagship's closure, __graft_entry__._flagship
        return jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.2

    close(rebuild_phi_from_reference_map(tt(f["X1"]), tt(f["X2"]), disc),
          j_phi(jnp.asarray(f["X1"]), jnp.asarray(f["X2"])))


def test_port_imports_without_jax():
    """The port never imports jax: it imports with jax made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pyrmt_tpu_torch, pyrmt_tpu_torch.sim, pyrmt_tpu_torch.io\n"
        "import pyrmt_tpu_torch.kernels.rmt_block\n"
        "import pyrmt_tpu_torch.kernels.momentum_rk4\n"
        "import pyrmt_tpu_torch.kernels.extrapolate_fused\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('pyrmt_tpu.') or m == 'pyrmt_tpu' "
        "for m, mod in sys.modules.items() if mod is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
