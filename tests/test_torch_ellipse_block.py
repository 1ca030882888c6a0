"""The fused solid block with the ellipse level set against the Pallas
kernel: ``rmt_block_plain`` with ``Ellipse`` (the kernel_spec the CUDA
kernel evaluates) against ``pyrmt_tpu.kernels.rmt_block.rmt_block_fused(
..., interpret=True)`` with ``benchmarks/capillary_drop_coupled.py``'s
``make_ellipse_phi_init``, N=64 float64, the capillary drop's ellipse
(a = 0.23, b = 0.174), its map sheared so that the stress acts, under a
Taylor-Green velocity. All 12 outputs to 1e-13 of max(1, |field|), J to
1e-12, and in the band stress mode the stresses and their blends to 1e-12
too (they difference the extrapolated band's map, on which the packages'
extrapolations agree to 1e-12; tests/test_torch_band_stress.py). One
extrapolation layer, the smallest the interpreter takes quickly (~12 s;
nothing of the level set depends on the layers), in the interior and band
stress modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
from benchmarks.capillary_drop_coupled import make_ellipse_phi_init
from pyrmt_tpu.grid import Grid as JGrid
from pyrmt_tpu.kernels.rmt_block import rmt_block_fused as j_rmt_block
from pyrmt_tpu_torch.kernels.rmt_block import rmt_block_plain

torch.set_num_threads(1)

N = 64
DX = 1.0 / (N - 1)
ELLIPSE = (0.5, 0.5, 0.23, 0.174)
NAMES = ("X1e", "X2e", "phis", "sxx", "sxy", "syy", "J", "Hf", "rho_local",
         "sig_sxx_el", "sig_sxy_el", "sig_syy_el")


def tt(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module", params=[0.0, 2.0 * DX], ids=["interior",
                                                            "band"])
def block(request):
    w_cut = request.param
    j_phi = make_ellipse_phi_init(*ELLIPSE)
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=N, Ny=N, Lx=1.0, Ly=1.0), mu_s=1.0,
                          kappa=0.5, rho_s=1.3, num_layers=1)
    js = jsim.make_init_state(jcfg, (j_phi,), dtype=jnp.float64)
    X1 = np.array(js.X1)
    X2 = np.array(js.X2)
    x0, y0 = ELLIPSE[:2]
    X1 = np.where(X1 != 0, X1 + 0.2 * (X2 - y0), X1)  # shear inside
    x = np.arange(N) * DX
    X, Y = np.meshgrid(x, x)
    u = 0.3 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    v = -0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    dt = 1e-3
    kw = dict(dx=DX, dy=DX, num_layers=1, w_t=jcfg.w_t, stress_w_cut=w_cut,
              stress_clamp=3.0 if w_cut else 0.0)
    scalars = dict(mu_s=1.0, kappa=0.5, rho_s=1.3, rho_f=1.0)
    ref = j_rmt_block(*(jnp.asarray(a) for a in (u, v, X1, X2)), dt,
                      phi_inits=(j_phi,), interpret=True, **kw, **scalars)
    out = rmt_block_plain(*(tt(a) for a in (u, v, X1, X2, dt)),
                          phi_inits=(pt.Ellipse(*ELLIPSE),),
                          params=tt(list(scalars.values())), **kw)
    return out, [np.asarray(r) for r in ref], w_cut > 0.0


STRESSES = ("sxx", "sxy", "syy", "J", "sig_sxx_el", "sig_sxy_el",
            "sig_syy_el")


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_ellipse_block_matches_pallas_interpret(block, i):
    out, ref, band = block
    assert out[i].shape == ref[i].shape
    atol = 1e-12 if NAMES[i] == "J" or (band and NAMES[i] in STRESSES) \
        else 1e-13
    np.testing.assert_allclose(out[i].numpy(), ref[i], rtol=0,
                               atol=atol * max(1.0, np.abs(ref[i]).max()))


def test_the_shear_acts(block):
    out = block[0]
    phis, sxy = out[2], out[4]
    assert float(sxy[0][phis[0] <= 0].abs().max()) > 0.01
