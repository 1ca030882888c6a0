"""The port's diagnostics and I/O against the JAX package's.

The six diagnostics take the same float64 inputs, made from a numpy seed
(a disc's level set and reference map with a sub-cell wave, a smooth
velocity), in both packages, for one level set and for a stack of two:
1e-13 of the value's size. Checkpoints cross both ways with every array
identical; an EnergyLogger history and a snapshot round-trip; the
every-few-steps output writes the JAX package's CSV row and snapshot
fields.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrmt_tpu.diagnostics as jdiag
import pyrmt_tpu.io as jio
import pyrmt_tpu.sim as jsim
import pyrmt_tpu_torch as pt
import pyrmt_tpu_torch.diagnostics as tdiag
import pyrmt_tpu_torch.io as tio
from pyrmt_tpu.grid import Grid as JGrid

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card

N = 48
DX = 1.0 / (N - 1)
W_T = 2.0 * DX


def inputs(seed=0):
    """Seeded float64 fields: two discs' level sets, a map with a sub-cell
    wave, a smooth velocity, and the grid."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x)
    phi_a = np.hypot(X - 0.4, Y - 0.5) - 0.2
    phi_b = np.hypot(X - 0.75, Y - 0.45) - 0.12
    r = rng.standard_normal(4)
    X1 = X + 0.3 * DX * np.sin(2 * np.pi * X + r[0]) * np.cos(np.pi * Y)
    X2 = Y - 0.3 * DX * np.cos(np.pi * X) * np.sin(2 * np.pi * Y + r[1])
    u = r[2] * np.sin(np.pi * X) * np.cos(np.pi * Y)
    v = r[3] * np.cos(np.pi * X) * np.sin(np.pi * Y)
    return dict(phi=phi_a, phis=np.stack([phi_a, phi_b]), X1=X1, X2=X2,
                u=u, v=v, X=X, Y=Y)


def pair(a):
    return jnp.asarray(a), torch.tensor(a)


def assert_close(t, j, what, rel=1e-13):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=rel * max(1.0, float(np.abs(j).max())),
                               err_msg=what)


@pytest.mark.parametrize("stack", [False, True], ids=["one", "stack"])
@pytest.mark.parametrize("name", ["kinetic", "strain", "dissipation"])
def test_energy_diagnostics_match_jax(name, stack):
    d = inputs()
    jphi, tphi = pair(d["phis"] if stack else d["phi"])
    (ju, tu), (jv, tv) = pair(d["u"]), pair(d["v"])
    if name == "kinetic":
        ref = jdiag.compute_kinetic_energy(ju, jv, 1.0, 1.3, jphi, W_T, DX,
                                           DX)
        out = tdiag.compute_kinetic_energy(tu, tv, 1.0, 1.3, tphi, W_T, DX,
                                           DX)
    elif name == "strain":
        (jX1, tX1), (jX2, tX2) = pair(d["X1"]), pair(d["X2"])
        ref = jdiag.compute_strain_energy(jX1, jX2, jphi[0] if stack else jphi,
                                          0.3, DX, DX, kappa=0.7)
        out = tdiag.compute_strain_energy(tX1, tX2, tphi[0] if stack else tphi,
                                          0.3, DX, DX, kappa=0.7)
    else:
        ref = jdiag.compute_viscous_dissipation(ju, jv, 0.01, jphi, W_T, DX,
                                                DX, eta_s=0.05)
        out = tdiag.compute_viscous_dissipation(tu, tv, 0.01, tphi, W_T, DX,
                                                DX, eta_s=0.05)
    assert out.ndim == 0 and float(ref) != 0.0
    assert_close(out, ref, name)


@pytest.mark.parametrize("pad", [3, 4])
def test_interior_divergence_matches_jax(pad):
    d = inputs(1)
    (ju, tu), (jv, tv) = pair(d["u"]), pair(d["v"])
    for o, r, k in zip(tdiag.divergence_2d_interior(tu, tv, DX, DX, pad),
                       jdiag.divergence_2d_interior(ju, jv, DX, DX, pad),
                       ("field", "interior")):
        assert tuple(o.shape) == r.shape, k
        assert_close(o, r, k)


@pytest.mark.parametrize("where", ["disc", "none"])
def test_centroid_and_centerlines_match_jax(where):
    d = inputs(2)
    phi = d["phi"] if where == "disc" else d["phi"] + 5.0
    (jp, tp), (jX, tX), (jY, tY) = pair(phi), pair(d["X"]), pair(d["Y"])
    for o, r in zip(tdiag.disc_centroid(tp, tX, tY),
                    jdiag.disc_centroid(jp, jX, jY)):
        if where == "none":
            assert np.isnan(float(o)) and np.isnan(float(r))
        else:
            assert_close(o, r, "centroid")
    (ju, tu), (jv, tv) = pair(d["u"]), pair(d["v"])
    for o, r in zip(tdiag.extract_centerlines(tu, tv, tX, tY),
                    jdiag.extract_centerlines(ju, jv, jX, jY)):
        assert np.array_equal(o.numpy(), np.asarray(r))


def _jax_state(rebasing):
    jcfg = jsim.RMTConfig(grid=JGrid(Nx=32, Ny=32, Lx=1.0, Ly=1.0),
                          mu_s=0.1, map_rebase_minj=0.5 if rebasing else 0.0)
    disc = lambda X, Y: jnp.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.2
    with jax.disable_jit():  # op by op: compiling takes ~25 s
        s = jsim.make_init_state(jcfg, (disc,), dtype=jnp.float64)
    rng = np.random.default_rng(3)
    return jsim.SimState(u=jnp.asarray(rng.standard_normal((32, 32))),
                         v=s.v, p=s.p, X1=s.X1, X2=s.X2,
                         t=jnp.asarray(0.25, jnp.float64),
                         step=jnp.asarray(7, jnp.int32), phis0=s.phis0)


@pytest.mark.parametrize("rebasing", [False, True])
def test_checkpoint_from_jax_loads_in_the_port(tmp_path, rebasing):
    js = _jax_state(rebasing)
    path = str(tmp_path / "jax.npz")
    jio.save_checkpoint(path, js)
    ts = tio.load_checkpoint(path, device=DEV)
    for k in tio.STATE_FIELDS:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ts.step.dtype == torch.int32
    f32 = tio.load_checkpoint(path, dtype=torch.float32, device=DEV)
    assert f32.u.dtype == torch.float32 and f32.step.dtype == torch.int32


@pytest.mark.parametrize("rebasing", [False, True])
def test_checkpoint_from_the_port_loads_in_jax(tmp_path, rebasing):
    js = _jax_state(rebasing)
    ts = tio.state_from_numpy({k: np.asarray(getattr(js, k))
                               for k in tio.STATE_FIELDS}, device=DEV,
                              dtype=torch.float64)
    path = str(tmp_path / "port.npz")
    pt.save_checkpoint(path, ts)
    back = jio.load_checkpoint(path)
    for k in tio.STATE_FIELDS:
        a, b = np.asarray(getattr(back, k)), getattr(ts, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # and back into the port, the same arrays
    again = pt.load_checkpoint(path, device=DEV)
    for k in tio.STATE_FIELDS:
        assert torch.equal(getattr(again, k), getattr(ts, k)), k


def test_checkpoint_without_phis0_gets_the_empty_stack(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, u=np.zeros((8, 9)), v=np.zeros((8, 9)), p=np.zeros((8, 9)),
             X1=np.zeros((1, 8, 9)), X2=np.zeros((1, 8, 9)), t=np.float64(0),
             step=np.int32(0))
    s = pt.load_checkpoint(path, device=DEV)
    assert s.phis0.shape == (0, 8, 9) and s.phis0.dtype == torch.float64


def test_energy_logger_round_trip(tmp_path):
    log = pt.EnergyLogger()
    rows = [dict(t=0.1 * k, ke=1.0 / 3.0 ** k, maxdiv=np.pi * 1e-15 * k)
            for k in range(5)]
    for r in rows:
        log.log(**r)
    path = str(tmp_path / "decay.csv")
    log.to_csv(path)
    back = pt.EnergyLogger.from_csv(path)
    assert back.rows == rows  # a float's repr reads back exactly
    assert np.array_equal(back.array("t", "ke"), log.array("t", "ke"))
    # the JAX package reads the port's CSV the same way
    assert jio.EnergyLogger.from_csv(path).rows == rows
    pt.EnergyLogger().to_csv(str(tmp_path / "empty.csv"))
    assert not (tmp_path / "empty.csv").exists()


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_snapshot_round_trip(tmp_path, suffix):
    d = inputs(4)
    fields = {"u": torch.tensor(d["u"]), "phi": d["phi"]}
    attrs = {"time": 0.125, "kinetic_energy": 1.0 / 3.0}
    path = pt.save_snapshot(str(tmp_path / f"snap{suffix}"), fields, attrs)
    got, got_attrs = pt.load_snapshot(path)
    assert np.array_equal(got["u"], d["u"]) and np.array_equal(got["phi"],
                                                               d["phi"])
    assert {k: float(v) for k, v in got_attrs.items()} == attrs
    # the JAX package reads it too
    jf, ja = jio.load_snapshot(path)
    assert np.array_equal(jf["u"], d["u"])
    assert {k: float(v) for k, v in ja.items()} == attrs


def test_output_simulation_data_matches_jax(tmp_path, capsys):
    """Step 1 writes a console line, the CSV header and row and a snapshot;
    the port's row and fields match the JAX package's."""
    d = inputs(5)
    J = np.ones((N, N)) + 0.01 * d["u"]
    s = [0.1 * d["u"], 0.2 * d["v"], 0.05 * d["u"] * d["v"]]
    kw = dict(mu_s=0.3, mu_f=0.01, rho_s=1.3, rho_f=1.0, w_t=W_T,
              eta_s=0.02, kappa=0.5, time=0.25,
              integrated_dissipation=0.125)
    out = {}
    for name, mod, conv in (("jax", jio, jnp.asarray),
                            ("port", tio, torch.tensor)):
        mod.output_simulation_data(
            DX, DX, conv(d["phi"]), None, conv(d["X1"]), conv(d["X2"]),
            conv(d["u"]), conv(d["v"]), conv(d["u"] * 0.5), 10, "run", 1,
            2e-3, *(conv(a) for a in s), conv(J),
            out_root=str(tmp_path / name), **kw)
        with open(tmp_path / name / "run" / "energy_history.csv") as f:
            out[name] = list(csv.DictReader(f))
    assert capsys.readouterr().out.count("[Step 00001]") == 2
    (jrow,), (trow,) = out["jax"], out["port"]
    assert jrow.keys() == trow.keys()
    for k in jrow:
        np.testing.assert_allclose(float(trow[k]), float(jrow[k]), rtol=1e-13,
                                   err_msg=k)
    # .h5 where h5py imports, else .npz
    (jpath,) = (tmp_path / "jax" / "run").glob("data_000001.*")
    (tpath,) = (tmp_path / "port" / "run").glob("data_000001.*")
    jf, _ = jio.load_snapshot(str(jpath))
    tf, _ = pt.load_snapshot(str(tpath))
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=1e-13,
                                   err_msg=k)
    # a step off the output frequency writes nothing
    tio.output_simulation_data(DX, DX, torch.tensor(d["phi"]), None,
                               *(torch.tensor(d[k]) for k in ("X1", "X2")),
                               torch.tensor(d["u"]), torch.tensor(d["v"]),
                               torch.tensor(d["u"]), 10, "quiet", 3, 2e-3,
                               *(torch.tensor(a) for a in s), torch.tensor(J),
                               out_root=str(tmp_path / "port"), **kw)
    assert not (tmp_path / "port" / "quiet").exists()
