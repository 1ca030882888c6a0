"""The disc in a Taylor-Green vortex (``validation.disc_in_taylor_green``)
and the spatial convergence study (``validation.convergence_taylor_green``)
against their JAX drivers, float64, at small sizes (each JAX driver runs
once, jitted):

- ``benchmarks/disc_in_taylor_green.py::run`` at N=32 to t = 0.02 in
  chunks of 10 steps (the last chunk overruns t_end: its aux, the solid as
  the run left it, is the JAX driver's too): every logged energy row to
  1e-10 relative (1e-13 absolute: the strain energy starts at roundoff),
  the total-energy drift likewise;
- ``benchmarks/convergence_taylor_green.py::run`` on the grids 16, 32
  against 64 with dt 1e-3 to t = 0.003 (3 steps a grid): the error rows
  (the driver's errors.csv) and the five observed orders to 1e-9
  relative (the orders are slopes of logs of differences).

Their files under ``out_root``: ``energy_history.csv``, ``errors.csv``
and the per-grid field caches (``cache=True``) with the same names,
headers, rows and keys (1e-10; the errors 1e-9); each package's cache
loads in the other bit for bit: a run on the other's cache runs no step
and gives the other's orders exactly.
"""
import shutil

import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.common import (
    check_outputs,
    compare_outputs,
    richardson_order,
)

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
TG = dict(N=32, t_end=0.02, log_every=10)
CONV = dict(grids=(16, 32), N_ref=64, t_end=0.003, dt=1e-3)
CONV_DIR = "convergence_tg_semilagrangian"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.convergence_taylor_green import run as conv_run
    from benchmarks.disc_in_taylor_green import run as tg_run

    out = tmp_path_factory.mktemp("out")
    jax = str(out / "jax")
    jtg = tg_run(dtype="float64", verbose=False, out_root=jax, **TG)
    orders = conv_run(dtype="float64", verbose=False, out_root=jax,
                      cache=True, **CONV)
    errors = np.loadtxt(out / "jax" / CONV_DIR / "errors.csv",
                        delimiter=",", skiprows=1)
    kw = dict(dtype=torch.float64, device=DEV, out_root=str(out / "port"))
    return dict(jtg=jtg, orders=orders, errors=errors, out=out,
                tg=validation.disc_in_taylor_green(**TG, **kw),
                conv=validation.convergence_taylor_green(cache=True, **CONV,
                                                         **kw))


def test_disc_in_taylor_green_matches_the_jax_driver(runs):
    j_rows, drift = runs["jtg"]
    rows, s = runs["tg"]
    assert len(rows) == len(j_rows) == 21
    for r, jr in zip(rows, j_rows):
        assert list(r) == list(jr)
        np.testing.assert_allclose(list(r.values()), list(jr.values()),
                                   rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(s["drift"], drift, rtol=1e-10)
    assert s["stable"] and s["steps"] == 210


def test_convergence_matches_the_jax_driver(runs):
    rows, s = runs["conv"]
    keys = ("dx", "E_v", "E_p", "E_X1", "E_ke", "E_se")
    np.testing.assert_allclose([[r[k] for k in keys] for r in rows],
                               runs["errors"], rtol=1e-9)
    assert [r["N"] for r in rows] == [16, 32]
    assert set(s["orders"]) == set(runs["orders"])
    for name, order in runs["orders"].items():
        np.testing.assert_allclose(s["orders"][name], order, rtol=1e-9,
                                   err_msg=name)
    assert s["steps"] == 9
    # the reference-free orders of the energies over the three grids
    for name in ("ke", "se"):
        assert s["richardson"][name] == richardson_order(
            sorted(s[name].items()))


@pytest.mark.parametrize("case, directory, tols", [
    ("disc_in_taylor_green", "disc_tg_N32_semilagrangian", {}),
    ("convergence_taylor_green", CONV_DIR,
     {k: (1e-9, 0.0) for k in ("E_v", "E_p", "E_X1", "E_ke", "E_se")})])
def test_files_match_the_jax_driver(runs, case, directory, tols):
    out = runs["out"]
    names = compare_outputs(out / "port" / directory,
                            out / "jax" / directory, tols=tols)
    rows = len(runs["tg" if case.startswith("disc") else "conv"][0])
    for who in ("port", "jax"):
        check_outputs(case, out / who / directory, rows=rows)
    if case.startswith("conv"):
        assert names == ["errors.csv"] + [
            f"sol_N{N}_float64_t0.003_dt0.001.npz" for N in (16, 32, 64)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_convergence_cache_loads_in_the_other_package(runs, tmp_path,
                                                      writer):
    """Either package's run on a copy of ``writer``'s cache runs no step,
    and the two give the same orders bit for bit; on the port's cache,
    the orders the port's run that wrote it returned."""
    from benchmarks.convergence_taylor_green import run as conv_run

    got = {}
    for reader in ("port", "jax"):
        root = tmp_path / reader
        shutil.copytree(runs["out"] / writer / CONV_DIR, root / CONV_DIR)
        if reader == "port":
            _, s = validation.convergence_taylor_green(
                dtype="float64", device=DEV, out_root=str(root), cache=True,
                **CONV)
            assert s["steps"] == 0
            got[reader] = s["orders"]
        else:
            got[reader] = conv_run(dtype="float64", verbose=False,
                                   out_root=str(root), cache=True, **CONV)
    assert got["port"] == got["jax"]
    if writer == "port":
        assert got["port"] == runs["conv"][1]["orders"]


def test_richardson_order_of_a_second_order_sequence():
    seq = [(N, 1.0 + (1.0 / N) ** 2) for N in (16, 32, 64, 128)]
    orders = richardson_order(seq)
    assert [N for N, _ in orders] == [64, 128]
    np.testing.assert_allclose([p for _, p in orders], 2.0, rtol=1e-9)
