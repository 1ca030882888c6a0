"""The driver arguments this slice ported, on the CPU in float64:

- ``benchmarks/periodic_taylor_green.py --solid``
  (``validation.taylor_green_decay(with_solid=True)``): the near-fluid
  disc at the vortex centre on the periodic box, against the JAX driver's
  ``run(with_solid=True)`` at N=49 (the smallest grid whose disc starts 7
  cells clear of the periodic seam, as both packages require) to t = 0.05
  in chunks of 10 steps (the JAX driver runs once, jitted). The summary is
  compared: the decay rate and the errors to 1e-10 relative, and the
  centroid's rows and drift to 1e-13 absolute (the disc sits at the
  vortex centre by symmetry, so its drift is roundoff, ~1e-16);
- ``benchmarks/lid_driven_cavity.py --resume PATH``
  (``validation.lid_driven_cavity(resume_from=...)``): a checkpoint the
  port wrote after a first chunk, read back, runs on bit for bit as an
  unbroken run;
- both flags from the command line (``python -m
  pyrmt_tpu_torch.validation``);
- the files of both drivers under ``out_root``: ``decay.csv`` against the
  JAX driver's (t, ke to 1e-10, the centroid and the divergence to
  1e-13 absolute, as the rows), and the lid cavity's
  ``centerline_u_vs_y.csv`` and ``steady_state.npz`` against the JAX
  driver's after 50 steps at N=17 float64 (1e-10 relative, 1e-13
  absolute); each ``steady_state.npz`` loads in the other package bit
  for bit, and the port resumed from the JAX driver's for 50 more steps
  equals its own unbroken 100 steps to the same tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation import __main__ as cli
from pyrmt_tpu_torch.validation.common import check_outputs, compare_outputs

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
KW = dict(dtype=torch.float64, device=DEV)
TG = dict(N=49, t_end=0.05, log_every=10)


def test_periodic_taylor_green_solid_matches_the_jax_driver(tmp_path):
    from benchmarks.periodic_taylor_green import run

    j_rows, js = run(with_solid=True, dtype="float64", verbose=False,
                     out_root=str(tmp_path / "jax"), **TG)
    rows, s = validation.taylor_green_decay(
        with_solid=True, out_root=str(tmp_path / "port"), **TG, **KW)
    assert s["steps"] == js["steps"] == 50 and len(rows) == len(j_rows)
    assert s["stable"] and js["stable"]
    for key in ("rate", "rate_exact", "rate_rel_err", "profile_rel_err"):
        np.testing.assert_allclose(s[key], js[key], rtol=1e-10)
    for key in ("maxdiv", "centroid_drift", "centroid_drift_cells"):
        np.testing.assert_allclose(s[key], js[key], rtol=0, atol=1e-13)
    for r, jr in zip(rows, j_rows):
        assert list(r) == list(jr) == ["t", "ke", "maxdiv", "xc", "yc"]
        np.testing.assert_allclose([r["t"], r["ke"]], [jr["t"], jr["ke"]],
                                   rtol=1e-10)
        np.testing.assert_allclose([r["xc"], r["yc"]], [jr["xc"], jr["yc"]],
                                   rtol=0, atol=1e-13)
    # the gates chip_smoke.py holds at N=129 float32: sub-cell drift
    assert s["centroid_drift_cells"] < 1.0
    d = "periodic_tg_N49_solid"
    absolute = (0.0, 1e-13)
    assert compare_outputs(tmp_path / "port" / d, tmp_path / "jax" / d,
                           tols=dict(xc=absolute, yc=absolute,
                                     maxdiv=absolute)) == ["decay.csv"]
    for who in ("port", "jax"):
        check_outputs("taylor_green_decay", tmp_path / who / d,
                      rows=len(rows))


LID = dict(Re=100.0, N=17, max_steps=50, steady_tol=0.0, chunk=50)


def test_lid_driven_cavity_files_match_and_load_in_both(tmp_path):
    """The JAX driver's and the port's files after 50 steps; each
    ``steady_state.npz`` read by the other package's ``load_checkpoint``
    bit for bit; the port resumed from the JAX driver's state."""
    import pyrmt_tpu.io as jio
    from benchmarks.lid_driven_cavity import run

    run(dtype="float64", verbose=False, out_root=str(tmp_path / "jax"),
        **LID)
    port = validation.lid_driven_cavity(out_root=str(tmp_path / "port"),
                                        **LID, **KW)
    d = "lid_driven_Re100"
    assert compare_outputs(tmp_path / "port" / d, tmp_path / "jax" / d) == [
        "centerline_u_vs_y.csv", "steady_state.npz"]
    for who in ("port", "jax"):
        check_outputs("lid_driven_cavity", tmp_path / who / d, rows=17)
    for who in ("port", "jax"):
        path = str(tmp_path / who / d / "steady_state.npz")
        with np.load(path) as z:
            saved = {k: z[k] for k in z.files}
        ours, theirs = pt.load_checkpoint(path, device=DEV), \
            jio.load_checkpoint(path)
        for k, a in saved.items():
            assert np.array_equal(getattr(ours, k).numpy(), a), (who, k)
            assert np.array_equal(np.asarray(getattr(theirs, k)), a), (who, k)
    resumed = validation.lid_driven_cavity(
        resume_from=str(tmp_path / "jax" / d / "steady_state.npz"),
        **LID, **KW)
    whole = validation.lid_driven_cavity(**dict(LID, max_steps=100), **KW)
    assert whole["steps"] == 100 and resumed["steps"] == port["steps"] == 50
    np.testing.assert_allclose(resumed["t"], whole["t"], rtol=1e-10)
    np.testing.assert_allclose(resumed["u"], whole["u"], rtol=1e-10,
                               atol=1e-13)


def test_lid_driven_cavity_resume_equals_an_unbroken_run(tmp_path):
    N, chunk = 17, 50
    cfg = validation.lid_cavity_config(N)
    step = pt.make_step(cfg, pt.make_lid_bc(1.0), (), **KW)
    state = validation.lid_cavity_state(cfg, **KW)
    for _ in range(chunk):
        state, _ = step(state, 1e9)
    path = tmp_path / "steady_state.npz"
    pt.save_checkpoint(str(path), state)
    opts = dict(N=N, chunk=chunk, steady_tol=0.0, **KW)
    whole = validation.lid_driven_cavity(max_steps=2 * chunk, **opts)
    resumed = validation.lid_driven_cavity(max_steps=chunk,
                                           resume_from=str(path), **opts)
    assert whole["steps"] == 2 * chunk and resumed["steps"] == chunk
    assert resumed["t"] == whole["t"] and resumed["residual"] == whole[
        "residual"]
    np.testing.assert_array_equal(resumed["u"], whole["u"])
    # a float64 polish of a float32 state: read in the run's dtype
    f32 = dataclasses.replace(
        state, **{k: getattr(state, k).float() for k in ("u", "v", "p")})
    pt.save_checkpoint(str(path), f32)
    polished = validation.lid_driven_cavity(max_steps=chunk,
                                            resume_from=str(path), **opts)
    assert np.isfinite(polished["u"]).all()


@pytest.mark.parametrize("argv, fn, want", [
    (["periodic_taylor_green", "49", "--solid"], "taylor_green_decay",
     dict(N=49, with_solid=True)),
    (["periodic_taylor_green"], "taylor_green_decay",
     dict(N=129, with_solid=False)),
    (["lid_driven_cavity", "100", "33", "--resume", "ck.npz"],
     "lid_driven_cavity", dict(Re=100.0, N=33, resume_from="ck.npz")),
])
def test_cli_takes_the_drivers_flags(monkeypatch, argv, fn, want):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return [], {}

    monkeypatch.setattr(cli.v, fn, fake)
    cli.run(argv[0], argv[1:], DEV, torch.float64, None)
    assert {k: seen[k] for k in want} == want
