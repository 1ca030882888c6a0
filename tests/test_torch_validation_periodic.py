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
  pyrmt_tpu_torch.validation``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import pyrmt_tpu_torch as pt
from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation import __main__ as cli

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
KW = dict(dtype=torch.float64, device=DEV)
TG = dict(N=49, t_end=0.05, log_every=10)


def test_periodic_taylor_green_solid_matches_the_jax_driver(tmp_path):
    from benchmarks.periodic_taylor_green import run

    j_rows, js = run(with_solid=True, dtype="float64", verbose=False,
                     out_root=str(tmp_path), **TG)
    rows, s = validation.taylor_green_decay(with_solid=True, **TG, **KW)
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
