"""The coupled capillary drop (``validation.capillary_drop_coupled``)
against ``benchmarks/capillary_drop_coupled.py::run``, N=32 float64 to
t = 0.03 in chunks of 10 steps, two configurations (each JAX driver run
once, jitted): the driver's default (the balanced CSF, the ellipse on the
fused tier), and the cell CSF with kappa* under ``--areafix --rebase=10``
(the split tier, a rebase on every step, counted from aux['rebased']).
Every logged row to 1e-10 relative, the rebase counts equal, the summary's
numbers likewise; the files under ``out_root`` (``oscillation.csv`` in
the JAX driver's directory of each option set) with the same names,
header and rows likewise. Besides: the command line's overrides and a run
interrupted by ``max_chunks`` and resumed from its checkpoint equal to the
run without the interruption."""
import math
import os

import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.__main__ import capillary_overrides
from pyrmt_tpu_torch.validation.common import check_outputs, compare_outputs

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
RUN = dict(N=32, t_end=0.03, log_every=10)
CASES = {"balanced": dict(),
         "csf kstar areafix rebase": dict(
             st_method="csf", kappa_interface=True,
             cfg_overrides=dict(phi_area_fix=True, map_rebase_minj=10.0))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.capillary_drop_coupled import run

    out = tmp_path_factory.mktemp("out")
    runs = {name: (run(dtype="float64", verbose=False,
                       out_root=str(out / "jax"), **RUN, **over),
                   validation.capillary_drop_coupled(
                       dtype=torch.float64, device=DEV,
                       out_root=str(out / "port"), **RUN, **over))
            for name, over in CASES.items()}
    return dict(runs, out=out)


@pytest.mark.parametrize("name", list(CASES))
def test_capillary_drop_matches_the_jax_driver(runs, name):
    (j_rows, js), (rows, s) = runs[name]
    assert len(rows) == len(j_rows) == 3
    for r, jr in zip(rows, j_rows):
        assert list(r) == list(jr)
        np.testing.assert_allclose(list(r.values()), list(jr.values()),
                                   rtol=1e-10, atol=1e-13)
    for k, want in js.items():
        if k in ("wall_s", "steps_per_s"):
            continue
        if isinstance(want, float) and math.isnan(want):
            assert math.isnan(s[k]), k
        elif isinstance(want, bool):
            assert s[k] == want, k
        else:
            np.testing.assert_allclose(s[k], want, rtol=1e-10, atol=1e-13,
                                       err_msg=k)
    assert s["rebases"] == (30.0 if "rebase" in name else 0.0)


def test_capillary_files_match_the_jax_driver(runs):
    out = runs["out"]
    assert sorted(os.listdir(out / "port")) == sorted(os.listdir(
        out / "jax")) == ["capillary_drop_N32", "capillary_drop_N32_csf_kstar"]
    for d in os.listdir(out / "jax"):
        assert compare_outputs(out / "port" / d, out / "jax" / d) == [
            "oscillation.csv"]
        for who in ("port", "jax"):
            check_outputs("capillary_drop_coupled", out / who / d, rows=3)


def test_capillary_command_line_overrides():
    over, t_end, tag = capillary_overrides(
        ["--kstar", "--areafix", "--reinit", "--tend=1.5", "--rebase=0.25"])
    assert over == dict(phi_area_fix=True, reinit_method="fmm",
                        map_rebase_minj=0.25)
    assert t_end == 1.5 and tag == "reinit_areafix_rebase0.25"
    over, t_end, tag = capillary_overrides(["--hf-smooth", "--rebase"])
    assert over == dict(st_curvature="hf", st_hf_smooth=2,
                        map_rebase_minj=0.5)
    assert t_end == 4.5 and tag == "hfsmooth_rebase0.5"


def test_capillary_drop_resumes_from_its_checkpoint(tmp_path):
    kw = dict(N=32, t_end=0.05, log_every=5, dtype=torch.float64,
              device=DEV)
    rows, s = validation.capillary_drop_coupled(**kw)
    part, _ = validation.capillary_drop_coupled(ckpt_dir=tmp_path,
                                                max_chunks=4, **kw)
    assert len(part) == 4
    rest, r = validation.capillary_drop_coupled(ckpt_dir=tmp_path,
                                                resume=True, **kw)
    assert rest == rows
    assert r["steps"] == s["steps"] and r["area_drift"] == s["area_drift"]
