"""The sedimentation pack (``validation.sedimentation_pack``) against
``benchmarks/sedimentation_pack.py::run`` at N=32 float64, two discs of
R = 0.1, to t = 0.02 in chunks of 5 steps (the JAX driver runs once,
jitted): every logged row to 1e-10 relative, the CG's largest iteration
counts equal; the files under ``out_root`` (``settling.csv`` and
``resume_meta.npz``, the first areas) with the same names, header, rows
and keys likewise, and ``out_root`` and ``ckpt_dir`` naming one
directory (a ValueError where they differ). Then the JAX package's gate
(tests/test_validation_gates.py::test_gate_sedimentation_pack_small) on
the port at its own size: N=48, S=3, R=0.1 to t = 0.25 in float64 (~7 s):
stable, no pass-through, a monotone mean height, at most 99 CG iterations
a step, area drift below 5 %. Besides: a run interrupted by ``max_chunks``
and resumed from its checkpoint (``io.save_checkpoint``) equals the run
without the interruption."""
import os

import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.validation.common import (
    check_outputs,
    compare_outputs,
    pack_positions,
)

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
RUN = dict(N=32, S=2, R=0.1, t_end=0.02, log_every=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from benchmarks.sedimentation_pack import run

    out = tmp_path_factory.mktemp("out")
    return (run(dtype="float64", verbose=False, out_root=str(out / "jax"),
                **RUN),
            validation.sedimentation_pack(dtype=torch.float64, device=DEV,
                                          out_root=str(out / "port"), **RUN),
            out)


def test_sedimentation_matches_the_jax_driver(runs):
    (j_rows, js), (rows, s), _ = runs
    assert len(rows) == len(j_rows) == 4
    for r, jr in zip(rows, j_rows):
        assert list(r) == list(jr)
        assert r["cg_iters_max"] == jr["cg_iters_max"] > 0
        np.testing.assert_allclose(list(r.values()), list(jr.values()),
                                   rtol=1e-10, atol=1e-13)
    for k in ("dmin", "gap_floor", "ybar_final", "ke_final", "ke_peak",
              "minJ", "cg_iters_max", "area_drift"):
        np.testing.assert_allclose(s[k], js[k], rtol=1e-10, atol=1e-13,
                                   err_msg=k)
    for k in ("stable", "no_passthrough", "ybar_monotone", "steps"):
        assert s[k] == js[k], k


def test_sedimentation_files_match_the_jax_driver(runs):
    _, (rows, _), out = runs
    d = "sedimentation_N32_S2"
    assert compare_outputs(out / "port" / d, out / "jax" / d) == [
        "resume_meta.npz", "settling.csv"]
    for who in ("port", "jax"):
        check_outputs("sedimentation_pack", out / who / d, rows=len(rows))


def test_out_root_and_ckpt_dir_name_one_directory(tmp_path):
    kw = dict(N=24, S=2, R=0.1, t_end=0.01, log_every=5,
              dtype=torch.float64, device=DEV, out_root=str(tmp_path))
    with pytest.raises(ValueError, match="not the run's directory"):
        validation.sedimentation_pack(ckpt_dir=tmp_path / "elsewhere", **kw)
    with pytest.raises(ValueError, match="not the run's directory"):
        validation.capillary_drop_coupled(ckpt_dir=tmp_path, **{
            k: v for k, v in kw.items() if k not in ("S", "R")})
    assert os.listdir(tmp_path) == []
    rows, _ = validation.sedimentation_pack(
        ckpt_dir=tmp_path / "sedimentation_N24_S2", **kw)
    check_outputs("sedimentation_pack", tmp_path / "sedimentation_N24_S2",
                  rows=len(rows))


def test_gate_sedimentation_pack_small():
    """The JAX package's n-solid gate, on the port."""
    _, s = validation.sedimentation_pack(N=48, S=3, R=0.1, t_end=0.25,
                                         dtype=torch.float64, device=DEV)
    assert s["stable"]
    assert s["no_passthrough"], (s["dmin"], s["gap_floor"])
    assert s["ybar_monotone"]
    assert s["cg_iters_max"] < 100
    assert s["area_drift"] < 0.05


def test_sedimentation_resumes_from_its_checkpoint(tmp_path):
    kw = dict(N=32, S=2, R=0.1, t_end=0.03, log_every=5,
              dtype=torch.float64, device=DEV)
    rows, s = validation.sedimentation_pack(**kw)
    part, _ = validation.sedimentation_pack(ckpt_dir=tmp_path, max_chunks=3,
                                            **kw)
    assert len(part) == 3 and len(rows) == 6
    rest, r = validation.sedimentation_pack(ckpt_dir=tmp_path, resume=True,
                                            **kw)
    assert rest == rows  # the first areas come back from the checkpoint
    assert r["steps"] == s["steps"] == 30


def test_pack_positions_stagger_the_rows():
    pos = pack_positions(10, 0.06)
    assert len(pos) == 10
    ys = sorted({round(y, 12) for _, y in pos}, reverse=True)
    assert ys[0] == 0.82 and len(ys) == 3
    assert all(0.0 < x < 1.0 for x, _ in pos)
