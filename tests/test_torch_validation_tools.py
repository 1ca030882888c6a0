"""The port's profiler (``pyrmt_tpu_torch.profiling``), the twins of the
JAX package's examples (``pyrmt_tpu_torch.examples``) and the validation
cases' command line (``python -m pyrmt_tpu_torch.validation``), at tiny
sizes on the CPU: each runs and returns its keys (the command line
also writes a case's files with ``--out-root``). ``ablation_breakdown``
times its chunks of at least 500 steps (two of its rows here, at N=16),
and refuses fewer; ``trace`` writes a Chrome trace; the inverse problem
runs two Adam and two secant evaluations; the command line prints the
summary of the function it calls as one JSON line."""
import json
import os

import pytest
import torch

from pyrmt_tpu_torch import profiling, validation
from pyrmt_tpu_torch.examples import differentiable_fsi, soft_disc_minimal
from pyrmt_tpu_torch.validation.__main__ import main as validation_main

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
STAGES = ("momentum_rk4", "projection", "advection_gather",
          "advection_local", "extrapolation_xla", "extrapolation_pallas",
          "full_step")


def test_stage_breakdown_times_every_stage():
    ms = profiling.stage_breakdown(N=16, iters=2, device=DEV, verbose=False)
    assert tuple(ms) == STAGES
    assert all(t > 0.0 for t in ms.values())


def test_ablation_breakdown_times_chunks_of_500_steps(monkeypatch):
    rows = profiling._ablations()
    assert [r[0] for r in rows] == [
        "all defaults", "tile_skip=False (no solid-free skip)",
        "rmt_block plain twin (JAX's rmt_method=xla)",
        "momentum_method=xla", "sl_local=False (gather advection)",
        "projection_method=pallas"]
    with pytest.raises(ValueError, match="at least 500"):
        profiling.ablation_breakdown(N=16, steps=50, device=DEV)
    monkeypatch.setattr(profiling, "_ablations", lambda: rows[::5])
    seen = []
    ms = profiling.ablation_breakdown(N=16, steps=500, warmup=1, device=DEV,
                                      verbose=False, on_row=seen.append)
    assert list(ms) == seen == ["all defaults", "projection_method=pallas"]
    assert all(t > 0.0 for t in ms.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        soft_disc_minimal.main(N=16, chunks=1, chunk_steps=2, device=DEV,
                               verbose=False)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
    assert prof.key_averages()


def test_soft_disc_minimal_checkpoints_and_resumes():
    out = soft_disc_minimal.main(N=16, chunks=2, chunk_steps=5, device=DEV,
                                 verbose=False)
    assert len(out["t"]) == len(out["umax"]) == 2
    assert out["t"][1] > out["t"][0] > 0.0
    assert out["resume_exact"] and out["resumed_t"] > out["t"][1]


def test_differentiable_fsi_moves_toward_the_modulus():
    out = differentiable_fsi.recover_mu_s(N=16, n_steps=5, adam_steps=2,
                                          secant_steps=2, device=DEV,
                                          verbose=False)
    assert set(out) == {"mu_s", "rel_err", "trace", "wall_s"}
    assert len(out["trace"]) == 4
    (mu0, loss0), (_, loss_last) = out["trace"][0], out["trace"][-1]
    assert mu0 == pytest.approx(1.2) and loss_last < loss0
    assert abs(out["mu_s"] - 0.4) < abs(mu0 - 0.4)


def test_validation_command_line_prints_the_summary(capsys, tmp_path):
    """... and with --out-root writes the case's files there."""
    assert validation_main(["two_disc_contact", "32", "0.01", "0.15", "2.0",
                            "--cpu", "--f64", "--out-root",
                            str(tmp_path)]) == 0
    assert os.listdir(tmp_path) == ["two_disc_contact_N32"]
    assert validation.common.check_outputs(
        "two_disc_contact", tmp_path / "two_disc_contact_N32") == {
        "centroids.csv": 1}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    _, want = validation.two_disc_contact(N=32, t_end=0.01,
                                          dtype=torch.float64, device=DEV)
    assert got["case"] == "two_disc_contact" and got["device"] == "cpu"
    assert got["gmin"] == want["gmin"] and got["steps"] == want["steps"]


def test_validation_command_line_refuses_an_unknown_case():
    with pytest.raises(SystemExit, match="unknown case"):
        validation_main(["benchmark_everything", "--cpu"])
    assert validation_main([]) == 2
    assert os.path.exists(validation.common.DATA_DIR
                          / "Sugiyama_1024x1024.csv")


def test_validation_profiling_and_examples_import_without_jax():
    """The new modules import with jax, the JAX package, its benchmarks
    and helpers made unimportable (the port keeps its own copies of the
    drivers' helpers), and the post-processing also without matplotlib
    and imageio (they are imported where a figure is drawn)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "for m in ('jax', 'pyrmt_tpu', 'benchmarks', 'helper', 'matplotlib',"
        " 'imageio'): sys.modules[m] = None\n"
        "import pyrmt_tpu_torch.validation, pyrmt_tpu_torch.profiling\n"
        "import pyrmt_tpu_torch.validation.__main__\n"
        "import pyrmt_tpu_torch.examples.soft_disc_minimal\n"
        "import pyrmt_tpu_torch.examples.differentiable_fsi\n"
        "import pyrmt_tpu_torch.analysis\n"
        "from pyrmt_tpu_torch.analysis import (lid_driven_gif, plot_centroid,"
        " plot_energy, plot_fields, plot_lid_driven, plot_soft_disc_panels,"
        " simulation_gif)\n"
        "assert not any(m.split('.')[0] in ('jax', 'pyrmt_tpu', 'benchmarks',"
        " 'helper', 'matplotlib', 'imageio')"
        " for m, mod in sys.modules.items() if mod is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
