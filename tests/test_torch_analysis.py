"""The port's post-processing (``pyrmt_tpu_torch.analysis``) and the
validation cases' signatures and command line, on the CPU:

- the readers give what ``benchmarks/analysis/common.py``'s (and the JAX
  scripts' own readers) give on the same files, bit for bit: frames as
  ``.h5`` and ``.npz``, their grid, centroid and area, the energy CSV in
  both layouts, the soft disc's snapshots and ``centroid.csv``, the lid
  cavity's centreline;
- every figure and movie renders (matplotlib; the movies also imageio);
- each validation core takes every parameter of its JAX driver's ``run``
  under its name, JAX's first in JAX's order up to ``out_root``
  (``DEVIATIONS`` would give each exception its reason, and is empty);
- ``python -m pyrmt_tpu_torch.validation ... --out-root DIR`` hands DIR
  to every case (``tests/test_torch_validation_tools.py`` runs one), and
  ``--cache`` reaches the convergence study.
"""
import csv
import inspect
import os

import numpy as np
import pytest
import torch

from pyrmt_tpu_torch import validation
from pyrmt_tpu_torch.analysis import common as readers
from pyrmt_tpu_torch.io import save_snapshot
from pyrmt_tpu_torch.validation import __main__ as cli

torch.set_num_threads(1)
DEV = "cpu"  # the entry points default to the card
# each core: (its JAX driver's module, function)
CORES = {
    "soft_disc_in_lid_driven": ("soft_disc_in_lid_driven", "run"),
    "lid_driven_cavity": ("lid_driven_cavity", "run"),
    "taylor_green_decay": ("periodic_taylor_green", "run"),
    "laplace_drop": ("surface_tension_drop", "run"),
    "density_contrast": ("density_contrast_disc", "run"),
    "disc_in_taylor_green": ("disc_in_taylor_green", "run"),
    "two_disc_contact": ("two_disc_contact", "run"),
    "two_disc_tg_collision": ("two_disc_tg_collision", "run"),
    "convergence_taylor_green": ("convergence_taylor_green", "run"),
    "simulate_tg": ("convergence_taylor_green", "simulate_tg"),
    "capillary_drop_coupled": ("capillary_drop_coupled", "run"),
    "sedimentation_pack": ("sedimentation_pack", "run"),
}
# core: the reason its parameters differ from its JAX driver's (none does)
DEVIATIONS = {}


def disc_fields(n, x0=0.5, y0=0.5, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(x, x)
    return dict(phi=np.hypot(X - x0, Y - y0) - 0.2, X1=X, X2=Y,
                a=np.sin(3 * X) * np.cos(2 * Y), b=-np.cos(3 * X) * Y,
                p=rng.standard_normal((n, n)), J=1 + 0.01 * X * Y,
                div_vel=1e-3 * rng.standard_normal((n, n)))


@pytest.fixture
def run_dir(tmp_path):
    """A run directory: two frames (.h5 and .npz), two snapshots, the
    energy CSV, the soft disc's centroid.csv, the lid's centreline."""
    for k, (step, ext) in enumerate(((100, "h5"), (200, "npz"))):
        save_snapshot(str(tmp_path / f"data_{step:06d}.{ext}"),
                      disc_fields(24, 0.4 + 0.1 * k, seed=k),
                      attrs={"time": 0.5 * (k + 1)})
        save_snapshot(str(tmp_path / f"snap_t{0.5 * (k + 1):05.2f}.{ext}"),
                      disc_fields(24, 0.5, 0.4 + 0.1 * k, seed=k),
                      attrs={"t": 0.5 * (k + 1) + 1e-3,
                             "t_target": 0.5 * (k + 1)})
    with open(tmp_path / "energy_history.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["t", "ke", "se", "dissipation",
                                          "total_energy"])
        w.writeheader()
        for i in range(5):
            w.writerow(dict(t=0.1 * i, ke=1.0 - 0.01 * i, se=0.01 * i,
                            dissipation=1e-3 * i, total_energy=1.0))
    t = np.linspace(0, 1, 8)
    validation.common.save_table(
        tmp_path / "centroid.csv",
        np.column_stack([t, 0.5 + 0.1 * np.sin(6 * t),
                         0.5 + 0.1 * np.cos(6 * t), 0.99 + 0 * t,
                         1.01 + 0 * t]), ("t", "cx", "cy", "minJ", "maxJ"))
    y = np.linspace(0, 1, 17)
    validation.common.save_table(tmp_path / "centerline_u_vs_y.csv",
                                 np.column_stack([y, y**3 - 0.2 * y]),
                                 ("y", "u"))
    return tmp_path


def test_readers_equal_the_jax_package_s(run_dir):
    from benchmarks.analysis import common as jreaders
    from benchmarks.analysis.plot_centroid import _centroids_from_csv
    from benchmarks.analysis.plot_lid_driven import _centerline_from_source
    from benchmarks.plot_soft_disc_panels import SnapshotSeries as JSeries

    from pyrmt_tpu_torch.analysis.plot_centroid import (
        centroids_from_csv,
        compute_centroids,
    )
    from pyrmt_tpu_torch.analysis.plot_lid_driven import (
        centerline_from_source,
    )
    from pyrmt_tpu_torch.analysis.plot_soft_disc_panels import SnapshotSeries

    frames = readers.list_frames(str(run_dir))
    assert frames == jreaders.list_frames(str(run_dir))
    assert [s for s, _ in frames] == [100, 200]
    for _, path in frames:
        (f, a), (jf, ja) = readers.load_frame(path), jreaders.load_frame(path)
        assert sorted(f) == sorted(jf) and a == ja
        assert all(np.array_equal(f[k], jf[k]) for k in f)
        grid, jgrid = readers.frame_grid(f["phi"]), jreaders.frame_grid(
            jf["phi"])
        assert all(np.array_equal(g, j) for g, j in zip(grid, jgrid))
        X, Y, dx, dy = grid
        assert readers.get_centroid(f["phi"], X, Y) == \
            jreaders.get_centroid(jf["phi"], X, Y)
        assert readers.get_area(f["phi"], dx, dy) == jreaders.get_area(
            jf["phi"], dx, dy)
    assert readers.get_centroid(np.ones((4, 4)), X[:4, :4], Y[:4, :4]) \
        is None
    cols, jcols = readers.load_energy_csv(run_dir), jreaders.load_energy_csv(
        str(run_dir))
    assert list(cols) == list(jcols) == ["time", "kinetic_energy",
                                         "strain_energy", "dissipation_rate",
                                         "total_energy"]
    assert all(np.array_equal(cols[k], jcols[k]) for k in cols)
    t, c, _ = compute_centroids(str(run_dir))
    assert t.tolist() == [0.5, 1.0] and c.shape == (2, 2)
    (t, c, none), (jt, jc, jnone) = (centroids_from_csv(str(run_dir)),
                                     _centroids_from_csv(str(run_dir)))
    assert none is jnone is None
    assert np.array_equal(t, jt) and np.array_equal(c, jc)
    for got, want in zip(centerline_from_source(str(run_dir)),
                         _centerline_from_source(str(run_dir))):
        assert np.array_equal(got, want)
    series, jseries = SnapshotSeries(str(run_dir)), JSeries(str(run_dir))
    assert len(series) == len(jseries) == 2
    for fr, jfr in zip(series.frames, jseries.frames):
        assert sorted(fr) == sorted(jfr) and fr["_t"] == jfr["_t"]
        assert all(np.array_equal(fr[k], jfr[k]) for k in fr)
    table = readers.load_csv(run_dir / "centroid.csv")
    data = np.loadtxt(run_dir / "centroid.csv", delimiter=",", skiprows=1)
    assert list(table) == ["t", "cx", "cy", "minJ", "maxJ"]
    assert np.array_equal(np.column_stack(list(table.values())), data)


def test_plots_render(run_dir, tmp_path_factory):
    pytest.importorskip("matplotlib")
    from pyrmt_tpu_torch.analysis import (
        plot_centroid,
        plot_energy,
        plot_fields,
        plot_lid_driven,
    )

    out = tmp_path_factory.mktemp("png")
    paths = [
        plot_energy.run([str(run_dir)], out_path=str(out / "e.png")),
        plot_centroid.run(str(run_dir), out_path=str(out / "c.png"),
                          with_refs=True),
        plot_fields.run(str(run_dir), out_path=str(out / "f.png"))]
    csv_only = tmp_path_factory.mktemp("csv_only")
    os.replace(run_dir / "centroid.csv", csv_only / "centroid.csv")
    paths.append(plot_centroid.run(str(csv_only),
                                   out_path=str(out / "c2.png")))
    rms = plot_lid_driven.run(str(run_dir), Re=100,
                              out_path=str(out / "g.png"))
    assert np.isfinite(rms) and (out / "g.png").stat().st_size > 10_000
    for p in paths:
        assert os.path.getsize(p) > 10_000, p


def test_soft_disc_panels_and_movies_render(run_dir, tmp_path):
    pytest.importorskip("matplotlib")
    from pyrmt_tpu_torch.analysis import lid_driven_gif, simulation_gif
    from pyrmt_tpu_torch.analysis.plot_soft_disc_panels import main

    other = tmp_path / "N32"
    other.mkdir()
    for k in range(2):
        save_snapshot(str(other / f"snap_t{0.5 * (k + 1):05.2f}.npz"),
                      disc_fields(32, seed=k),
                      attrs={"t": 0.5 * (k + 1), "t_target": 0.5 * (k + 1)})
    out = main(["plot_soft_disc_panels", str(run_dir), str(other), "--out",
                str(tmp_path / "panels")])
    assert sorted(os.listdir(out)) == sorted(
        [f"panels_{run_dir.name}.png", "panels_N32.png",
         "interface_overlay.png"])
    assert all(os.path.getsize(os.path.join(out, f)) > 10_000
               for f in os.listdir(out))
    pytest.importorskip("imageio")
    for path in (simulation_gif.make_gif(str(run_dir),
                                         str(tmp_path / "s.gif")),
                 lid_driven_gif.make_movie(str(run_dir),
                                           str(tmp_path / "l.gif"))):
        assert os.path.getsize(path) > 1_000


@pytest.mark.parametrize("core", sorted(CORES))
def test_cores_take_their_jax_driver_s_parameters(core):
    import importlib

    module, name = CORES[core]
    jfn = getattr(importlib.import_module(f"benchmarks.{module}"), name)
    want = list(inspect.signature(jfn).parameters)
    got = list(inspect.signature(getattr(validation, core)).parameters)
    if core in DEVIATIONS:
        assert not set(want) <= set(got)  # the entry is still needed
        return
    assert set(want) <= set(got), (core, sorted(set(want) - set(got)))
    lead = want[:want.index("out_root") + 1] if "out_root" in want else want
    assert got[:len(lead)] == lead, (core, lead, got)
    # the port's own parameters are keywords
    params = inspect.signature(getattr(validation, core)).parameters
    assert all(params[k].kind in (inspect.Parameter.KEYWORD_ONLY,
                                  inspect.Parameter.VAR_KEYWORD)
               for k in got if k not in want)


@pytest.mark.parametrize("argv, fn, want", [
    (["convergence_taylor_green", "--cache"], "convergence_taylor_green",
     dict(cache=True, out_root="d")),
    (["capillary_drop_coupled", "48", "--csf", "--areafix"],
     "capillary_drop_coupled",
     dict(N=48, st_method="csf", tag="areafix", out_root="d")),
    (["sedimentation_pack", "32", "3", "--resume"], "sedimentation_pack",
     dict(N=32, S=3, resume=True, out_root="d")),
    (["surface_tension_drop", "32"], "laplace_drop",
     dict(N=32, out_root="d")),
])
def test_command_line_passes_out_root_and_cache(monkeypatch, argv, fn,
                                                want):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return [], {}

    monkeypatch.setattr(cli.v, fn, fake)
    cli.run(argv[0], argv[1:], DEV, torch.float64, "d")
    assert {k: seen[k] for k in want} == want
    assert "ckpt_dir" not in seen
