"""The solid's centroid track and area from a run's snapshot frames (the
port's copy of ``benchmarks/analysis/plot_centroid.py``): the centroid
and area of phi <= 0 in each ``data_??????`` frame, drawn as x(t) and
y(t), the orbit and the relative area drift; without frames, the soft
disc case's ``centroid.csv`` (t, cx, cy). ``--refs`` overlays the
published tracks of Sugiyama et al. (2011) and Kolahduz (2023)
(``data/*.csv``).

Usage:
    python -m pyrmt_tpu_torch.analysis.plot_centroid RUN_DIR [--refs]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from pyrmt_tpu_torch.analysis.common import (
    frame_grid,
    get_area,
    get_centroid,
    list_frames,
    load_csv,
    load_frame,
)
from pyrmt_tpu_torch.validation.common import DATA_DIR, load_xy_csv

REFS = (("Sugiyama 2011 (1024²)", "Sugiyama_1024x1024.csv"),
        ("Kolahduz 2023", "Kolahduz_2023.csv"))


def compute_centroids(frames_dir):
    """(times, centroids, areas) over the directory's frames with a solid
    (the first solid of a stack)."""
    times, cents, areas = [], [], []
    for step, path in list_frames(frames_dir):
        fields, attrs = load_frame(path)
        phi = fields["phi"]
        if phi.ndim == 3:
            phi = phi[0]
        X, Y, dx, dy = frame_grid(phi)
        c = get_centroid(phi, X, Y)
        if c is None:
            continue
        times.append(float(attrs.get("time", step)))
        cents.append(c)
        areas.append(get_area(phi, dx, dy))
    return np.asarray(times), np.asarray(cents), np.asarray(areas)


def centroids_from_csv(run_dir):
    """(times, centroids, None) from the soft disc case's
    ``centroid.csv``, or None where the run has none."""
    path = os.path.join(run_dir, "centroid.csv")
    if not os.path.isfile(path):
        return None
    cols = load_csv(path)
    return cols["t"], np.column_stack([cols["cx"], cols["cy"]]), None


def run(frames_dir, out_path=None, with_refs=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, cents, areas = compute_centroids(frames_dir)
    if len(cents) == 0:
        from_csv = centroids_from_csv(frames_dir)
        if from_csv is None:
            sys.exit(f"no frames with a solid found in {frames_dir}")
        t, cents, areas = from_csv

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
    ax_t, ax_orbit, ax_area = axes
    ax_t.plot(t, cents[:, 0], label="x_c(t)")
    ax_t.plot(t, cents[:, 1], label="y_c(t)")
    ax_t.set_xlabel("t")
    ax_t.set_ylabel("centroid")
    ax_t.set_title("Centroid components vs time")

    ax_orbit.plot(cents[:, 0], cents[:, 1], "-", lw=1.2, label="this run")
    if with_refs:
        for name, fname in REFS:
            xr, yr = load_xy_csv(DATA_DIR / fname)
            ax_orbit.plot(xr, yr, "--", lw=1.0, label=name)
    ax_orbit.set_xlabel("x_c")
    ax_orbit.set_ylabel("y_c")
    ax_orbit.set_title("Centroid orbit")
    ax_orbit.set_aspect("equal")

    if areas is not None:
        ax_area.plot(t, (areas / areas[0] - 1.0) * 100.0)
        ax_area.set_ylabel("area drift [%]")
        ax_area.set_title("Solid area conservation")
    else:
        ax_area.set_title("(no frames: area unavailable)")
    ax_area.set_xlabel("t")

    for ax in axes:
        ax.grid(alpha=0.3)
        if ax.get_legend_handles_labels()[0]:
            ax.legend(fontsize=8)
    fig.tight_layout()
    out_path = out_path or os.path.join(frames_dir, "centroid_analysis.png")
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    area_note = ("" if areas is None else
                 f", area drift {(areas[-1] / areas[0] - 1) * 100:+.2f}%")
    print(f"[plot_centroid] wrote {out_path}  "
          f"(x extent {cents[:, 0].max() - cents[:, 0].min():.3f}, "
          f"max reach {cents[:, 0].max():.3f}{area_note})")
    return out_path


if __name__ == "__main__":
    args = sys.argv[1:]
    dirs = [a for a in args if not a.startswith("--")]
    if not dirs:
        sys.exit(__doc__)
    run(dirs[0], with_refs="--refs" in args)
