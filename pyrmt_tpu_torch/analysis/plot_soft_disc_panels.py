"""The soft disc case's snapshot figures (the port's copy of
``benchmarks/plot_soft_disc_panels.py``): a panel a snapshot (the fluid's
speed with the solid blanked, the phi = 0 interface and the reference
map's isolines in the solid), and the interfaces of several resolutions
overlaid a time a panel. The snapshots are the ``snap_t*`` files of
``validation.soft_disc_in_lid_driven(..., out_root=..., snapshot_times=
[...])``, ``.h5`` or ``.npz``.

Usage:
    python -m pyrmt_tpu_torch.analysis.plot_soft_disc_panels RUN_DIR
        [RUN_DIR ...] [--out DIR]

(the figures go to DIR, by default ``panels`` beside the first RUN_DIR)
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from pyrmt_tpu_torch.io import load_snapshot


class SnapshotSeries:
    """All ``snap_t*`` snapshots of one run directory, in time order."""

    def __init__(self, directory):
        self.directory = directory
        self.frames = []
        for path in sorted(glob.glob(os.path.join(directory, "snap_t*.h5"))
                           + glob.glob(os.path.join(directory,
                                                    "snap_t*.npz"))):
            fields, attrs = load_snapshot(path)
            fields["_t"] = float(attrs.get("t_target",
                                           attrs.get("t", np.nan)))
            self.frames.append(fields)

    def __len__(self):
        return len(self.frames)

    def mesh(self):
        n = self.frames[0]["phi"].shape[0]
        ax1d = np.linspace(0.0, 1.0, n)
        return np.meshgrid(ax1d, ax1d)


def _axes_grid(plt, n, per_row=4, cell=3.0):
    rows = -(-n // per_row)
    cols = min(per_row, n)
    fig, axs = plt.subplots(rows, cols, figsize=(cell * cols, cell * rows),
                            squeeze=False)
    flat = axs.ravel()
    for extra in flat[n:]:
        extra.set_visible(False)
    for ax in flat[:n]:
        ax.set_aspect("equal")
        ax.tick_params(left=False, bottom=False,
                       labelleft=False, labelbottom=False)
    return fig, flat


def render_run_panels(series: SnapshotSeries, title, path):
    """A panel a snapshot: the fluid's speed (the solid blanked), the
    phi = 0 interface and the reference map's isolines in the solid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not len(series):
        print(f"  no snapshots in {series.directory}")
        return
    gx, gy = series.mesh()
    fig, panels = _axes_grid(plt, len(series))
    for ax, frame in zip(panels, series.frames):
        phi = frame["phi"]
        solid = phi <= 0.0
        speed = np.where(solid, np.nan, np.hypot(frame["a"], frame["b"]))
        ax.pcolormesh(gx, gy, speed, cmap="viridis", shading="gouraud")
        ax.contour(gx, gy, phi, levels=[0.0], colors="w", linewidths=1.4)
        iso = np.linspace(0.0, 1.0, 12)[1:-1]
        for key in ("X1", "X2"):
            comp = np.where(solid, frame[key], np.nan)
            ax.contour(gx, gy, comp, levels=iso, colors="k",
                       linewidths=0.35, alpha=0.6)
        ax.set_title(f"t = {frame['_t']:.2f}", fontsize=9)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
    print(f"  saved {path}")


def render_interface_comparison(labeled_dirs, path):
    """The phi = 0 contours of several resolutions on shared panels, a
    time each: the interface's grid convergence."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = {lab: s for lab, s in ((lab, SnapshotSeries(d))
                                    for lab, d in labeled_dirs) if len(s)}
    if len(series) < 2:
        print("  need snapshots from two resolutions for the overlay")
        return
    n_frames = min(len(s) for s in series.values())
    fig, panels = _axes_grid(plt, n_frames)
    palette = plt.cm.tab10(np.linspace(0, 1, 10))
    for k, ax in enumerate(panels[:n_frames]):
        t_lab = None
        for ci, (lab, ser) in enumerate(series.items()):
            frame = ser.frames[k]
            gx, gy = ser.mesh()
            ax.contour(gx, gy, frame["phi"], levels=[0.0],
                       colors=[palette[ci]], linewidths=1.2)
            t_lab = frame["_t"]
        ax.set_xlim(0.0, 1.0)
        ax.set_ylim(0.0, 1.0)
        ax.set_title(f"t = {t_lab:.2f}", fontsize=9)
    fig.legend(handles=[plt.Line2D([], [], color=palette[i], label=lab)
                        for i, lab in enumerate(series)],
               loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
    print(f"  saved {path}")


def main(argv):
    args = list(argv[1:])
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    if not args:
        sys.exit(__doc__)
    out = out or os.path.join(os.path.dirname(os.path.abspath(args[0])),
                              "panels")
    os.makedirs(out, exist_ok=True)
    labeled = [(os.path.basename(os.path.normpath(d)), d) for d in args]
    for lab, d in labeled:
        render_run_panels(SnapshotSeries(d), f"soft disc in the lid-driven "
                          f"cavity ({lab})",
                          os.path.join(out, f"panels_{lab}.png"))
    if len(labeled) > 1:
        render_interface_comparison(
            labeled, os.path.join(out, "interface_overlay.png"))
    return out


if __name__ == "__main__":
    main(sys.argv)
