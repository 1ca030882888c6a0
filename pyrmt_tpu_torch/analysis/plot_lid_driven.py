"""The lid-driven cavity's centreline u(y) against Ghia et al. (1982)
(the port's copy of ``benchmarks/analysis/plot_lid_driven.py``): from
the lid cavity case's ``centerline_u_vs_y.csv`` or from a snapshot's u
at x = 0.5, with Ghia's points for the Reynolds number
(``data/plot_u_y_Ghia{Re}.csv``) and their RMS difference.

Usage:
    python -m pyrmt_tpu_torch.analysis.plot_lid_driven RUN_DIR [Re]
    python -m pyrmt_tpu_torch.analysis.plot_lid_driven SNAPSHOT_FILE [Re]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from pyrmt_tpu_torch.analysis.common import load_csv, load_frame
from pyrmt_tpu_torch.validation.common import DATA_DIR, load_xy_csv


def centerline_from_source(source):
    """(y, u at x = 0.5) from a run directory's CSV or a snapshot."""
    if os.path.isdir(source):
        cols = load_csv(os.path.join(source, "centerline_u_vs_y.csv"))
        return cols["y"], cols["u"]
    fields, _ = load_frame(source)
    a = fields["a"]
    Ny, Nx = a.shape
    return np.linspace(0.0, 1.0, Ny), a[:, Nx // 2]


def ghia_rms(y, u, Re=100):
    """(Ghia's y, Ghia's u, the RMS of u interpolated at Ghia's y)."""
    yg, ug = load_xy_csv(DATA_DIR / f"plot_u_y_Ghia{int(Re)}.csv",
                         has_header=True)
    return yg, ug, float(np.sqrt(np.mean((np.interp(yg, y, u) - ug) ** 2)))


def run(source, Re=100, out_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y, u = centerline_from_source(source)
    yg, ug, rms = ghia_rms(y, u, Re)

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(u, y, "-", lw=1.5, label="this framework")
    ax.plot(ug, yg, "o", ms=5, mfc="none", label=f"Ghia 1982 (Re={int(Re)})")
    ax.set_xlabel("u at x = 0.5")
    ax.set_ylabel("y")
    ax.set_title(f"Lid-driven cavity centerline, RMS = {rms:.2e}")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()

    base = source if os.path.isdir(source) else os.path.dirname(source)
    out_path = out_path or os.path.join(base,
                                        f"ghia_centerline_Re{int(Re)}.png")
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    print(f"[plot_lid_driven] wrote {out_path}  (RMS vs Ghia: {rms:.3e})")
    return rms


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        sys.exit(__doc__)
    run(args[0], Re=int(args[1]) if len(args) > 1 else 100)
