"""Energy histories: the kinetic and strain energies and the total energy
(KE + SE + the integrated dissipation) against time, one curve a run (the
port's copy of ``benchmarks/analysis/plot_energy.py``), from each run
directory's ``energy_history.csv`` (the disc-in-Taylor-Green case's, or
``io.output_simulation_data``'s).

Usage:
    python -m pyrmt_tpu_torch.analysis.plot_energy RUN_DIR [RUN_DIR ...]
"""
from __future__ import annotations

import os
import sys

from pyrmt_tpu_torch.analysis.common import load_energy_csv


def run(run_dirs, out_path=None, show=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    ax_ke, ax_se, ax_tot = axes
    for d in run_dirs:
        cols = load_energy_csv(d)
        label = os.path.basename(os.path.normpath(d))
        t = cols["time"]
        ax_ke.plot(t, cols["kinetic_energy"], lw=1.2, label=label)
        ax_se.plot(t, cols["strain_energy"], lw=1.2, label=label)
        if "total_energy" in cols:
            tot = cols["total_energy"]
            drift = (tot[-1] - tot[0]) / tot[0] * 100 if tot[0] else 0.0
            ax_tot.plot(t, tot, lw=1.2,
                        label=f"{label} (drift {drift:+.1f}%)")

    for ax, title, ylab in ((ax_ke, "Kinetic energy vs time", "KE"),
                            (ax_se, "Strain energy vs time", "SE"),
                            (ax_tot, "Total energy (KE+SE+∫ε)", "E_tot")):
        ax.set_xlabel("t")
        ax.set_ylabel(ylab)
        ax.set_title(title)
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()

    out_path = out_path or os.path.join(run_dirs[0], "energy_curves.png")
    fig.savefig(out_path, dpi=130)
    print(f"[plot_energy] wrote {out_path}")
    if show:
        plt.show()
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    dirs = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not dirs:
        sys.exit(__doc__)
    run(dirs)
