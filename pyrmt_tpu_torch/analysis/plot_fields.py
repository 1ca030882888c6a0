"""One snapshot as a 2x2 panel (the port's copy of
``benchmarks/analysis/plot_fields.py``): the speed with the solid blanked,
its interface and the reference map's contours inside it; the pressure;
J in the solid; the velocity's divergence (where the snapshot holds
``div_vel``).

Usage:
    python -m pyrmt_tpu_torch.analysis.plot_fields RUN_DIR      # last frame
    python -m pyrmt_tpu_torch.analysis.plot_fields SNAPSHOT_FILE
"""
from __future__ import annotations

import os
import sys

import numpy as np

from pyrmt_tpu_torch.analysis.common import (
    frame_grid,
    list_frames,
    load_frame,
)


def resolve_frame(source):
    """A snapshot file, or a directory's last ``data_??????`` frame."""
    if os.path.isdir(source):
        frames = list_frames(source)
        if not frames:
            sys.exit(f"no data_??????.h5/.npz frames in {source}")
        return frames[-1][1]
    return source


def run(source, out_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = resolve_frame(source)
    fields, attrs = load_frame(path)
    phi = fields["phi"]
    multi = phi.ndim == 3
    phi0 = phi[0] if multi else phi
    X, Y, dx, dy = frame_grid(phi0)
    a, b, p = fields["a"], fields["b"], fields["p"]
    umag = np.hypot(a, b)

    fig, axes = plt.subplots(2, 2, figsize=(11, 10))
    (ax_u, ax_p), (ax_j, ax_d) = axes

    solid = (phi <= 0).any(axis=0) if multi else (phi <= 0)
    cf = ax_u.contourf(X, Y, np.where(solid, np.nan, umag), levels=50,
                       cmap="Spectral_r")
    fig.colorbar(cf, ax=ax_u, shrink=0.85)
    phis = phi if multi else phi[None]
    X1s = fields["X1"] if multi else fields["X1"][None]
    X2s = fields["X2"] if multi else fields["X2"][None]
    if X1s.ndim == 2:
        X1s, X2s = X1s[None], X2s[None]
    for i in range(phis.shape[0]):
        ph = phis[i]
        ax_u.contour(X, Y, ph, levels=[0.0], colors="black", linewidths=1.5)
        ax_u.contour(X, Y, np.where(ph <= 0, X1s[i], np.nan), levels=15,
                     colors="black", linewidths=0.4)
        ax_u.contour(X, Y, np.where(ph <= 0, X2s[i], np.nan), levels=15,
                     colors="black", linewidths=0.4, linestyles="dashed")
    ax_u.set_title("|u| + interface + reference-map contours")

    im = ax_p.pcolormesh(X, Y, p, cmap="RdBu_r", shading="auto")
    fig.colorbar(im, ax=ax_p, shrink=0.85)
    ax_p.set_title("pressure")

    J = fields.get("J")
    if J is not None:
        J0 = np.where(solid, J[0] if J.ndim == 3 else J, np.nan)
        im = ax_j.pcolormesh(X, Y, J0, cmap="viridis", shading="auto")
        fig.colorbar(im, ax=ax_j, shrink=0.85)
        ax_j.set_title(f"J in solid (min {np.nanmin(J0):.3f})")

    div = fields.get("div_vel")
    if div is not None:
        im = ax_d.pcolormesh(X, Y, div, cmap="RdBu_r", shading="auto")
        fig.colorbar(im, ax=ax_d, shrink=0.85)
        ax_d.set_title(f"div(u) (max interior |div| "
                       f"{np.abs(div[4:-4, 4:-4]).max():.2e})")

    for ax in axes.ravel():
        ax.set_aspect("equal")
    t = attrs.get("time", attrs.get("t"))
    fig.suptitle(os.path.basename(path)
                 + (f"  (t = {float(t):.3f})" if t is not None else ""))
    fig.tight_layout()

    out_path = out_path or os.path.splitext(path)[0] + "_fields.png"
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    print(f"[plot_fields] wrote {out_path}")
    return out_path


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        sys.exit(__doc__)
    run(args[0])
