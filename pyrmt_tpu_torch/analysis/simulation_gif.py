"""An animated GIF of a run's snapshots (the port's copy of
``helper/simulation_gif.py``): the speed with the solid masked and the
interface, a frame a ``data_*`` or ``snap_t*`` snapshot (``.h5`` or
``.npz``). Without imageio, a strip of PNG frames instead.

Usage:
    python -m pyrmt_tpu_torch.analysis.simulation_gif SNAPSHOT_DIR
        [out.gif] [stride]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from pyrmt_tpu_torch.io import load_snapshot


def make_gif(frames_dir, out_path="simulation.gif", stride=1, fps=12):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = sorted(
        glob.glob(os.path.join(frames_dir, "data_*.h5"))
        + glob.glob(os.path.join(frames_dir, "data_*.npz"))
        + glob.glob(os.path.join(frames_dir, "snap_t*.h5"))
        + glob.glob(os.path.join(frames_dir, "snap_t*.npz"))
    )[::stride]
    if not paths:
        print(f"no snapshots in {frames_dir}")
        return None

    images = []
    for path in paths:
        fields, attrs = load_snapshot(path)
        phi = fields["phi"]
        a, b = fields["a"], fields["b"]
        Ny, Nx = phi.shape
        X, Y = np.meshgrid(np.linspace(0, 1, Nx), np.linspace(0, 1, Ny))
        umag = np.ma.masked_where(phi <= 0, np.hypot(a, b))

        fig, ax = plt.subplots(figsize=(4, 4))
        ax.contourf(X, Y, umag, levels=40, cmap="Spectral_r")
        ax.contour(X, Y, phi, levels=[0.0], colors="k", linewidths=1.2)
        t = attrs.get("time", attrs.get("t", None))
        if t is not None:
            ax.set_title(f"t = {float(t):.3f}")
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
        fig.tight_layout()
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
        plt.close(fig)

    try:
        import imageio

        imageio.mimsave(out_path, images, fps=fps)
    except ImportError:
        out_path = out_path.rsplit(".", 1)[0] + "_strip.png"
        strip = np.concatenate(images[:: max(1, len(images) // 8)], axis=1)
        import matplotlib.image as mpimg

        mpimg.imsave(out_path, strip)
    print(f"saved {out_path} ({len(images)} frames)")
    return out_path


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    make_gif(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else
             "simulation.gif", int(sys.argv[3]) if len(sys.argv) > 3 else 1)
