"""A movie of a run's ``data_??????`` frames (the port's copy of
``helper/lid_driven_gif.py``): the speed's contours with the solid
blanked white, each interface, and the reference map's iso-contours in
the solid (X1 solid, X2 dashed). GIF or MP4 with imageio, else a
directory of numbered PNG frames.

Usage:
    python -m pyrmt_tpu_torch.analysis.lid_driven_gif FRAMES_DIR
        [out.gif|out.mp4] [stride] [fps]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from pyrmt_tpu_torch.analysis.common import list_frames, load_frame


def render_frame(fields, attrs, figsize=(4.5, 4.5)):
    """One styled frame, an RGB array, from a snapshot's fields."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    phi = fields["phi"]
    multi = phi.ndim == 3
    phis = phi if multi else phi[None]
    X1s = fields["X1"] if multi else fields["X1"][None]
    X2s = fields["X2"] if multi else fields["X2"][None]
    if X1s.ndim == 2:
        X1s, X2s = X1s[None], X2s[None]
    a, b = fields["a"], fields["b"]
    Ny, Nx = a.shape
    X, Y = np.meshgrid(np.linspace(0, 1, Nx), np.linspace(0, 1, Ny))
    umag = np.hypot(a, b)
    solid_any = (phis <= 0).any(axis=0)

    fig, ax = plt.subplots(figsize=figsize)
    ax.contourf(X, Y, umag, levels=50, cmap="Spectral_r")
    ax.contourf(X, Y, solid_any.astype(float), levels=[0.5, 1.0],
                colors="white", zorder=2)
    for i in range(phis.shape[0]):
        ph = phis[i]
        ax.contour(X, Y, ph, levels=[0.0], colors="black", linewidths=1.5,
                   zorder=3)
        ax.contour(X, Y, np.where(ph <= 0, X1s[i], np.nan), levels=15,
                   colors="black", linewidths=0.5, zorder=4)
        ax.contour(X, Y, np.where(ph <= 0, X2s[i], np.nan), levels=15,
                   colors="black", linewidths=0.5, linestyles="dashed",
                   zorder=4)
    t = attrs.get("time")
    if t is not None:
        ax.set_title(f"t = {float(t):.3f}", fontsize=10)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout(pad=0.2)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def make_movie(frames_dir, out_path="lid_driven.gif", stride=1, fps=25):
    frames = list_frames(frames_dir)[::stride]
    if not frames:
        sys.exit(f"no data_??????.h5/.npz frames in {frames_dir}")
    images = [render_frame(*load_frame(path)) for _, path in frames]

    try:
        import imageio

        if out_path.endswith(".mp4"):
            with imageio.get_writer(out_path, fps=fps, codec="libx264",
                                    quality=8, macro_block_size=None) as w:
                for img in images:
                    w.append_data(img)
        else:
            imageio.mimsave(out_path, images, fps=fps)
    except ImportError:
        out_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(out_dir, exist_ok=True)
        import matplotlib.image as mpimg

        for i, img in enumerate(images):
            mpimg.imsave(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        out_path = out_dir
    print(f"[lid_driven_gif] saved {out_path} ({len(images)} frames)")
    return out_path


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        sys.exit(__doc__)
    make_movie(args[0], args[1] if len(args) > 1 else "lid_driven.gif",
               int(args[2]) if len(args) > 2 else 1,
               int(args[3]) if len(args) > 3 else 25)
