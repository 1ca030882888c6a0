"""What the validation drivers share: the port's own copies of the JAX
drivers' helpers (``benchmarks/common.py::{taylor_green_velocity,
load_xy_csv}``, ``soft_disc_in_lid_driven.py::mean_track_deviation``,
``sedimentation_pack.py::pack_positions``,
``convergence_taylor_green.py::{richardson_order, _sample_ref_on, l2}``;
``make_disc_phi_init`` and ``make_ellipse_phi_init`` are ``ops.levelset``'s
``Disc`` and ``Ellipse``), a run's timing and the checkpoint of a
resumable run; ``stop_time`` is ``sim``'s."""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from pyrmt_tpu_torch.io import EnergyLogger, load_checkpoint, save_checkpoint
from pyrmt_tpu_torch.sim import stop_time  # noqa: F401  (the drivers' loops)

# the published tracks and tables (data/*.csv at the checkout's root)
DATA_DIR = Path(__file__).resolve().parents[2] / "data"


def vortex_velocity(X, Y, U0=1.0):
    """``benchmarks/common.py::taylor_green_velocity`` on numpy coordinates:
    u = U0 k sin(kx) cos(ky), v = -U0 k cos(kx) sin(ky), k = 2 pi."""
    k = 2.0 * np.pi
    return (U0 * k * np.sin(k * X) * np.cos(k * Y),
            -U0 * k * np.cos(k * X) * np.sin(k * Y))


def vortex_state_velocity(cfg, U0, velocity_bc, dtype, device):
    """The drivers' seed: ``vortex_velocity`` on the grid's coordinates in
    ``dtype`` (numpy, as the JAX drivers evaluate it), then the BC."""
    X, Y = cfg.grid.coords(dtype=dtype, device="cpu")
    u0, v0 = vortex_velocity(X.numpy(), Y.numpy(), U0=U0)
    return velocity_bc(torch.as_tensor(u0, dtype=dtype, device=device),
                       torch.as_tensor(v0, dtype=dtype, device=device))


def load_xy_csv(path, has_header=False):
    data = np.loadtxt(path, delimiter=",", skiprows=1 if has_header else 0)
    return data[:, 0], data[:, 1]


def mean_track_deviation(cx, cy, rx, ry):
    """Mean over the centroid samples of the distance to the published
    track's polyline (time-free: the published tracks have no times and
    may cover another span, so the reverse direction would penalise
    unvisited segments rather than the trajectory's error)."""
    ours = np.column_stack([cx, cy])
    A = np.column_stack([rx, ry])[:-1]
    B = np.column_stack([rx, ry])[1:]
    AB = B - A
    denom = (AB * AB).sum(-1).clip(1e-30)
    t = ((ours[:, None, :] - A[None, :, :]) * AB[None, :, :]).sum(-1) \
        / denom[None, :]
    t = np.clip(t, 0.0, 1.0)
    proj = A[None, :, :] + t[:, :, None] * AB[None, :, :]
    d = np.sqrt(((ours[:, None, :] - proj) ** 2).sum(-1)).min(axis=1)
    return float(d.mean())


def pack_positions(S, R):
    """Staggered rows of S centres across the upper half of the unit box."""
    per_row = max(2, int(np.ceil(np.sqrt(S))))
    pos = []
    for k in range(S):
        r, c = divmod(k, per_row)
        x = (c + 1) / (per_row + 1) + (0.5 * R if r % 2 else -0.5 * R)
        y = 0.82 - r * (2.6 * R)
        pos.append((x, y))
    return pos


def sample_ref_on(coarse, ref, key):
    """The reference grid's field ``key`` sampled bilinearly at the coarse
    grid's nodes."""
    from scipy.interpolate import RegularGridInterpolator

    xr = np.linspace(0, 1, ref["N"])
    f = RegularGridInterpolator((xr, xr), ref[key], bounds_error=False,
                                fill_value=None)
    pts = np.column_stack([coarse["Y"].ravel(), coarse["X"].ravel()])
    return f(pts).reshape(coarse["X"].shape)


def l2(err, mask=None):
    if mask is not None:
        err = err[mask]
    return float(np.sqrt(np.mean(err**2)))


def richardson_order(values):
    """Reference-free observed orders from grids spaced by 2: [(N of the
    finest of each triplet, order)]."""
    out = []
    for i in range(len(values) - 2):
        (_, q0), (_, q1), (N2, q2) = values[i], values[i + 1], values[i + 2]
        d_coarse, d_fine = q1 - q0, q2 - q1
        if abs(d_fine) > 0:
            out.append((N2, float(np.log(abs(d_coarse) / abs(d_fine))
                                  / np.log(2.0))))
    return out


def advance(step, state, t_end, n, fold=None, acc=None):
    """``n`` steps of ``step`` toward ``t_end``, as a JAX driver's chunk
    runs them, folding ``acc = fold(acc, state, aux, active)`` after each
    (``active``: the step advanced, dt > 0, a 0-d tensor). Returns (state,
    aux, acc): the last step's aux, its level sets and J (``phis``,
    ``J``) those of the last step that advanced. Past t_end a step is a
    no-op whose fused-tier aux is its discarded trial step's, at dt = 1
    (JAX's fused path; its XLA path's, the unchanged maps'): a driver's
    stats read the solid as the run left it. Without a no-op step in a
    chunk, the JAX driver's own values."""
    kept = None
    for _ in range(n):
        state, aux = step(state, t_end)
        active = aux["dt"] > 0.0
        if fold is not None:
            acc = fold(acc, state, aux, active)
        if kept is not None:
            aux = dict(aux, **{k: torch.where(active, aux[k], kept[k])
                               for k in ("phis", "J")})
        kept = aux
    return state, kept, acc


def timing(steps, wall):
    """A run's steps, wall seconds and steps per second (host clock)."""
    return dict(steps=steps, wall_s=wall,
                steps_per_s=steps / wall if wall > 0 else 0.0)


class Checkpoint:
    """A resumable run's files in ``ckpt_dir`` (None: no files): the state
    (``io.save_checkpoint``, the JAX package's format), the logged rows
    (CSV, whose floats read back exactly) and, as ``extra``, numpy arrays
    the run needs again (an npz)."""

    def __init__(self, ckpt_dir, csv_name):
        self.dir = None if ckpt_dir is None else str(ckpt_dir)
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
        self.csv_name = csv_name

    def _path(self, name):
        return os.path.join(self.dir, name)

    def load(self, dtype, device):
        """(state, logger, extra arrays), or None where nothing is saved."""
        if self.dir is None or not os.path.exists(
                self._path("checkpoint.npz")):
            return None
        state = load_checkpoint(self._path("checkpoint.npz"), dtype=dtype,
                                device=device)
        csv = self._path(self.csv_name)
        log = (EnergyLogger.from_csv(csv) if os.path.exists(csv)
               else EnergyLogger())
        extra = {}
        if os.path.exists(self._path("resume_meta.npz")):
            with np.load(self._path("resume_meta.npz")) as m:
                extra = {k: m[k] for k in m.files}
        return state, log, extra

    def save(self, state, log, **extra):
        if self.dir is None:
            return
        save_checkpoint(self._path("checkpoint.npz"), state)
        log.to_csv(self._path(self.csv_name))
        if extra:
            np.savez(self._path("resume_meta.npz"), **extra)
