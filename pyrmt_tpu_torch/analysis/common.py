"""The readers of a run's files, the port's own copy of
``benchmarks/analysis/common.py``: the ``data_??????.h5`` frame
directories that ``io.output_simulation_data`` writes (pyRMT's layout,
``.npz`` without h5py), the validation cases' CSV tables and
``energy_history.csv``, and the centroid and area of a level set's solid
(phi <= 0). numpy alone: no plotting package, no jax."""
from __future__ import annotations

import csv
import os
import re

import numpy as np

from pyrmt_tpu_torch.io import load_snapshot

_FRAME_RE = re.compile(r"^data_(\d+)\.(h5|npz)$")


def list_frames(frames_dir):
    """Sorted (step, path) pairs of the ``data_??????.h5``/``.npz`` files
    in a directory."""
    out = []
    for f in os.listdir(frames_dir):
        m = _FRAME_RE.match(f)
        if m:
            out.append((int(m.group(1)), os.path.join(frames_dir, f)))
    return sorted(out)


def load_frame(path):
    """(fields, attrs) of one snapshot (``io.load_snapshot``)."""
    return load_snapshot(path)


def frame_grid(phi):
    """The unit square's node coordinates for a (Ny, Nx) field: X, Y, dx,
    dy."""
    Ny, Nx = phi.shape
    x = np.linspace(0.0, 1.0, Nx)
    y = np.linspace(0.0, 1.0, Ny)
    X, Y = np.meshgrid(x, y)
    return X, Y, x[1] - x[0], y[1] - y[0]


def get_centroid(phi, X, Y):
    """The centroid of the solid cells (phi <= 0), or None without one."""
    mask = phi <= 0
    if not mask.any():
        return None
    return float(X[mask].mean()), float(Y[mask].mean())


def get_area(phi, dx, dy):
    """The cell-count area of phi <= 0."""
    return float(np.sum(phi <= 0) * dx * dy)


def load_csv(path):
    """A CSV table with a header line (a case's rows, as either writer of
    the drivers leaves them) as {column: float array}, in the header's
    order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    data = np.array(body, dtype=float).reshape(len(body), len(header))
    return {k: data[:, i] for i, k in enumerate(header)}


_ENERGY_ALIASES = {
    "t": "time", "ke": "kinetic_energy", "se": "strain_energy",
    "dissipation": "dissipation_rate",
}


def load_energy_csv(run_dir):
    """The columns of a run's ``energy_history.csv`` under pyRMT's names
    (time, kinetic_energy, strain_energy, dissipation_rate, ...); the
    validation cases' short names (t, ke, se, dissipation) are read as
    those. Cells that are not numbers are skipped."""
    path = os.path.join(run_dir, "energy_history.csv")
    cols = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                try:
                    cols.setdefault(_ENERGY_ALIASES.get(k, k), []).append(
                        float(v))
                except (TypeError, ValueError):
                    pass
    return {k: np.asarray(v) for k, v in cols.items()}


def ensure_outdir(path):
    os.makedirs(path, exist_ok=True)
    return path
