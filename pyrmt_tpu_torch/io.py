"""Checkpoints, snapshots and energy output (counterpart of
``pyrmt_tpu.io``).

A state crosses over as a mapping of numpy arrays with the ``SimState``
field names (``state_{to,from}_numpy``), so a JAX state can seed a PyTorch
run and the two can be compared. ``save_checkpoint`` / ``load_checkpoint``
write and read the JAX package's ``.npz`` format (its ``_STATE_FIELDS``
and ``phis0`` where the state has it), so a checkpoint written by either
package loads in the other. Snapshots are HDF5 where h5py imports (a
``.h5`` path), else ``.npz``, as in the JAX package.
"""
from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np
import torch

from pyrmt_tpu_torch.diagnostics import (
    compute_kinetic_energy,
    compute_strain_energy,
    compute_viscous_dissipation,
    divergence_2d_interior,
)
from pyrmt_tpu_torch.sim import SimState

try:  # optional dependency
    import h5py

    _HAVE_H5 = True
except Exception:  # pragma: no cover
    _HAVE_H5 = False

STATE_FIELDS = ("u", "v", "p", "X1", "X2", "t", "step", "phis0")


def state_from_numpy(d, device="cuda", dtype=torch.float32) -> SimState:
    """SimState from a mapping of numpy arrays. Float fields take ``dtype``
    and ``step`` int32; a missing ``phis0`` becomes the empty stack."""
    kw = {}
    for k in STATE_FIELDS:
        if k == "phis0" and d.get(k) is None:
            continue
        kw[k] = torch.tensor(np.asarray(d[k]), device=device,
                             dtype=torch.int32 if k == "step" else dtype)
    if "phis0" not in kw:
        kw["phis0"] = torch.zeros((0,) + kw["u"].shape, dtype=dtype,
                                  device=device)
    return SimState(**kw)


def state_to_numpy(state: SimState) -> dict:
    """Mapping of numpy arrays with the SimState field names."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS
            if getattr(state, k) is not None}


# Checkpoint and resume

def save_checkpoint(path, state):
    """Write a SimState to ``path`` (.npz): a temporary file, then a
    rename."""
    tmp = path + ".tmp"
    np.savez(tmp, **state_to_numpy(state))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path, dtype=None, device="cuda") -> SimState:
    """Read a SimState from ``path`` onto ``device``. Float fields keep
    their stored type unless ``dtype`` is given; a checkpoint without
    ``phis0`` gets the empty stack."""
    with np.load(path) as data:
        kw = {}
        for k in STATE_FIELDS:
            if k not in data:
                continue
            t = torch.from_numpy(np.array(data[k]))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            kw[k] = t.to(device)
    if "phis0" not in kw:
        kw["phis0"] = torch.zeros((0,) + tuple(kw["u"].shape),
                                  dtype=kw["u"].dtype, device=device)
    return SimState(**kw)


# Field snapshots

def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def save_snapshot(path, fields, attrs=None):
    """Write named fields (tensors or arrays) and scalar attributes to HDF5
    where h5py imports and the path ends in .h5, else to .npz (the
    attributes as 0-d arrays named 'attr_<name>'). Returns the path
    written."""
    fields = {k: _numpy(v) for k, v in fields.items()}
    attrs = attrs or {}
    if _HAVE_H5 and path.endswith(".h5"):
        with h5py.File(path, "w") as f:
            for k, v in fields.items():
                f.create_dataset(k, data=v)
            for k, v in attrs.items():
                f.attrs[k] = v
        return path
    if path.endswith(".h5"):
        path = path[:-3] + ".npz"
    payload = dict(fields)
    payload.update({f"attr_{k}": np.asarray(v) for k, v in attrs.items()})
    np.savez(path, **payload)
    return path


def load_snapshot(path):
    """Read a snapshot of ``save_snapshot``: (fields, attrs), numpy."""
    if _HAVE_H5 and path.endswith(".h5"):
        fields, attrs = {}, {}
        with h5py.File(path, "r") as f:
            for k in f.keys():
                fields[k] = np.asarray(f[k])
            for k in f.attrs:
                attrs[k] = f.attrs[k]
        return fields, attrs
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files if not k.startswith("attr_")}
        attrs = {k[5:]: data[k].item() for k in data.files
                 if k.startswith("attr_")}
    return fields, attrs


# Console, CSV and snapshot output every few steps

ENERGY_FIELDS = ("step", "time", "dt", "kinetic_energy", "strain_energy",
                 "dissipation_rate", "integrated_dissipation",
                 "total_energy")


def output_simulation_data(
    dx, dy, phi, solid_mask, X1, X2, a, b, p, vis_output_freq,
    directory_name, step, dt, sigma_sxx, sigma_sxy, sigma_syy, J, mu_s=0.0,
    mu_f=0.0, rho_s=1.0, rho_f=1.0, w_t=None, eta_s=0.0, kappa=0.0,
    time=0.0, integrated_dissipation=0.0, out_root="outputs",
):
    """Every ``vis_output_freq`` steps (and at step 1): a console line, a
    row of ``energy_history.csv`` and a field snapshot
    ``data_<step>.h5`` under ``out_root/directory_name``. Returns
    ``integrated_dissipation`` as given."""
    if w_t is None:
        w_t = 2.0 * dx
    if not (step % vis_output_freq == 0 or step == 1):
        return integrated_dissipation
    vmag = torch.hypot(a, b)
    div_field, div_interior = divergence_2d_interior(a, b, dx, dy, pad=4)
    ke = float(compute_kinetic_energy(a, b, rho_f, rho_s, phi, w_t, dx, dy))
    se = float(compute_strain_energy(X1, X2, phi, mu_s, dx, dy, kappa=kappa))
    eps = float(compute_viscous_dissipation(a, b, mu_f, phi, w_t, dx, dy,
                                            eta_s))
    total_energy = ke + se + integrated_dissipation
    sig_mag = torch.sqrt(sigma_sxx**2 + sigma_syy**2 + 2 * sigma_sxy**2)
    print(f"[Step {step:05d}] t={time:.3f}, dt={float(dt):.2e}, "
          f"max|v|={float(vmag.max()):.3f}, KE={ke:.4e}, SE={se:.4e}, "
          f"eps={eps:.4e}, E_tot={total_energy:.4e}, "
          f"min(J)={float(J.min()):.3f}, "
          f"max|sigma|={float(sig_mag.max()):.2f}, "
          f"max|div|={float(div_interior.abs().max()):.2e}")

    output_dir = os.path.join(out_root, directory_name)
    os.makedirs(output_dir, exist_ok=True)
    energy_file = os.path.join(output_dir, "energy_history.csv")
    file_exists = os.path.isfile(energy_file)
    with open(energy_file, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=ENERGY_FIELDS)
        if not file_exists or step == 1:
            writer.writeheader()
        writer.writerow({
            "step": step, "time": time, "dt": float(dt),
            "kinetic_energy": ke, "strain_energy": se,
            "dissipation_rate": eps,
            "integrated_dissipation": integrated_dissipation,
            "total_energy": total_energy,
        })

    save_snapshot(
        os.path.join(output_dir, f"data_{step:06d}.h5"),
        {"phi": phi, "X1": X1, "X2": X2, "J": J, "a": a, "b": b, "p": p,
         "sigma_xx": sigma_sxx, "sigma_yy": sigma_syy,
         "sigma_xy": sigma_sxy, "div_vel": div_field},
        attrs={"time": time, "kinetic_energy": ke, "strain_energy": se,
               "dissipation_rate": eps,
               "integrated_dissipation": integrated_dissipation,
               "total_energy": total_energy},
    )
    return integrated_dissipation


@dataclasses.dataclass
class EnergyLogger:
    """Rows of energy and trajectory values, collected on the host between
    chunks of steps."""

    rows: list = dataclasses.field(default_factory=list)

    def log(self, **kw):
        self.rows.append(kw)

    def to_csv(self, path, fieldnames=None):
        if not self.rows:
            return
        fieldnames = fieldnames or list(self.rows[0].keys())
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            for r in self.rows:
                w.writerow(r)

    def array(self, *keys):
        return np.array([[r[k] for k in keys] for r in self.rows])

    @classmethod
    def from_csv(cls, path):
        """Reload a history written by ``to_csv``: a float's repr reads
        back exactly, so a resumed run sees the same rows."""
        with open(path, newline="") as f:
            rows = [{k: float(v) for k, v in r.items()}
                    for r in csv.DictReader(f)]
        return cls(rows=rows)
