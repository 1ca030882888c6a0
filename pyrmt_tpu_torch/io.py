"""State exchange with numpy (counterpart of the checkpoint part of
``pyrmt_tpu.io``).

A state of either package crosses over as a mapping of numpy arrays with
the ``SimState`` field names, so a JAX state can seed a PyTorch run and the
two can be compared. Snapshots, CSV output and HDF5 wait for ROADMAP
modules item 8.
"""
from __future__ import annotations

import numpy as np
import torch

from pyrmt_tpu_torch.sim import SimState

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
