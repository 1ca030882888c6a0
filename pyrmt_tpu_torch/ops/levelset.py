"""Level-set shapes and the rebuild from the reference map (counterpart of
``pyrmt_tpu.ops.levelset.rebuild_phi_from_reference_map``).

In the JAX package an initial level set is any traced closure, which the
Pallas kernel bakes in. A CUDA kernel takes the shape as runtime scalars
instead, so a shape the kernel can evaluate carries a ``kernel_spec`` tuple,
the way a velocity BC does. Reinitialisation, curvature and the area fix
wait for ROADMAP modules items 9 and 11.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Disc:
    """Signed distance to a circle: phi = |x - (x0, y0)| - R."""

    x0: float
    y0: float
    R: float

    @property
    def kernel_spec(self):
        return ("disc", float(self.x0), float(self.y0), float(self.R))

    def __call__(self, X1, X2):
        ex = X1 - self.x0
        ey = X2 - self.y0
        return torch.sqrt(ex * ex + ey * ey) - self.R


def rebuild_phi_from_reference_map(X1, X2, phi_init_func):
    """phi = phi_init(X1, X2): the compatibility reconstruction."""
    return phi_init_func(X1, X2)
