"""Uniform collocated grid (counterpart of ``pyrmt_tpu.grid``).

A node-centred uniform grid on [0, Lx] x [0, Ly]; fields are (Ny, Nx)
row-major with axis 0 = y and axis 1 = x, exactly as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid metadata."""

    Nx: int
    Ny: int
    Lx: float
    Ly: float

    @property
    def dx(self) -> float:
        return self.Lx / (self.Nx - 1)

    @property
    def dy(self) -> float:
        return self.Ly / (self.Ny - 1)

    @property
    def shape(self):
        return (self.Ny, self.Nx)

    def coords(self, dtype=torch.float32, device="cpu"):
        """Return (X, Y) meshes of shape (Ny, Nx)."""
        x = torch.linspace(0.0, self.Lx, self.Nx, dtype=dtype, device=device)
        y = torch.linspace(0.0, self.Ly, self.Ny, dtype=dtype, device=device)
        Y, X = torch.meshgrid(y, x, indexing="ij")
        return X, Y
