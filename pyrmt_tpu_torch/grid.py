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

    def coords(self, dtype=torch.float32, device="cuda"):
        """Return (X, Y) meshes of shape (Ny, Nx), bit for bit the JAX
        package's."""
        x = _linspace(self.Lx, self.Nx, dtype, device)
        y = _linspace(self.Ly, self.Ny, dtype, device)
        Y, X = torch.meshgrid(y, x, indexing="ij")
        return X, Y


def _linspace(stop, num, dtype, device):
    """``jnp.linspace(0.0, stop, num)`` as JAX rounds it on the CPU:
    i * (stop * (1 / div)) in ``dtype``, the endpoint exactly ``stop``
    (``torch.linspace`` rounds otherwise, an ulp off in up to a quarter of
    the points). Computed on the host, then moved."""
    div = num - 1
    one, stop_t, div_t = (torch.tensor(a, dtype=dtype)
                          for a in (1.0, stop, float(div)))
    x = torch.cat([torch.arange(div, dtype=dtype) * (stop_t * (one / div_t)),
                   stop_t.reshape(1)])
    return x.to(device)


def create_grid(Nx, Ny, Lx, Ly, dtype=torch.float32, device="cuda"):
    """The JAX package's helper: (X, Y, dx, dy), the coordinates of
    ``Grid.coords`` on ``device`` (the card unless told otherwise) and the
    spacings as Python floats."""
    g = Grid(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly)
    X, Y = g.coords(dtype=dtype, device=device)
    return X, Y, g.dx, g.dy
