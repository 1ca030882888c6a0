"""Velocity boundary conditions, pure functions (u, v) -> (u, v).

Counterpart of ``pyrmt_tpu.bcs``. Each BC carries the same static
``kernel_spec`` tuple as its JAX twin; the momentum kernel
(kernels/momentum_rk4.py) applies the BC from that spec. The periodic BC
waits for the periodic stack (ROADMAP modules item 13).
"""
from __future__ import annotations

import functools


def no_slip_lid_bc(u, v, lid_speed=1.0):
    """Lid-driven cavity: no-slip on left/right/bottom, moving lid on top,
    corners pinned to zero. Only slices are assigned: assigning a Python
    number to a single element of a CUDA tensor waits for the card."""
    u, v = u.clone(), v.clone()
    for f in (u, v):
        f[:, 0] = 0.0
        f[:, -1] = 0.0
        f[0, :] = 0.0
        f[-1, :] = 0.0
    u[-1, 1:-1] = lid_speed
    return u, v


def make_lid_bc(lid_speed=1.0):
    bc = functools.partial(no_slip_lid_bc, lid_speed=lid_speed)
    bc.kernel_spec = ("lid", float(lid_speed))
    return bc


def free_slip_box_bc(u, v):
    """Free-slip impermeable walls: zero normal velocity, zero-gradient
    tangential. The copies run in this order, which fixes the corners."""
    u, v = u.clone(), v.clone()
    u[:, 0] = 0.0
    u[:, -1] = 0.0
    v[:, 0] = v[:, 1]
    v[:, -1] = v[:, -2]
    v[0, :] = 0.0
    v[-1, :] = 0.0
    u[0, :] = u[1, :]
    u[-1, :] = u[-2, :]
    return u, v


free_slip_box_bc.kernel_spec = ("free_slip",)


def noop_bc(u, v):
    return u, v


noop_bc.kernel_spec = ("noop",)
