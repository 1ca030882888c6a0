"""Velocity boundary conditions, pure functions (u, v) -> (u, v).

Counterpart of ``pyrmt_tpu.bcs``. Each BC carries the same static
``kernel_spec`` tuple as its JAX twin; the momentum kernel
(kernels/momentum_rk4.py) applies the BC from that spec.
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


def periodic_bc(u, v):
    """Doubly-periodic overlap-grid wrap: the last column takes the first,
    then the last row takes the first row as it was before the column copy
    (the JAX package's order, which leaves the corner (-1, -1) at the old
    (0, -1))."""
    u0, v0 = u[0, :], v[0, :]
    u, v = u.clone(), v.clone()
    for f, row0 in ((u, u0), (v, v0)):
        f[:, -1] = f[:, 0]
        f[-1, :] = row0
    return u, v


# the momentum kernel's periodic instantiation: wrapped reads, the
# interior stencils, the BC the identity on overlap-consistent fields
periodic_bc.kernel_spec = ("periodic",)


def noop_bc(u, v):
    return u, v


noop_bc.kernel_spec = ("noop",)


def bc_of_spec(spec):
    """The velocity BC whose ``kernel_spec`` is ``spec``: the JAX kernels'
    static ``bc_spec``, ('lid', U), ('free_slip',), ('periodic',) or
    ('noop',)."""
    kind = spec[0]
    if kind == "lid":
        return make_lid_bc(spec[1])
    bcs = {"free_slip": free_slip_box_bc, "periodic": periodic_bc,
           "noop": noop_bc}
    if kind not in bcs:
        raise ValueError(f"no velocity BC has the kernel_spec {spec!r}")
    return bcs[kind]
