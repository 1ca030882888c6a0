"""Solid-solid repulsive contact force (counterpart of
``pyrmt_tpu.ops.contact``).

The mid-surface level set phi12 = (phi1 - phi2)/2 carries a cosine bump of
half-width w_c; inside either solid the force pushes each solid away from
the mid-surface along grad(phi12).
"""
from __future__ import annotations

import math

import torch

from pyrmt_tpu_torch.ops.fd import grad_central_x_2nd, grad_central_y_2nd


def compute_contact_force(phi1, phi2, k_rep, w_c, dx, dy):
    """Return (fx, fy) body-force densities (zero where not in contact)."""
    phi12 = 0.5 * (phi1 - phi2)
    aphi = torch.abs(phi12)
    delta = torch.where(
        aphi < w_c, (1.0 + torch.cos(math.pi * phi12 / w_c)) / (2.0 * w_c),
        0.0)

    g12x = grad_central_x_2nd(phi12, dx)
    g12y = grad_central_y_2nd(phi12, dy)
    # the double-where norm: sqrt only of a positive operand, 0 elsewhere,
    # so a gradient through a flat mid-surface stays finite
    sq = g12x**2 + g12y**2
    pos = sq > 0.0
    gmag = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0) + 1e-12
    n12x = g12x / gmag
    n12y = g12y / gmag

    active = ((phi1 < 0.0) | (phi2 < 0.0)).to(phi1.dtype)
    s = torch.sign(phi12)
    fx = k_rep * delta * s * n12x * active
    fy = k_rep * delta * s * n12y * active
    return fx, fy
