"""The generic part of the comparison that decides ``correct``: the gaps
and sizes that a kind's numbers are made of, and each number judged
against its limit. What a cell compares, and how its reference follows
the program, is its kind's (``fsibench/kinds/<kind>.py``); its limits are
the keys of ``fsibench/workloads/<cell>.json``."""
from __future__ import annotations

import math

import torch

TINY = torch.finfo(torch.float64).tiny


def gap(a, b, where=None):
    """The widest |a - b|, over ``where`` if given."""
    d = torch.abs(a - b)
    if where is not None:
        d = torch.where(where, d, torch.zeros_like(d))
    return float(torch.amax(d))


def size(a, where=None):
    """The largest |a|, over ``where`` if given (at least the tiniest
    float64, so that it divides)."""
    m = torch.abs(a)
    if where is not None:
        m = torch.where(where, m, torch.zeros_like(m))
    return max(float(torch.amax(m)), TINY)


def rel_l2(a, b, where):
    """||a - b|| / ||b|| over the cells of ``where``."""
    w = where.to(b.dtype)
    num = float(torch.sum(w * (a - b) ** 2))
    den = float(torch.sum(w * b * b))
    return math.sqrt(num) / max(math.sqrt(den), TINY)


def near(mask, reach):
    """The cells within ``reach`` cells (along x and y) of a cell of
    ``mask``."""
    out = mask
    for _ in range(reach):
        grown = out.clone()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def worst(*readings):
    """Each number's widest reading over several comparisons."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(nums, limits):
    """(correct, checks): each number that the cell's ``limits`` name,
    with its limit, {name: [number, limit]}, in the limits' order; a
    number that is not finite, or that the run did not give, fails."""
    ok, checks = True, {}
    for k, lim in limits.items():
        v = nums.get(k, math.nan)
        ok &= v == v and v <= lim
        checks[k] = [v, lim]
    return ok, checks


def as_float64(fields):
    return {k: v.double() for k, v in fields.items()}
