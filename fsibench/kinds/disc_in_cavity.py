"""The kind ``disc_in_cavity``: one soft disc in the lid-driven cavity,
equal densities, the fused tier. It makes a cell's inputs from the seed,
builds the port's step and initial state, and holds the program to the
plain reference (``fsibench/reference.py``).

A configuration of this kind (``fsibench/configs/<name>.json``) gives
``physics`` (``pyrmt_tpu_torch.RMTConfig``'s fields), ``lid_speed``,
``disc`` (x0, y0, R), ``dtype``, ``chunk_steps``, ``warmup_steps``,
``follow_steps``, ``seeded`` and ``control``.

What is compared (the numbers; a cell compares those its limits name):

- the run's first step, from the initial state that both sides build from
  the seed (this checks the start: the program's initial maps), and the
  last of the ``follow_steps`` steps that the program runs once the
  window has closed, from the program's own state before it: velocity,
  p, phi, J and stress (``step_numbers``), each the wider reading of the
  two steps;
- maps: the solid block's advection over those ``follow_steps`` steps.
  The reference's maps start from the program's at the window's close
  and follow it step by step, each step advected by the velocity that the
  program's step took, so that the two sides part by the solid block
  alone. The number is the gap of the maps' displacements over the steps,
  relative to the reference's displacement: a solid block that leaves the
  maps unchanged reads 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fsibench import compare, reference

STRESS = ("sxx", "sxy", "syy")
# the numbers this kind compares
NUMBERS = ("velocity", "p", "phi", "J", "stress", "maps")

def _mode(k, x, lib):
    """sin(pi x) sin(k pi x) and its derivative: zero, with its slope, on
    both walls."""
    s1, c1 = lib.sin(math.pi * x), lib.cos(math.pi * x)
    sk, ck = lib.sin(k * math.pi * x), lib.cos(k * math.pi * x)
    return s1 * sk, math.pi * (c1 * sk + k * s1 * ck)


def velocity(modes, X, Y, lib):
    """The divergence-free field of the streamfunction sum a b_kx(x)
    b_ky(y), b_k(x) = sin(pi x) sin(k pi x): u = d psi/dy, v = -d psi/dx,
    zero on the walls (no slip, no flow through them)."""
    u = 0.0 * X
    v = 0.0 * X
    for kx, ky, a in modes:
        bx, dbx = _mode(kx, X, lib)
        by, dby = _mode(ky, Y, lib)
        u = u + a * bx * dby
        v = v - a * dbx * by
    return u, v


def seeded(config, N, seed):
    """(the disc (x0, y0, R), the velocity's modes [(kx, ky, a)]): the disc
    moved by under ``centre_shift_cells`` cells along x and y, the modes
    scaled so that the largest speed is ``speed``. The seed changes no
    size: every seed's run does the same work (the dt is the viscous
    limit's at any such speed)."""
    s, d = config["seeded"], config["disc"]
    rng = np.random.default_rng(seed)
    dx = 1.0 / (N - 1)
    shift = rng.uniform(-1.0, 1.0, 2) * s["centre_shift_cells"] * dx
    raw = [(int(rng.integers(1, s["max_wavenumber"] + 1)),
            int(rng.integers(1, s["max_wavenumber"] + 1)),
            float(rng.standard_normal())) for _ in range(s["modes"])]
    g = np.linspace(0.0, 1.0, 257)
    X, Y = np.meshgrid(g, g)
    u, v = velocity(raw, X, Y, np)
    top = max(float(np.sqrt(u * u + v * v).max()), 1e-300)
    k = s["speed"] / top
    modes = [(kx, ky, a * k) for kx, ky, a in raw]
    return (d["x0"] + float(shift[0]), d["y0"] + float(shift[1]),
            d["R"]), modes


def step_numbers(out, ref, w_t):
    """One step's numbers: ``out`` the program's (or the control's) fields
    and ``ref`` the reference's, float64 (N, N) on one device.

    velocity: the widest gap of u or v as a share of the reference's
    largest speed. p: the widest gap as a share of the reference field's
    largest magnitude (a cell whose phi rounds across 0 on one side moves
    the pressure over the whole box through the projection). phi: the
    widest gap in the domain's units (L = 1) over the cells the step's
    blends read, the reference's phi < w_t. J and stress: over the cells
    that both sides count as solid (phi <= 0), J's gap itself (J ~ 1) and
    the widest gap of sxx, sxy, syy as a share of their largest magnitude
    there, leaving out the cells whose stencil reaches a cell that one side
    counts as solid and the other not, where the stress's one-sided
    differences switch."""
    flips = (ref["phi"] <= 0.0) != (out["phi"] <= 0.0)
    solid = (ref["phi"] <= 0.0) & ~compare.near(flips, 1)
    speed = float(torch.sqrt(torch.amax(ref["u"] ** 2 + ref["v"] ** 2)))
    s_size = max(compare.size(ref[k], solid) for k in STRESS)
    return {"velocity": max(compare.gap(out[k], ref[k]) for k in ("u", "v"))
            / max(speed, compare.TINY),
            "p": compare.gap(out["p"], ref["p"]) / compare.size(ref["p"]),
            "phi": compare.gap(out["phi"], ref["phi"], ref["phi"] < w_t),
            "J": compare.gap(out["J"], ref["J"], solid),
            "stress": max(compare.gap(out[k], ref[k], solid)
                          for k in STRESS) / s_size}


def map_number(start, end, ref_end, phi, ref_phi):
    """maps: ||D - D_ref|| / ||D_ref|| of the displacements D = end -
    start of both maps over the cells that both sides count as solid
    (phi <= 0), leaving out those next to a cell that one side counts as
    solid and the other not."""
    flips = (ref_phi <= 0.0) != (phi <= 0.0)
    solid = (ref_phi <= 0.0) & ~compare.near(flips, 1)
    d = torch.stack([e - s for e, s in zip(end, start)])
    d_ref = torch.stack([e - s for e, s in zip(ref_end, start)])
    return compare.rel_l2(d, d_ref, solid.expand_as(d))


class Case:
    """One run's configuration of this kind at grid size ``N`` in
    ``dtype``, its inputs made from ``seed``."""

    def __init__(self, config, N, seed, dtype, device):
        self.config, self.N, self.dtype, self.device = config, N, dtype, \
            device
        self.disc, self.modes = seeded(config, N, seed)
        self.physics = config["physics"]
        if self.physics.get("variable_rho") or self.physics.get("g_x") or \
                self.physics.get("g_y"):
            raise ValueError("disc_in_cavity: equal densities, no gravity")
        self.w_t = self.physics["w_t_cells"] / (N - 1)
        # the rows of fsibench/work.py that the roofline metrics read
        self.work = {"rmt_block": "rmt_block",
                     "momentum_rk4": "momentum_rk4"}

    def initial_velocity(self, dtype):
        X, Y = reference.coords(self.N, torch.float64, self.device)
        u, v = velocity(self.modes, X, Y, torch)
        return u.to(dtype), v.to(dtype)

    def program(self):
        """The port's step and its initial state."""
        import pyrmt_tpu_torch as pt

        N, dtype, device = self.N, self.dtype, self.device
        cfg = pt.RMTConfig(grid=pt.Grid(N, N, 1.0, 1.0), **self.physics)
        shape = pt.Disc(*self.disc)
        step = pt.make_step(cfg, pt.make_lid_bc(self.config["lid_speed"]),
                            (shape,), dtype=dtype, device=device)
        u0, v0 = self.initial_velocity(dtype)
        state = pt.make_init_state(cfg, (shape,), u0=u0, v0=v0, dtype=dtype,
                                   device=device)
        return step, state

    @staticmethod
    def fields(state, aux):
        """One step's compared fields, float64."""
        out = {k: getattr(state, k).double() for k in ("u", "v", "p")}
        out["phi"] = aux["phis"][0].double()
        for k in ("J",) + STRESS:
            out[k] = aux[k][0].double()
        return out

    def first(self, state, aux):
        """The first step's fields, kept on the host through the window."""
        return {k: v.cpu() for k, v in self.fields(state, aux).items()}

    def follow(self, step, state, t_end):
        """``follow_steps`` steps of the program from the window's last
        state; what the comparison needs of them: the maps at the start
        and the end, each step's velocity, and the last step's input and
        output."""
        start = (state.X1[0], state.X2[0])
        vel = []
        for _ in range(self.config["follow_steps"]):
            vel.append((state.u, state.v))
            prev = state
            state, aux = step(state, t_end)
        inp = {k: getattr(prev, k) for k in ("u", "v", "p")}
        inp.update(X1=prev.X1[0], X2=prev.X2[0])
        return dict(start=start, vel=vel, inp=inp,
                    out=self.fields(state, aux),
                    end=(state.X1[0], state.X2[0]))

    def _reference(self, dtype):
        return reference.Reference(self.physics, self.config["lid_speed"],
                                   self.disc, self.N, dtype, self.device)

    def _maps(self, ref, rec, dtype):
        """The reference's maps followed over the program's steps."""
        X1, X2 = (f.to(dtype) for f in rec["start"])
        for u, v in rec["vel"]:
            X1, X2, _, _ = ref.maps(u.to(dtype), v.to(dtype), X1, X2)
        return X1, X2

    def numbers(self, first, rec):
        """The program's numbers against the float64 reference (and the
        reference's readings, which the control is held to)."""
        f64 = torch.float64
        ref = self._reference(f64)
        u0, v0 = (f.to(f64) for f in self.initial_velocity(self.dtype))
        X1, X2 = ref.init_maps()
        r_first = compare.as_float64(ref.step(u0, v0, torch.zeros_like(u0),
                                              X1, X2))
        del X1, X2
        first = {k: v.to(self.device) for k, v in first.items()}
        n_first = step_numbers(first, r_first, self.w_t)
        r_last = compare.as_float64(ref.step(
            **{k: v.to(f64) for k, v in rec["inp"].items()}))
        n_last = step_numbers(rec["out"], r_last, self.w_t)
        nums = compare.worst(n_first, n_last)
        start = tuple(f.to(f64) for f in rec["start"])
        end = tuple(f.to(f64) for f in rec["end"])
        r_end = self._maps(ref, rec, f64)
        nums["maps"] = map_number(start, end, r_end, ref.phi(*end),
                                  ref.phi(*r_end))
        self._ref = dict(first=r_first, last=r_last, start=start,
                         end=r_end)
        return nums

    def control_numbers(self, rec):
        """The control in the program's place, held to the readings of the
        last ``numbers`` call: the reference in the configuration's
        ``control`` precision (its ``dtype``)."""
        r = self._ref
        dtype = getattr(torch, self.config["control"]["dtype"])
        ctl = self._reference(dtype)
        u0, v0 = self.initial_velocity(self.dtype)
        X1, X2 = ctl.init_maps()
        c_first = ctl.step(u0.to(dtype), v0.to(dtype), torch.zeros_like(X1),
                           X1, X2)
        c_last = ctl.step(**{k: v.to(dtype) for k, v in rec["inp"].items()})
        c_end = self._maps(ctl, rec, dtype)
        nums = compare.worst(
            step_numbers(compare.as_float64(c_first), r["first"], self.w_t),
            step_numbers(compare.as_float64(c_last), r["last"], self.w_t))
        c_end = tuple(f.double() for f in c_end)
        nums["maps"] = map_number(
            r["start"], c_end, r["end"],
            reference.disc_phi(*c_end, *self.disc),
            reference.disc_phi(*r["end"], *self.disc))
        return nums
