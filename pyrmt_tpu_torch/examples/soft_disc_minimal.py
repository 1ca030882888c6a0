"""Minimal end-to-end example (the twin of ``examples/soft_disc_minimal.py``):
a soft disc in a lid-driven cavity. Configure, build the step, run chunks
of steps, checkpoint, resume.

    python -m pyrmt_tpu_torch.examples.soft_disc_minimal [--cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch

from pyrmt_tpu_torch import (
    Disc,
    Grid,
    RMTConfig,
    load_checkpoint,
    make_init_state,
    make_lid_bc,
    make_run_chunk,
    make_step,
    save_checkpoint,
)


def main(N=64, chunks=5, chunk_steps=100, t_end=2.0, dtype=torch.float32,
         device="cuda", verbose=True):
    """Run ``chunks`` chunks of ``chunk_steps`` steps, checkpoint the state
    (in a temporary directory), load it back and run one more chunk from
    it and from the state in memory. Returns {'t': each chunk's t,
    'umax': each chunk's max |u|, 'resumed_t': t after the resumed chunk,
    'resume_exact': the resumed chunk equals the uninterrupted one}."""
    cfg = RMTConfig(grid=Grid(N, N, 1.0, 1.0), mu_s=0.1, eta_s=0.01,
                    mu_f=0.01, rho_f=1.0, rho_s=1.0)
    disc = Disc(0.6, 0.5, 0.2)  # the solid is where phi <= 0
    kw = dict(dtype=dtype, device=device)
    step = make_step(cfg, make_lid_bc(1.0), (disc,), **kw)
    state = make_init_state(cfg, (disc,), **kw)
    run = make_run_chunk(step, chunk_steps)
    out = {"t": [], "umax": []}
    for _ in range(chunks):
        state, _ = run(state, t_end)
        out["t"].append(float(state.t))
        out["umax"].append(float(torch.amax(torch.hypot(state.u, state.v))))
        if verbose:
            print(f"t={out['t'][-1]:.3f}  step={int(state.step)}  "
                  f"max|u|={out['umax'][-1]:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "soft_disc_ckpt.npz")
        save_checkpoint(path, state)           # the whole SimState
        resumed = load_checkpoint(path, device=device)
    resumed, _ = run(resumed, t_end)
    state, _ = run(state, t_end)
    out["resumed_t"] = float(resumed.t)
    out["resume_exact"] = all(
        torch.equal(getattr(resumed, k), getattr(state, k))
        for k in ("u", "v", "p", "X1", "X2", "t"))
    if verbose:
        print(f"resumed -> t={out['resumed_t']:.3f} (exact: "
              f"{out['resume_exact']})")
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
