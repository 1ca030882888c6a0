"""The readings that the limits of ``correct`` are set from: the program's
numbers over many seeds and the control's, at a cell's own size, in one
process (the kernels build once).

    python3 fsibench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--chunks 1] [--N 512] [--dtype float64]

Each seed is one run of the cell (``harness.run_cell``) with a window of
``--chunks`` chunks; a seed of ``--control-seeds`` also puts the control
in the program's place on the same steps. ``--N`` and ``--dtype``
replace the cell's grid size and type (a witness at another size or in
another precision). Prints one JSON line per seed: its numbers
(``checks``) and, where asked, the control's (``control_checks``), each
beside the cell's limit. The benchmark's own runs never run the
control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from fsibench import run

    run.use_root(sys.path)
    for k, v in run.CACHES.items():
        os.environ[k] = str(v)
    import torch

    from fsibench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, 0.0, False,
                             torch.device("cuda", 0), t0,
                             N=args.N, max_chunks=args.chunks,
                             dtype=args.dtype and getattr(torch, args.dtype),
                             control=seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "N": args.N, "dtype": args.dtype,
                          "correct": r["correct"],
                          "seconds": time.perf_counter() - t0,
                          "checks": r["checks"],
                          "control_checks": r.get("control_checks"),
                          "numbers": r.get("numbers")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
