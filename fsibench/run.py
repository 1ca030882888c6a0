"""The benchmark's command: one run of one cell, its result as the last
line of standard output.

    python3 fsibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from torch.profiler over one
chunk of the window. Every run compares the window's last step with the
plain reference (``fsibench/compare.py``) and prints each number compared
beside its limit, as the last lines of standard error and under the
result's last key, ``checks``. It needs a CUDA card: without one it exits
2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the modules that must not be loaded in the process that prints a
# result: JAX and the JAX package (compared by whole top-level names)
JAX_MODULES = {"jax", "jaxlib", "flax", "pyrmt_tpu", "benchmarks"}
# every build and kernel cache at a fixed path inside the checkout
BUILD = ROOT / "pyrmt_tpu_torch" / "_build"
CACHES = {"PYRMT_TORCH_BUILD_DIR": BUILD,
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "TRITON_CACHE_DIR": BUILD / "triton",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache"}


def use_root(path):
    """Put the checkout's root first on ``path`` and take this script's
    own directory off it: its ``trace.py`` would shadow the standard
    library's module of that name."""
    here = ROOT / "fsibench"
    path[:] = [p for p in path if Path(p or ".").resolve() != here]
    path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def jax_loaded():
    return sorted(JAX_MODULES & {m.split(".")[0] for m in sys.modules})


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None):
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    use_root(sys.path)
    import torch

    from fsibench import harness

    work = harness.cell(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"fsibench: the cell needs {work['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    found = jax_loaded()
    if found:
        print(f"fsibench: the process loaded {found}: no result",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    for k, (value, limit) in checks.items():
        print(f"{k} {value:.6g} limit {limit:.6g}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
