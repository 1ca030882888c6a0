"""Build the CUDA sources in ``pyrmt_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled by nvcc for Hopper (sm_90a) at first use and loaded with ctypes.
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and a finished build is reused. Builds go to
``pyrmt_tpu_torch/_build`` (listed in .gitignore), or to the directory that
``PYRMT_TORCH_BUILD_DIR`` names.

nvcc runs with ``--fmad=false``: the kernels then round every product and
sum as the plain PyTorch versions do, where contracted multiply-adds would
round differently and cost the kernel-vs-plain comparison its exactness.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    default = CSRC.parent / "_build"
    return Path(os.environ.get("PYRMT_TORCH_BUILD_DIR", default))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
            "kernels of pyrmt_tpu_torch are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first
    if no build of the current sources exists. Raises RuntimeError with
    nvcc's output if the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build cannot tear it
    lib = ctypes.CDLL(str(so))
    lib.pyrmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pyrmt_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.pyrmt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def pointer(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
