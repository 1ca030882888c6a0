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

# The velocity BCs that the kernels apply from a BC's kernel_spec: the Bc
# enum of csrc/stencil_device.cuh. The projection's grad_correct kernel
# takes the walls only (the JAX package's stencil kernels are Neumann-only);
# momentum_rk4 takes the periodic box too.
BC_CODES = {"noop": 0, "lid": 1, "free_slip": 2, "periodic": 3}
WALL_BCS = ("noop", "lid", "free_slip")


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


def _start_build(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless a build of the current
    sources exists; returns (process, temporary path) or None."""
    if name in _LIBS or library_path(name).exists():
        return None
    so = library_path(name)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp = started
    out, _ = proc.communicate()
    so = library_path(name)
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent build cannot tear it


def load_all(names) -> list[ctypes.CDLL]:
    """Load the libraries of ``csrc/<name>.cu`` for every name, running the
    nvcc builds that are missing side by side. Raises RuntimeError with
    nvcc's output if a build fails."""
    started = {name: _start_build(name) for name in names}
    try:
        for name, s in started.items():
            _finish_build(name, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    libs = []
    for name in names:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            lib.pyrmt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pyrmt_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        libs.append(lib)
    return libs


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first
    if no build of the current sources exists."""
    return load_all((name,))[0]


def check_operands(what: str, ref, expect) -> None:
    """Raise unless ``ref`` is float32/float64 and every entry of
    ``expect`` ({name: (tensor, shape)}) is a contiguous tensor of that
    shape with ref's dtype and device (0-d scalars included: a Python
    number there would have to be copied to the card)."""
    import torch

    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} kernel takes float32/float64, not {ref.dtype}")
    for name, (t, shape) in expect.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{what}: {name} must be a tensor on "
                             f"{ref.device}, not {type(t).__name__}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}; "
                             f"expected {ref.dtype} on {ref.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{tuple(shape)} tensor, got {tuple(t.shape)}")


def bc_operands(what: str, velocity_bc,
                kinds=tuple(BC_CODES)) -> tuple[int, float]:
    """(Bc code, lid speed) of ``velocity_bc.kernel_spec``; raises
    ValueError for a BC without a spec of one of ``kinds``, the BCs that
    the ``what`` kernel applies."""
    spec = getattr(velocity_bc, "kernel_spec", None)
    if spec is None or spec[0] not in kinds:
        raise ValueError(
            f"the {what} kernel applies the velocity BC from its kernel_spec "
            f"(one of {kinds}); got {velocity_bc!r} with spec {spec!r}")
    return BC_CODES[spec[0]], float(spec[1]) if spec[0] == "lid" else 0.0


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


def launch(lib: ctypes.CDLL, fn, what: str, device, *args) -> None:
    """Call the launcher ``fn(*args, stream)`` on ``device``'s current
    stream with ``device`` the thread's current CUDA device, and raise on
    its error code. The launchers run their kernels on the current device
    (they never call cudaSetDevice), so a tensor on another card than the
    thread's current one is launched on its own card this way."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, stream_handle(device))
    check(lib, err, what)


def outputs(shape, like, slab):
    """A kernel's output tensor: zeros where the kernel leaves cells
    unwritten (a slab: its cut's stale cells and the cells outside the
    domain), else uninitialised."""
    import torch

    make = torch.zeros if slab else torch.empty
    return make(shape, dtype=like.dtype, device=like.device)


def slab_operands(shape, row_offset, Ny_total, col_offset, Nx_total):
    """(the launchers' (roff, coff, Ny_total, Nx_total) of a slab of
    ``shape`` (..., Ny, Nx), whether it is a slab): the global (row,
    column) of its element (0, 0) and the domain's extents, a whole
    field's (0, 0, Ny, Nx) where an axis has no offset. Raises ValueError
    where the slab holds no cell of the domain (``ops.slab.slab_axis``)."""
    from pyrmt_tpu_torch.ops.slab import slab_axis

    Ny, Nx = shape[-2:]
    out = []
    for n, off, total in ((Ny, row_offset, Ny_total),
                          (Nx, col_offset, Nx_total)):
        off = 0 if off is None else int(off)
        total = n if total is None else int(total)
        slab_axis(n, off, total)
        out.append((off, total))
    ops = (out[0][0], out[1][0], out[0][1], out[1][1])
    return ops, ops != (0, 0, Ny, Nx)
