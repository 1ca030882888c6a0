// Shared helpers of the pyrmt_tpu_torch CUDA kernels.
//
// Every kernel is a tile kernel (momentum_rk4.cu, momentum_rhs.cu,
// projection_stencils.cu, both entries of rmt_block.cu,
// extrapolate_fused.cu): one block per 2D tile of a row-major (Ny, Nx)
// field, with a halo (Span). Every kernel evaluates its expressions in
// the order of the plain PyTorch version (built with --fmad=false, see
// kernels/_build.py), so the two round alike.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define PYRMT_RETURN_IF_ERROR()                      \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

namespace pyrmt {

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ inline T clampf(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One axis of a tile kernel's tile. The block writes the cells [out_lo,
// out_hi) and computes over the panel [lo, hi): the core [core_lo,
// core_hi), which is the output cells widened to a whole tile where the
// domain's end cuts the tile short, plus `halo` cells on each side,
// clipped to the domain [0, n). Widening the core keeps a short last tile
// as deep in the panel as a whole one: the one-sided closures at the
// domain's edge reach further inward than the interior stencils do.
struct Span {
  int lo, hi, core_lo, core_hi, out_lo, out_hi, n;

  __device__ int size() const { return hi - lo; }

  // Panel index l lies in the panel, at least r cells in from each panel
  // edge that is not the domain's edge: a stage whose inputs are valid
  // r - d cells in is valid there when it reads d cells around.
  __device__ bool inside(int l, int r) const {
    return l < hi - lo && (lo == 0 || l >= r) && (hi == n || l < hi - lo - r);
  }
};

__device__ inline Span tile_span(int t0, int t, int n, int halo) {
  Span s;
  s.n = n;
  s.out_lo = t0;
  s.out_hi = min(t0 + t, n);
  s.core_lo = max(0, min(t0, n - t));
  s.core_hi = min(n, s.core_lo + t);
  s.lo = max(0, s.core_lo - halo);
  s.hi = min(n, s.core_hi + halo);
  return s;
}

__host__ __device__ inline unsigned tiles_for(int n, int t) {
  return static_cast<unsigned>((n + t - 1) / t);
}

// Raise a kernel's limit of dynamic shared memory to `bytes` (needed above
// 48 KB) once per kernel; returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed = bytes;
  return 0;
}

// phi = |x - (x0, y0)| - R: the Disc shape of ops/levelset.py
template <typename T>
struct Disc {
  T x0, y0, R;
  __device__ T operator()(T x1, T x2) const {
    T ex = x1 - x0;
    T ey = x2 - y0;
    return sqrt(ex * ex + ey * ey) - R;
  }
};

}  // namespace pyrmt

extern "C" const char* pyrmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
