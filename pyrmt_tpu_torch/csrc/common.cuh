// Shared helpers of the pyrmt_tpu_torch CUDA kernels.
//
// Every kernel runs one thread per grid cell of a row-major (Ny, Nx) field
// and evaluates its expressions in the order of the plain PyTorch version
// (built with --fmad=false, see kernels/_build.py), so the two round alike.
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

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ inline T clampf(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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
