// The whole narrow-band extrapolation of one reference map, on Hopper:
// max_layers layer-synchronous Gaussian least-squares sweeps from the
// known cells (phi < 0) outward.
//
// Replaces: pyrmt_tpu/kernels/extrapolate_fused.py::
// extrapolate_reference_map_fused (the pl.pallas_call at
// extrapolate_fused.py:202). The plain version is
// pyrmt_tpu_torch.ops.extrapolate.extrapolate_reference_map.
//
// Stages, one thread per cell each:
//   init_kernel   known = phi < 0; copy X1, X2 into the ping-pong scratch
//   layer_kernel  one launch per layer (rmt_device.cuh, shared with the
//                 RMT-block kernels), the last one into the outputs
//
// What bounds it on the H100: device-memory traffic (each layer launch
// reads and writes three fields) and, on the thin frontier ring only, the
// 9x9 window sums and the Cramer solve. The Pallas kernel keeps all sweeps
// of a row tile in VMEM with a 4*max_layers halo; doing the same in shared
// memory is later work — this kernel runs at rebase events, not per step.
//
// Built with --fmad=false: the sums and the solve round as in the plain
// PyTorch version, so the two agree bit for bit (chip_smoke.py).
#include "rmt_device.cuh"

namespace {

template <typename T>
__global__ void init_kernel(const T* X1, const T* X2, const T* phi, T* X1o,
                            T* X2o, T* kfo, long long N) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  X1o[n] = X1[n];
  X2o[n] = X2[n];
  kfo[n] = phi[n] < T(0) ? T(1) : T(0);
}

// scratch: 6 fields (X1, X2, known) x 2 for the ping-pong.
template <typename T>
int launch(const T* X1, const T* X2, const T* phi, T* x1e, T* x2e,
           T* scratch, int Ny, int Nx, int max_layers, const double* taps,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long N = static_cast<long long>(Ny) * Nx;
  T* const buf[2][3] = {{scratch, scratch + N, scratch + 2 * N},
                        {scratch + 3 * N, scratch + 4 * N, scratch + 5 * N}};
  // with no layer the outputs are the inputs
  T* x1_0 = max_layers > 0 ? buf[0][0] : x1e;
  T* x2_0 = max_layers > 0 ? buf[0][1] : x2e;
  init_kernel<T><<<pyrmt::blocks_for(N), pyrmt::kThreads, 0, stream>>>(
      X1, X2, phi, x1_0, x2_0, buf[0][2], N);
  PYRMT_RETURN_IF_ERROR();
  return pyrmt::run_layers<T>(buf, x1e, x2e, max_layers, Ny, Nx,
                              pyrmt::load_taps<T>(taps), stream);
}

}  // namespace

#define PYRMT_EXTRAP_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* X1, const T* X2, const T* phi, T* x1e,         \
                      T* x2e, T* scratch, int Ny, int Nx, int max_layers,     \
                      const double* taps, void* stream) {                     \
    return launch<T>(X1, X2, phi, x1e, x2e, scratch, Ny, Nx, max_layers,      \
                     taps, stream);                                           \
  }

PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f32, float)
PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f64, double)
