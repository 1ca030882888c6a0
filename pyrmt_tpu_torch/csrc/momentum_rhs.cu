// One blended momentum RHS, on Hopper.
//
// Replaces: pyrmt_tpu/kernels/momentum_rhs.py::velocity_rhs_blended_pallas
// (the pl.pallas_call at momentum_rhs.py:260), the fused one-stage RHS that
// use_pallas_rhs=True runs at each stage of the momentum_method='xla' RK4
// loop. The plain version is pyrmt_tpu_torch.physics.velocity_rhs_blended.
//
//   sigma_kernel  sigma = Hf mu_f (grad u + grad u^T) + blended solid stress
//   rhs_kernel    rhs = -(u.grad)u + (div sigma + f_ext - grad p) / rho
//
// Both run the RK4 kernel's stage code (stencil_device.cuh): sigma_at
// with eta_s = 0 (the stage loop adds the Kelvin-Voigt term to the solid
// stress as plain ops before it calls the RHS), and the RHS with the
// external force added and no running sum. The TPU kernel's row tiling,
// and its fallback to XLA where the tiling does not divide Ny, do not carry
// over: any grid of at least 5x5 runs here.
//
// What bounds it on the H100: device-memory traffic, as in momentum_rk4.cu:
// two coalesced sweeps, one thread per cell, ~13 fields of 4 or 8 bytes per
// cell and ~100 flops. Two launches in place of the ~305 PyTorch ops of
// the plain version; the stress goes through device memory once.
//
// Built with --fmad=false, every expression in the order of the plain
// version, so the two round alike.
#include "stencil_device.cuh"

namespace {

template <typename T>
__global__ void rhs_kernel(const T* u, const T* v, const T* sxx, const T* sxy,
                           const T* syy, const T* p, const T* rho,
                           const T* fx, const T* fy, T* rhs_u, T* rhs_v,
                           int Ny, int Nx, double dx, double dy) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  using A = pyrmt::At<T>;
  const size_t c = static_cast<size_t>(n), sy = static_cast<size_t>(Nx);
  pyrmt::rhs_at<T>(A{u, c, sy}, A{v, c, sy}, A{sxx, c, sy}, A{sxy, c, sy},
                   A{syy, c, sy}, A{p, c, sy}, rho[n], fx, fy, c, j, i, Ny,
                   Nx, dx, dy, rhs_u[n], rhs_v[n]);
}

// scratch holds the 3 stress fields.
template <typename T>
int launch(const T* u, const T* v, const T* p, const T* sxx_s,
           const T* sxy_s, const T* syy_s, const T* Hf, const T* rho,
           const T* fx, const T* fy, T* rhs_u, T* rhs_v, T* scratch, int Ny,
           int Nx, double dx, double dy, double mu_f, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t N = static_cast<size_t>(Ny) * Nx;
  T* sxx = scratch;
  T* sxy = sxx + N;
  T* syy = sxy + N;
  const unsigned nb = pyrmt::blocks_for(static_cast<long long>(N));
  const int nt = pyrmt::kThreads;
  pyrmt::sigma_kernel<T><<<nb, nt, 0, stream>>>(
      u, v, sxx_s, sxy_s, syy_s, Hf, nullptr, sxx, sxy, syy, Ny, Nx, dx, dy,
      mu_f, 0.0);
  PYRMT_RETURN_IF_ERROR();
  rhs_kernel<T><<<nb, nt, 0, stream>>>(u, v, sxx, sxy, syy, p, rho, fx, fy,
                                       rhs_u, rhs_v, Ny, Nx, dx, dy);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_MOMENTUM_RHS_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const T* u, const T* v, const T* p, const T* sxx_s,     \
                      const T* sxy_s, const T* syy_s, const T* Hf,            \
                      const T* rho, const T* fx, const T* fy, T* rhs_u,       \
                      T* rhs_v, T* scratch, int Ny, int Nx, double dx,        \
                      double dy, double mu_f, void* stream) {                 \
    return launch<T>(u, v, p, sxx_s, sxy_s, syy_s, Hf, rho, fx, fy, rhs_u,    \
                     rhs_v, scratch, Ny, Nx, dx, dy, mu_f, stream);           \
  }

PYRMT_MOMENTUM_RHS_ENTRY(pyrmt_momentum_rhs_f32, float)
PYRMT_MOMENTUM_RHS_ENTRY(pyrmt_momentum_rhs_f64, double)
