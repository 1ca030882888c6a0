// All four RK4 stages of the blended momentum update, on Hopper.
//
// Replaces: pyrmt_tpu/kernels/momentum_rk4.py::momentum_rk4_pallas (the
// pl.pallas_call at momentum_rk4.py:453), the fused full-RK4 Pallas kernel.
// The plain version is pyrmt_tpu_torch.physics.momentum_core.
//
// Per stage s (input c_s = 0, dt/2, dt/2, dt):
//   stage_kernel  W = bc(u0 + c_s k_{s-1})        (velocity BC from the spec)
//   sigma_kernel  sigma = Hf mu_f (grad W + grad W^T) + KV + blended solid
//   rhs_kernel    k_s = -(W.grad)W + (div sigma - grad p) / rho, and the
//                 running sum k1 + 2 k2 + 2 k3 + k4
// then final_kernel u_new = bc(u0 + dt/6 sum). The BC has to act on each
// stage input BEFORE any neighbour reads it; materialising W does that.
// External forces are elided (has_ext=False): the slice has none.
//
// What bounds it on the H100: device-memory traffic. Each stage reads and
// writes ~16 fields of 4 or 8 bytes per cell with a 5-point stencil and
// ~100 flops per cell, far below the card's flop/byte balance. The design
// answers it only by keeping each pass a single coalesced sweep (one thread
// per cell, neighbouring threads on neighbouring addresses; the stencil
// reads hit L1/L2). The 13 launches per step move ~4x the bytes of one
// fused pass with halo recompute: fusing the stages in shared-memory tiles
// is later work.
//
// The BC, the stencils, sigma_kernel and the RHS are the device code of
// stencil_device.cuh, which momentum_rhs.cu (one RHS) runs too. Built with
// --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "stencil_device.cuh"

namespace {

using pyrmt::bc_u;
using pyrmt::bc_v;

// Raw (pre-BC) stage value base + h * k at a cell; base alone without k.
template <typename T>
struct Raw {
  const T* base;
  const T* k;
  T h;
  int Nx;
  __device__ T operator()(int j, int i) const {
    size_t n = static_cast<size_t>(j) * Nx + i;
    return k ? base[n] + h * k[n] : base[n];
  }
};

template <typename T>
__global__ void stage_kernel(const T* u0, const T* v0, const T* ku,
                             const T* kv, const T* dt, int stage, T* wu,
                             T* wv, int Ny, int Nx, int bc, T lid) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  T h = stage == 3 ? dt[0] : T(0.5) * dt[0];
  Raw<T> ru{u0, stage ? ku : nullptr, h, Nx};
  Raw<T> rv{v0, stage ? kv : nullptr, h, Nx};
  wu[n] = bc_u<T>(ru, j, i, Ny, Nx, bc, lid);
  wv[n] = bc_v<T>(rv, j, i, Ny, Nx, bc);
}

// k_s at a cell and its share of the running sum k1 + 2 k2 + 2 k3 + k4,
// summed left to right.
template <typename T>
__global__ void rhs_kernel(const T* wu, const T* wv, const T* sxx,
                           const T* sxy, const T* syy, const T* p,
                           const T* rho, T* ku, T* kv, T* su, T* sv,
                           int stage, int Ny, int Nx, double dx, double dy) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  T a, b;
  pyrmt::rhs_at<T>(wu, wv, sxx, sxy, syy, p, rho, nullptr, nullptr, n, j, i,
                   Ny, Nx, dx, dy, a, b);
  ku[n] = a;
  kv[n] = b;
  if (stage == 0) {
    su[n] = a;
    sv[n] = b;
  } else if (stage == 3) {
    su[n] = su[n] + a;
    sv[n] = sv[n] + b;
  } else {
    su[n] = su[n] + T(2) * a;
    sv[n] = sv[n] + T(2) * b;
  }
}

template <typename T>
__global__ void final_kernel(const T* u0, const T* v0, const T* su,
                             const T* sv, const T* dt, T* un, T* vn, int Ny,
                             int Nx, int bc, T lid) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  T h = dt[0] * static_cast<T>(1.0 / 6.0);
  Raw<T> ru{u0, su, h, Nx};
  Raw<T> rv{v0, sv, h, Nx};
  un[n] = bc_u<T>(ru, j, i, Ny, Nx, bc, lid);
  vn[n] = bc_v<T>(rv, j, i, Ny, Nx, bc);
}

// scratch holds 9 fields: W (2), k (2), running sum (2), sigma (3).
template <typename T>
int launch(const T* u, const T* v, const T* p, const T* sxx_el,
           const T* sxy_el, const T* syy_el, const T* Hf, const T* rho,
           const T* mkv, const T* dt, T* u_new, T* v_new, T* scratch, int Ny,
           int Nx, double dx, double dy, double mu_f, double eta_s, int bc,
           double lid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t N = static_cast<size_t>(Ny) * Nx;
  T* wu = scratch;
  T* wv = wu + N;
  T* ku = wv + N;
  T* kv = ku + N;
  T* su = kv + N;
  T* sv = su + N;
  T* sxx = sv + N;
  T* sxy = sxx + N;
  T* syy = sxy + N;
  const unsigned nb = pyrmt::blocks_for(static_cast<long long>(N));
  const int nt = pyrmt::kThreads;
  for (int s = 0; s < 4; ++s) {
    stage_kernel<T><<<nb, nt, 0, stream>>>(u, v, ku, kv, dt, s, wu, wv, Ny,
                                           Nx, bc, static_cast<T>(lid));
    PYRMT_RETURN_IF_ERROR();
    pyrmt::sigma_kernel<T><<<nb, nt, 0, stream>>>(
        wu, wv, sxx_el, sxy_el, syy_el, Hf, mkv, sxx, sxy, syy, Ny, Nx, dx, dy,
        mu_f, eta_s);
    PYRMT_RETURN_IF_ERROR();
    rhs_kernel<T><<<nb, nt, 0, stream>>>(wu, wv, sxx, sxy, syy, p, rho, ku,
                                         kv, su, sv, s, Ny, Nx, dx, dy);
    PYRMT_RETURN_IF_ERROR();
  }
  final_kernel<T><<<nb, nt, 0, stream>>>(u, v, su, sv, dt, u_new, v_new, Ny,
                                         Nx, bc, static_cast<T>(lid));
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_MOMENTUM_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* u, const T* v, const T* p, const T* sxx_el,   \
                      const T* sxy_el, const T* syy_el, const T* Hf,         \
                      const T* rho, const T* mkv, const T* dt, T* u_new,     \
                      T* v_new, T* scratch, int Ny, int Nx, double dx,       \
                      double dy, double mu_f, double eta_s, int bc,          \
                      double lid, void* stream) {                            \
    return launch<T>(u, v, p, sxx_el, sxy_el, syy_el, Hf, rho, mkv, dt,      \
                     u_new, v_new, scratch, Ny, Nx, dx, dy, mu_f, eta_s, bc, \
                     lid, stream);                                           \
  }

PYRMT_MOMENTUM_ENTRY(pyrmt_momentum_rk4_f32, float)
PYRMT_MOMENTUM_ENTRY(pyrmt_momentum_rk4_f64, double)
