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
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "common.cuh"

namespace {

using pyrmt::clampi;

enum Bc { kNoop = 0, kLid = 1, kFreeSlip = 2 };

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

// bcs.make_lid_bc / free_slip_box_bc / noop_bc, evaluated at one cell from
// the raw field (the free-slip copies read the raw neighbour).
template <typename T>
__device__ T bc_u(const Raw<T>& r, int j, int i, int Ny, int Nx, int bc,
                  T lid) {
  if (bc == kLid) {
    bool col_b = i == 0 || i == Nx - 1;
    if (j == Ny - 1 && !col_b) return lid;
    if (col_b || j == 0 || j == Ny - 1) return T(0);
  } else if (bc == kFreeSlip) {
    if (i == 0 || i == Nx - 1) return T(0);
    if (j == 0) return r(1, i);
    if (j == Ny - 1) return r(Ny - 2, i);
  }
  return r(j, i);
}

template <typename T>
__device__ T bc_v(const Raw<T>& r, int j, int i, int Ny, int Nx, int bc) {
  if (bc == kLid) {
    if (i == 0 || i == Nx - 1 || j == 0 || j == Ny - 1) return T(0);
  } else if (bc == kFreeSlip) {
    if (j == 0 || j == Ny - 1) return T(0);
    if (i == 0) return r(j, 1);
    if (i == Nx - 1) return r(j, Nx - 2);
  }
  return r(j, i);
}

// fd.grad_central_{x,y}_2nd at one cell: central inside, 2nd-order
// one-sided on the boundary column/row. `s` is the stride along the axis,
// `m` the cell's index along it and `n` the axis length.
template <typename T>
__device__ T grad(const T* f, size_t c, size_t s, int m, int n, T inv) {
  if (m == 0) return (T(-3) * f[c] + T(4) * f[c + s] - f[c + 2 * s]) * inv;
  if (m == n - 1)
    return (T(3) * f[c] - T(4) * f[c - s] + f[c - 2 * s]) * inv;
  return (f[c + s] - f[c - s]) * inv;
}

// fd.diff_upwind_3rd at one cell: forward at the first index, backward at
// the last, 1st-order upwind at indices 1 and n-2, 3rd-order upwind-biased
// inside, upwinded by the sign of `vel`.
template <typename T>
__device__ T upwind(const T* f, size_t c, size_t s, int m, int n, T vel,
                    T inv_h, T inv_6h) {
  T f0 = f[c];
  if (m == 0) return (f[c + s] - f0) * inv_h;
  if (m == n - 1) return (f0 - f[c - s]) * inv_h;
  T fp1 = f[c + s], fm1 = f[c - s];
  if (m < 2 || m > n - 3) return vel > 0 ? (f0 - fm1) * inv_h : (fp1 - f0) * inv_h;
  T fp2 = f[c + 2 * s], fm2 = f[c - 2 * s];
  if (vel > 0) return (T(2) * fp1 + T(3) * f0 - T(6) * fm1 + fm2) * inv_6h;
  return (-fp2 + T(6) * fp1 - T(3) * f0 - T(2) * fm1) * inv_6h;
}

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
  wu[n] = bc_u(ru, j, i, Ny, Nx, bc, lid);
  wv[n] = bc_v(rv, j, i, Ny, Nx, bc);
}

template <typename T>
__global__ void sigma_kernel(const T* wu, const T* wv, const T* sxx_el,
                             const T* sxy_el, const T* syy_el, const T* Hf,
                             const T* mkv, T* sxx, T* sxy, T* syy, int Ny,
                             int Nx, double dx, double dy, double mu_f,
                             double eta_s) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  T du_dx = grad(wu, n, 1, i, Nx, inv_x);
  T dv_dy = grad(wv, n, Nx, j, Ny, inv_y);
  T du_dy = grad(wu, n, Nx, j, Ny, inv_y);
  T dv_dx = grad(wv, n, 1, i, Nx, inv_x);
  T a = sxx_el[n], b = syy_el[n], c = sxy_el[n];
  if (eta_s > 0.0) {  // Kelvin-Voigt damping inside the solid
    T m = mkv[n];
    a = a + m * (static_cast<T>(eta_s) * du_dx);
    b = b + m * (static_cast<T>(eta_s) * dv_dy);
    c = c + m * (static_cast<T>(eta_s * 0.5) * (du_dy + dv_dx));
  }
  T h = Hf[n];
  sxx[n] = h * (static_cast<T>(2.0 * mu_f) * du_dx) + a;
  syy[n] = h * (static_cast<T>(2.0 * mu_f) * dv_dy) + b;
  sxy[n] = h * (static_cast<T>(mu_f) * (du_dy + dv_dx)) + c;
}

template <typename T>
__global__ void rhs_kernel(const T* wu, const T* wv, const T* sxx,
                           const T* sxy, const T* syy, const T* p,
                           const T* rho, T* ku, T* kv, T* su, T* sv,
                           int stage, int Ny, int Nx, double dx, double dy) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  const T ih_x = static_cast<T>(1.0 / dx), ih_y = static_cast<T>(1.0 / dy);
  const T i6_x = static_cast<T>(1.0 / (6.0 * dx));
  const T i6_y = static_cast<T>(1.0 / (6.0 * dy));
  T div_x = grad(sxx, n, 1, i, Nx, inv_x) + grad(sxy, n, Nx, j, Ny, inv_y);
  T div_y = grad(sxy, n, 1, i, Nx, inv_x) + grad(syy, n, Nx, j, Ny, inv_y);
  T uc = wu[n], vc = wv[n];
  T u_adv = (-uc) * upwind(wu, n, 1, i, Nx, uc, ih_x, i6_x)
            - vc * upwind(wu, n, Nx, j, Ny, vc, ih_y, i6_y);
  T v_adv = (-uc) * upwind(wv, n, 1, i, Nx, uc, ih_x, i6_x)
            - vc * upwind(wv, n, Nx, j, Ny, vc, ih_y, i6_y);
  T dp_dx = grad(p, n, 1, i, Nx, inv_x);
  T dp_dy = grad(p, n, Nx, j, Ny, inv_y);
  T inv_rho = T(1) / (rho[n] + static_cast<T>(1e-12));
  T a = u_adv + (div_x - dp_dx) * inv_rho;
  T b = v_adv + (div_y - dp_dy) * inv_rho;
  ku[n] = a;
  kv[n] = b;
  // k1 + 2 k2 + 2 k3 + k4, summed left to right
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
  un[n] = bc_u(ru, j, i, Ny, Nx, bc, lid);
  vn[n] = bc_v(rv, j, i, Ny, Nx, bc);
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
    sigma_kernel<T><<<nb, nt, 0, stream>>>(wu, wv, sxx_el, sxy_el, syy_el,
                                           Hf, mkv, sxx, sxy, syy, Ny, Nx,
                                           dx, dy, mu_f, eta_s);
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
