// One blended momentum RHS, on Hopper, in one launch.
//
// Replaces: pyrmt_tpu/kernels/momentum_rhs.py::velocity_rhs_blended_pallas
// (the pl.pallas_call at momentum_rhs.py:260), the fused one-stage RHS that
// use_pallas_rhs=True runs at each stage of the momentum_method='xla' RK4
// loop. The plain version is pyrmt_tpu_torch.physics.velocity_rhs_blended.
//
// One block per 2D output tile, computing over the tile plus a 2-cell halo
// (the panel, Span in common.cuh), with the RK4 kernel's stage code
// (stencil_device.cuh):
//   1. u, v over the panel into shared memory;
//   2. sigma = Hf mu_f (grad u + grad u^T) + the blended solid stress
//      (sigma_at with eta_s = 0: the stage loop adds the Kelvin-Voigt term
//      to the solid stress as plain ops before it calls the RHS) over the
//      panel less its outer ring, into shared memory; sig_s* and Hf read
//      from device memory;
//   3. rhs = -(u.grad)u + (div sigma + f - grad p) / rho (rhs_at with the
//      external force) for the tile's own cells: u, v and sigma from shared
//      memory, p, rho, fx, fy from device memory.
// The 3rd-order upwind and the divergence of the stress reach 2 cells off
// the domain's edge; on it the one-sided closures reach 3 cells inward,
// which the widened core of a tile cut short by the domain's end keeps
// inside the panel (tests/test_torch_tile_halo.py pins both radii). A tile
// whose panel does not touch the domain's edge runs a copy of the code in
// which every stencil is the interior one. The TPU kernel's row tiling,
// and its fallback to XLA where the tiling does not divide Ny, do not carry
// over: any grid of at least 5x5 runs here.
//
// Tile: 64 x 32 output cells, a 68 x 36 panel, 512 threads; u, v and sigma
// in shared memory, 48,960 B in float32, 97,920 B in float64. The panel
// reads u and v over 1.2x the tile's cells, the stress's inputs over 1.1x;
// nothing goes through device memory between the stages.
//
// What bounds it on the H100: the byte bound is 10 fields read and 2
// written per cell (15.0 us at N=1024 float32); ~100 flops per cell without
// fused multiply-adds, the closures' tests and the shared-memory stencil
// reads keep it above that, and the three stages' dependent loads make it
// latency-bound: the time fell most with the warps in flight, so float32
// caps the registers at 32 (no spill) for four blocks per SM, the whole
// SM; float64's shared memory allows two (PERF.md).
//
// Built with --fmad=false, every expression in the order of the plain
// version, so the two round alike.
#include "stencil_device.cuh"

namespace {

using pyrmt::At;
using pyrmt::Span;

constexpr int kThreads = 512;
constexpr int kHalo = 2;
constexpr int kTx = 64, kTy = 32;  // output cells of a tile
constexpr int kW = kTx + 2 * kHalo;  // the panel's row stride
constexpr int kN = kW * (kTy + 2 * kHalo);
constexpr size_t kSmemCells = 5 * static_cast<size_t>(kN);  // u, v, sigma
// blocks per SM that the registers are capped for
template <typename T>
constexpr int kBlocksPerSm = sizeof(T) == 4 ? 4 : 2;

// f(lj, li) for each cell of the panel r cells in from its inner edges.
template <typename F>
__device__ __forceinline__ void for_cells(const Span& ys, const Span& xs,
                                          int r, F&& f) {
#pragma unroll 1
  for (int q = threadIdx.x; q < kN; q += kThreads) {
    const int lj = q / kW, li = q % kW;
    if (ys.inside(lj, r) && xs.inside(li, r)) f(lj, li);
  }
}

// The RHS of one tile. kEdge false: the panel does not touch the domain's
// edge, so every stencil is the interior one; the closures' tests are then
// given a mid index (2 of 5) and fold away.
template <typename T, bool kEdge>
__device__ __forceinline__ void rhs_tile(
    const Span& ys, const Span& xs, T* smem, const T* __restrict__ u,
    const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ sxx_s, const T* __restrict__ sxy_s,
    const T* __restrict__ syy_s, const T* __restrict__ Hf,
    const T* __restrict__ rho, const T* __restrict__ fx,
    const T* __restrict__ fy, T* __restrict__ rhs_u, T* __restrict__ rhs_v,
    int Ny, int Nx, double dx, double dy, double mu_f) {
  T* Wu = smem;
  T* Wv = Wu + kN;
  T* Sxx = Wv + kN;
  T* Sxy = Sxx + kN;
  T* Syy = Sxy + kN;
  const size_t sy = static_cast<size_t>(Nx);
  const int ny = kEdge ? Ny : 5, nx = kEdge ? Nx : 5;
  auto gidx = [&](int lj, int li) {
    return static_cast<size_t>(ys.lo + lj) * sy + (xs.lo + li);
  };
  auto mj = [&](int lj) { return kEdge ? ys.lo + lj : 2; };
  auto mi = [&](int li) { return kEdge ? xs.lo + li : 2; };

  // 1. the velocity
  for_cells(ys, xs, 0, [&](int lj, int li) {
    const size_t g = gidx(lj, li);
    Wu[lj * kW + li] = u[g];
    Wv[lj * kW + li] = v[g];
  });
  __syncthreads();
  // 2. the stress
  for_cells(ys, xs, 1, [&](int lj, int li) {
    const size_t g = gidx(lj, li);
    const size_t l = static_cast<size_t>(lj) * kW + li;
    pyrmt::sigma_at<T>(At<T>{Wu, l, kW}, At<T>{Wv, l, kW}, sxx_s[g],
                       sxy_s[g], syy_s[g], Hf[g], nullptr, g, mj(lj), mi(li),
                       ny, nx, dx, dy, mu_f, 0.0, Sxx[l], Sxy[l], Syy[l]);
  });
  __syncthreads();
  // 3. the RHS at the tile's own cells
#pragma unroll 1
  for (int q = threadIdx.x; q < kTx * kTy; q += kThreads) {
    const int j = ys.out_lo + q / kTx, i = xs.out_lo + q % kTx;
    if (j >= ys.out_hi || i >= xs.out_hi) continue;
    const int lj = j - ys.lo, li = i - xs.lo;
    const size_t g = gidx(lj, li);
    const size_t l = static_cast<size_t>(lj) * kW + li;
    pyrmt::rhs_at<T>(At<T>{Wu, l, kW}, At<T>{Wv, l, kW}, At<T>{Sxx, l, kW},
                     At<T>{Sxy, l, kW}, At<T>{Syy, l, kW}, At<T>{p, g, sy},
                     rho[g], fx, fy, g, mj(lj), mi(li), ny, nx, dx, dy,
                     rhs_u[g], rhs_v[g]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
    rhs_kernel(const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ p, const T* __restrict__ sxx_s,
               const T* __restrict__ sxy_s, const T* __restrict__ syy_s,
               const T* __restrict__ Hf, const T* __restrict__ rho,
               const T* __restrict__ fx, const T* __restrict__ fy,
               T* __restrict__ rhs_u, T* __restrict__ rhs_v, int Ny, int Nx,
               double dx, double dy, double mu_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Span ys = pyrmt::tile_span(blockIdx.y * kTy, kTy, Ny, kHalo);
  const Span xs = pyrmt::tile_span(blockIdx.x * kTx, kTx, Nx, kHalo);
  T* s = reinterpret_cast<T*>(smem);
  if (ys.lo > 0 && ys.hi < Ny && xs.lo > 0 && xs.hi < Nx)
    rhs_tile<T, false>(ys, xs, s, u, v, p, sxx_s, sxy_s, syy_s, Hf, rho, fx,
                       fy, rhs_u, rhs_v, Ny, Nx, dx, dy, mu_f);
  else
    rhs_tile<T, true>(ys, xs, s, u, v, p, sxx_s, sxy_s, syy_s, Hf, rho, fx,
                      fy, rhs_u, rhs_v, Ny, Nx, dx, dy, mu_f);
}

template <typename T>
int launch(const T* u, const T* v, const T* p, const T* sxx_s,
           const T* sxy_s, const T* syy_s, const T* Hf, const T* rho,
           const T* fx, const T* fy, T* rhs_u, T* rhs_v, int Ny, int Nx,
           double dx, double dy, double mu_f, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  const size_t smem = kSmemCells * sizeof(T);
  int err = pyrmt::allow_smem(rhs_kernel<T>, smem, allowed);
  if (err) return err;
  const dim3 grid(pyrmt::tiles_for(Nx, kTx), pyrmt::tiles_for(Ny, kTy));
  rhs_kernel<T><<<grid, kThreads, smem,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
      u, v, p, sxx_s, sxy_s, syy_s, Hf, rho, fx, fy, rhs_u, rhs_v, Ny, Nx,
      dx, dy, mu_f);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_MOMENTUM_RHS_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const T* u, const T* v, const T* p, const T* sxx_s,     \
                      const T* sxy_s, const T* syy_s, const T* Hf,            \
                      const T* rho, const T* fx, const T* fy, T* rhs_u,       \
                      T* rhs_v, int Ny, int Nx, double dx, double dy,         \
                      double mu_f, void* stream) {                            \
    return launch<T>(u, v, p, sxx_s, sxy_s, syy_s, Hf, rho, fx, fy, rhs_u,    \
                     rhs_v, Ny, Nx, dx, dy, mu_f, stream);                    \
  }

PYRMT_MOMENTUM_RHS_ENTRY(pyrmt_momentum_rhs_f32, float)
PYRMT_MOMENTUM_RHS_ENTRY(pyrmt_momentum_rhs_f64, double)
