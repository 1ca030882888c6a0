// All four RK4 stages of the blended momentum update, on Hopper, in one
// launch.
//
// Replaces: pyrmt_tpu/kernels/momentum_rk4.py::momentum_rk4_pallas (the
// pl.pallas_call at momentum_rk4.py:453), the fused full-RK4 Pallas kernel.
// The plain version is pyrmt_tpu_torch.physics.momentum_core.
//
// One block per 2D output tile, computing over the tile plus an 8-cell
// halo (the panel, Span in common.cuh): each stage reads the stage before
// at up to +-2 cells (3rd-order upwind, and the stress's central
// difference of a central difference), so four stages shrink the valid
// region by 8. A panel edge on the domain's edge needs no halo; every
// closure chooses by the cell's global index, and cells outside the domain
// are never read. Per stage s (c_s = 0, dt/2, dt/2, dt), over the region
// still valid:
//   1. raw W = u0 + c_s k_{s-1} into shared memory, then the velocity BC
//      in place on the domain's edge (bc_u/bc_v over the raw tile: a wall
//      cell reads only inner cells, which the BC leaves as they are; the u
//      columns are zeroed before the rows are copied, bcs.py's order)
//   2. sigma = Hf mu_f (grad W + grad W^T) + KV + blended solid, in shared
//      memory
//   3. k_s = -(W.grad)W + (div sigma - grad p) / rho and the running sum
//      k1 + 2 k2 + 2 k3 + k4, in shared memory
// then u_new = bc(u0 + dt/6 sum) the same way, written for the tile's own
// cells. The stage-constant fields (p, the solid stresses, Hf, rho, mkv,
// the external force) and u0, v0 are read from device memory at each
// stage, a panel's reuse going through L1 and L2. The external force
// (f_x, f_y: contact, gravity) is a second instantiation (kExt, the TPU
// kernel's has_ext=True), added as the plain version adds it: (div sigma
// + f - grad p) / rho; it is read at the cell itself, so a halo cell reads
// it in the domain like any other. Without a force the launch is the
// instantiation that has no force operands.
// A tile whose panel keeps 2 cells off the domain's edge (most of them)
// runs a copy of the code in which the BC is the identity and every
// stencil is the interior one.
//
// The doubly-periodic box (BC code kPeriodic, bcs.periodic_bc) is a third
// instantiation, the TPU kernel's ('periodic',) spec: its interior tiles
// run that interior copy as they are; a tile whose panel reaches within 2
// of an edge takes its full 8-cell halo across the seam (WrapSpan: the
// panel is not clipped to the domain) and reads every global field
// through the overlap wrap, index j as j mod (Ny - 1) (a true modulo: on
// a grid of fewer than 9 rows an index wraps more than once), the columns
// likewise; the overlap row Ny - 1 and column Nx - 1 are thus read as
// their copies, row and column 0. Every stencil is the interior one (the
// fd.*_periodic stencils are the interior ones on the wrapped grid) and
// the per-stage BC is the identity. Exact where the stage-constant fields
// are overlap-consistent (kernels/momentum_rk4.py says why the step's
// are); u0 and v0 are read only on the reduced grid.
//
// Tile: float32 48 x 32 output cells, a 64 x 48 panel, 512 threads, 9
// fields of shared memory (W, sigma, k, the sum: 110,592 B, two blocks per
// SM at 64 registers); float64 48 x 16, a 64 x 32 panel (147,456 B, one
// block). Recompute factor (panel / tile cells) 2.0 and 2.7 where the halo
// is interior. k and the sum live in shared memory, not in registers
// under a fixed thread-to-cell map: unrolling that map over every stage
// pass costs the registers, and so the occupancy, that the passes need.
//
// What bounds it on the H100: not the device-memory traffic (11 fields
// read or written, 13.8 us at N=1024 float32; 13 with the force, of which
// the step's eta_s = 0 configurations read 12: mkv is read only for
// Kelvin-Voigt) but the instructions: ~100
// flops per cell per stage without fused multiply-adds (see below), the
// closures' tests, and the shared-memory stencil reads, over ~2x the
// cells. It runs well above the byte bound (PERF.md).
//
// The sharding offsets (the Pallas kernel's row_offset / Ny_total /
// col_offset / Nx_total, for the domain decomposition of
// pyrmt_tpu_torch/parallel): the fields are one shard's slab, element
// (0, 0) at global (roff, coff), possibly negative, of an Nyt x Nxt domain
// (walls only: the periodic box takes none). The tiles cover the slab's
// valid cells (the zero halo beyond the domain is never read); in the
// kSlab instantiations (SlabSpan) the BC, every closure and the interior
// fast path take the global index, so a tile beside a cut is interior; a
// panel ends at a cut and its stages shrink from there as from any inner
// panel edge, so the tile writes only cells 8 in from the cut (the rest
// stay 0, as the plain twin leaves them). A whole field takes the
// instantiations without kSlab, whose code is the kernel's without
// offsets.
//
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
// The halo recompute evaluates the same expressions on the same values.
#include <initializer_list>
#include <type_traits>

#include "stencil_device.cuh"

namespace {

using pyrmt::At;
using pyrmt::Axis;
using pyrmt::bc_u;
using pyrmt::bc_v;
using pyrmt::Span;

constexpr int kThreads = 512;
constexpr int kHalo = 8;  // 4 stages x 2 cells

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int X = 48, Y = 32;
};
template <>
struct Tile<double> {
  static constexpr int X = 48, Y = 16;
};

// The panel's shape in shared memory and the cells each thread owns.
template <typename T>
struct Panel {
  static constexpr int W = Tile<T>::X + 2 * kHalo;  // row stride
  static constexpr int H = Tile<T>::Y + 2 * kHalo;
  static constexpr int N = W * H;
  static constexpr int CPT = (N + kThreads - 1) / kThreads;  // cells each
  // W (2), sigma (3), k (2) and the running sum (2)
  static constexpr size_t kSmem = 9 * sizeof(T) * N;
};

// One axis of a periodic tile's panel: the output cells [out_lo, out_hi),
// the core [out_lo, out_lo + t) and the halo around it, unclipped: lo may
// be negative and hi past the domain. Panel index l is global index
// at(l) = (lo + l) mod period, period = n - 1 (the overlap grid's).
struct WrapSpan {
  int lo, hi, out_lo, out_hi, period;

  __device__ bool inside(int l, int r) const {
    return l >= r && l < hi - lo - r;
  }
  __device__ int global(int l) const { return lo + l; }
  __device__ int at(int l) const {
    const int j = (lo + l) % period;
    return j < 0 ? j + period : j;
  }
};

__device__ inline WrapSpan wrap_span(int t0, int t, int n, int halo) {
  return WrapSpan{t0 - halo, t0 + t + halo, t0, min(t0 + t, n), n - 1};
}

// A device field seen from one cell of a periodic panel: p's central
// differences (At's gx and gy at an interior cell), the neighbours read
// through the wrap. row, row_n, row_s: the wrapped rows j, j + 1, j - 1
// times the row stride; i, ie, iw: the wrapped columns i, i + 1, i - 1.
template <typename T>
struct WrapAt {
  const T* f;
  size_t row, row_n, row_s;
  int i, ie, iw;

  __device__ T gx(int, int, T inv) const {
    return (f[row + ie] - f[row + iw]) * inv;
  }
  __device__ T gy(int, int, T inv) const {
    return (f[row_n + i] - f[row_s + i]) * inv;
  }
};

// The pre-BC value of a shared-memory panel at a global cell.
template <typename T>
struct TileRaw {
  const T* w;
  int j0, i0;
  __device__ T operator()(int j, int i) const {
    return w[(j - j0) * Panel<T>::W + (i - i0)];
  }
};

// f(lj, li) for each cell (lj, li) of the panel that this thread owns
// and that lies r cells in from the panel's inner edges (a Span or a
// WrapSpan).
template <typename T, typename S, typename F>
__device__ __forceinline__ void for_cells(const S& ys, const S& xs, int r,
                                          F&& f) {
#pragma unroll 1
  for (int c = 0; c < Panel<T>::CPT; ++c) {
    const int q = threadIdx.x + c * kThreads;
    const int lj = q / Panel<T>::W, li = q % Panel<T>::W;
    if (lj < Panel<T>::H && ys.inside(lj, r) && xs.inside(li, r)) f(lj, li);
  }
}

// The four stages and the update of one tile. kEdge false: no cell of the
// panel lies within 2 of the domain's edge, so the BC is the identity
// there and every stencil is the interior one; the closures' tests are
// then given a mid index (2 of 5) and fold away. S = WrapSpan (with kEdge
// false): a periodic edge tile, every global read through the wrap.
// kExt: the external force (fx, fy) is added to each stage's RHS.
template <typename T, bool kEdge, bool kExt, typename S>
__device__ __forceinline__ void rk4_tile(
    const S& ys, const S& xs, unsigned char* smem,
    const T* __restrict__ u0, const T* __restrict__ v0,
    const T* __restrict__ p, const T* __restrict__ sxx_el,
    const T* __restrict__ sxy_el, const T* __restrict__ syy_el,
    const T* __restrict__ Hf, const T* __restrict__ rho,
    const T* __restrict__ mkv, const T* __restrict__ fx,
    const T* __restrict__ fy, T dt, T* __restrict__ u_new,
    T* __restrict__ v_new, size_t stride, int Ny, int Nx, double dx,
    double dy, double mu_f, double eta_s, int bc, T lid) {
  using P = Panel<T>;
  constexpr bool kWrap = std::is_same<S, WrapSpan>::value;
  static_assert(!(kWrap && kEdge), "a periodic tile has no edge closures");
  T* Wu = reinterpret_cast<T*>(smem);
  T* Wv = Wu + P::N;
  T* Sxx = Wv + P::N;
  T* Sxy = Sxx + P::N;
  T* Syy = Sxy + P::N;
  T* Ku = Syy + P::N;
  T* Kv = Ku + P::N;
  T* Su = Kv + P::N;
  T* Sv = Su + P::N;
  // Ny, Nx: the domain's extents; a cell's global index is the panel's
  // origin g0 + lo plus its panel index
  const size_t sy = stride;
  const int ny = kEdge ? Ny : 5, nx = kEdge ? Nx : 5;
  auto gidx = [&](int lj, int li) {
    if constexpr (kWrap)
      return static_cast<size_t>(ys.at(lj)) * sy + xs.at(li);
    else
      return static_cast<size_t>(ys.lo + lj) * sy + (xs.lo + li);
  };
  auto mj = [&](int lj) { return kEdge ? ys.global(lj) : 2; };
  auto mi = [&](int li) { return kEdge ? xs.global(li) : 2; };

  for (int s = 0; s < 4; ++s) {
    const T h = s == 3 ? dt : T(0.5) * dt;
    // 1. the raw stage value, then the BC on the domain's edge
    for_cells<T>(ys, xs, 2 * s, [&](int lj, int li) {
      const size_t g = gidx(lj, li);
      const int l = lj * P::W + li;
      Wu[l] = s ? u0[g] + h * Ku[l] : u0[g];
      Wv[l] = s ? v0[g] + h * Kv[l] : v0[g];
    });
    __syncthreads();
    if (kEdge) {
      for_cells<T>(ys, xs, 2 * s, [&](int lj, int li) {
        const int j = mj(lj), i = mi(li);
        if (j != 0 && j != Ny - 1 && i != 0 && i != Nx - 1) return;
        const int j0 = ys.global(0), i0 = xs.global(0);
        const T bu = bc_u<T>(TileRaw<T>{Wu, j0, i0}, j, i, Ny, Nx, bc, lid);
        const T bv = bc_v<T>(TileRaw<T>{Wv, j0, i0}, j, i, Ny, Nx, bc);
        Wu[lj * P::W + li] = bu;
        Wv[lj * P::W + li] = bv;
      });
      __syncthreads();
    }
    // 2. the stress
    for_cells<T>(ys, xs, 2 * s + 1, [&](int lj, int li) {
      const size_t g = gidx(lj, li);
      const size_t l = static_cast<size_t>(lj) * P::W + li;
      pyrmt::sigma_at<T>(At<T>{Wu, l, P::W}, At<T>{Wv, l, P::W}, sxx_el[g],
                         sxy_el[g], syy_el[g], Hf[g], mkv, g, mj(lj), mi(li),
                         ny, nx, dx, dy, mu_f, eta_s, Sxx[l], Sxy[l],
                         Syy[l]);
    });
    __syncthreads();
    // 3. k_s and the running sum k1 + 2 k2 + 2 k3 + k4, left to right
    for_cells<T>(ys, xs, 2 * s + 2, [&](int lj, int li) {
      const size_t g = gidx(lj, li);
      const int l = lj * P::W + li;
      const size_t ls = l;
      T ra, rb;
      auto p_at = [&] {
        if constexpr (kWrap)
          return WrapAt<T>{p,
                           static_cast<size_t>(ys.at(lj)) * sy,
                           static_cast<size_t>(ys.at(lj + 1)) * sy,
                           static_cast<size_t>(ys.at(lj - 1)) * sy,
                           xs.at(li), xs.at(li + 1), xs.at(li - 1)};
        else
          return At<T>{p, g, sy};
      };
      pyrmt::rhs_at<T>(At<T>{Wu, ls, P::W}, At<T>{Wv, ls, P::W},
                       At<T>{Sxx, ls, P::W}, At<T>{Sxy, ls, P::W},
                       At<T>{Syy, ls, P::W}, p_at(), rho[g],
                       kExt ? fx : nullptr, kExt ? fy : nullptr, g, mj(lj),
                       mi(li), ny, nx, dx, dy, ra, rb);
      Ku[l] = ra;
      Kv[l] = rb;
      if (s == 0) {
        Su[l] = ra;
        Sv[l] = rb;
      } else if (s == 3) {
        Su[l] = Su[l] + ra;
        Sv[l] = Sv[l] + rb;
      } else {
        Su[l] = Su[l] + T(2) * ra;
        Sv[l] = Sv[l] + T(2) * rb;
      }
    });
    __syncthreads();
  }

  // u_new = bc(u0 + dt/6 sum) over the core, written for the own cells
  const T h6 = dt * static_cast<T>(1.0 / 6.0);
  for_cells<T>(ys, xs, kHalo, [&](int lj, int li) {
    const size_t g = gidx(lj, li);
    const int l = lj * P::W + li;
    Wu[l] = u0[g] + h6 * Su[l];
    Wv[l] = v0[g] + h6 * Sv[l];
  });
  __syncthreads();
  for_cells<T>(ys, xs, kHalo, [&](int lj, int li) {
    const int j = ys.lo + lj, i = xs.lo + li;
    if (j < ys.out_lo || j >= ys.out_hi || i < xs.out_lo || i >= xs.out_hi)
      return;
    // the output cell itself: a periodic panel's gidx would send the
    // overlap row and column to row and column 0
    size_t g;
    if constexpr (kWrap)
      g = static_cast<size_t>(j) * sy + i;
    else
      g = gidx(lj, li);
    if (kEdge) {
      const int j0 = ys.global(0), i0 = xs.global(0);
      u_new[g] = bc_u<T>(TileRaw<T>{Wu, j0, i0}, mj(lj), mi(li), Ny, Nx, bc,
                         lid);
      v_new[g] = bc_v<T>(TileRaw<T>{Wv, j0, i0}, mj(lj), mi(li), Ny, Nx, bc);
    } else {
      u_new[g] = Wu[lj * P::W + li];
      v_new[g] = Wv[lj * P::W + li];
    }
  });
}

// kSlab: a shard's slab (SlabSpan: the global index decides every edge and
// the BC; without it the code of a whole field).
template <typename T, bool kExt, bool kSlab>
__global__ void __launch_bounds__(kThreads, 2)
    rk4_kernel(const T* __restrict__ u0, const T* __restrict__ v0,
               const T* __restrict__ p, const T* __restrict__ sxx_el,
               const T* __restrict__ sxy_el, const T* __restrict__ syy_el,
               const T* __restrict__ Hf, const T* __restrict__ rho,
               const T* __restrict__ mkv, const T* __restrict__ fx,
               const T* __restrict__ fy, const T* __restrict__ dt_ptr,
               T* __restrict__ u_new, T* __restrict__ v_new, Axis ay,
               Axis ax, size_t stride, double dx, double dy, double mu_f,
               double eta_s, int bc, T lid) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the panel stops at a cut: every stage reads device memory within the
  // panel, the pressure within +-1 of cells 2 in (reach 0)
  const auto ys = pyrmt::span_of<kSlab>(blockIdx.y * Tile<T>::Y, Tile<T>::Y,
                                        ay, kHalo, 0);
  const auto xs = pyrmt::span_of<kSlab>(blockIdx.x * Tile<T>::X, Tile<T>::X,
                                        ax, kHalo, 0);
  const int Ny = ay.total, Nx = ax.total;
  const T dt = *dt_ptr;
  // the panel keeps 2 cells off the domain's edge (a cut is no edge)
  if (ys.global(0) >= 2 && ys.global(ys.size()) <= Ny - 2 &&
      xs.global(0) >= 2 && xs.global(xs.size()) <= Nx - 2)
    rk4_tile<T, false, kExt>(ys, xs, smem, u0, v0, p, sxx_el, sxy_el, syy_el,
                             Hf, rho, mkv, fx, fy, dt, u_new, v_new, stride,
                             Ny, Nx, dx, dy, mu_f, eta_s, bc, lid);
  else
    rk4_tile<T, true, kExt>(ys, xs, smem, u0, v0, p, sxx_el, sxy_el, syy_el,
                            Hf, rho, mkv, fx, fy, dt, u_new, v_new, stride,
                            Ny, Nx, dx, dy, mu_f, eta_s, bc, lid);
}

// The periodic instantiation (BC kPeriodic): the interior tiles as in
// rk4_kernel, the others over wrapped panels. bc and lid are not read.
template <typename T, bool kExt>
__global__ void __launch_bounds__(kThreads, 2)
    rk4_periodic_kernel(const T* __restrict__ u0, const T* __restrict__ v0,
                        const T* __restrict__ p, const T* __restrict__ sxx_el,
                        const T* __restrict__ sxy_el,
                        const T* __restrict__ syy_el,
                        const T* __restrict__ Hf, const T* __restrict__ rho,
                        const T* __restrict__ mkv, const T* __restrict__ fx,
                        const T* __restrict__ fy, const T* __restrict__ dt_ptr,
                        T* __restrict__ u_new, T* __restrict__ v_new, Axis ay,
                        Axis ax, size_t stride, double dx, double dy,
                        double mu_f, double eta_s, int bc, T lid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Ny = ay.n, Nx = ax.n;  // a whole field: no offsets
  const int ty = blockIdx.y * Tile<T>::Y, tx = blockIdx.x * Tile<T>::X;
  const Span ys = pyrmt::tile_span(ty, Tile<T>::Y, Ny, kHalo);
  const Span xs = pyrmt::tile_span(tx, Tile<T>::X, Nx, kHalo);
  const T dt = *dt_ptr;
  if (ys.lo >= 2 && ys.hi <= Ny - 2 && xs.lo >= 2 && xs.hi <= Nx - 2)
    rk4_tile<T, false, kExt>(ys, xs, smem, u0, v0, p, sxx_el, sxy_el, syy_el,
                             Hf, rho, mkv, fx, fy, dt, u_new, v_new, stride,
                             Ny, Nx, dx, dy, mu_f, eta_s, bc, lid);
  else
    rk4_tile<T, false, kExt>(wrap_span(ty, Tile<T>::Y, Ny, kHalo),
                             wrap_span(tx, Tile<T>::X, Nx, kHalo), smem, u0,
                             v0, p, sxx_el, sxy_el, syy_el, Hf, rho, mkv, fx,
                             fy, dt, u_new, v_new, stride, Ny, Nx, dx, dy,
                             mu_f, eta_s, bc, lid);
}

// The fields of one launch, from a slab's first valid cell.
template <typename T>
struct Fields {
  const T *u, *v, *p, *sxx_el, *sxy_el, *syy_el, *Hf, *rho, *mkv, *fx, *fy,
      *dt;
  T *u_new, *v_new;
};

template <typename T, bool kExt, bool kPeriodic, bool kSlab>
int launch_tiles(const Fields<T>& a, Axis ay, Axis ax, size_t stride,
                 double dx, double dy, double mu_f, double eta_s, int bc,
                 double lid, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  const size_t smem = Panel<T>::kSmem;
  auto kernel = kPeriodic ? rk4_periodic_kernel<T, kExt>
                          : rk4_kernel<T, kExt, kSlab>;
  int err = pyrmt::allow_smem(kernel, smem, allowed);
  if (err) return err;
  const dim3 grid(pyrmt::tiles_for(ax.n, Tile<T>::X),
                  pyrmt::tiles_for(ay.n, Tile<T>::Y));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      a.u, a.v, a.p, a.sxx_el, a.sxy_el, a.syy_el, a.Hf, a.rho, a.mkv, a.fx,
      a.fy, a.dt, a.u_new, a.v_new, ay, ax, stride, dx, dy, mu_f, eta_s, bc,
      static_cast<T>(lid));
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

// fx, fy: the external force, or both null for none. Ny, Nx: the slab's
// extents; roff, coff: the global (row, column) of its element (0, 0),
// negative for an edge shard's zero halo; Nyt, Nxt: the domain's (a whole
// field: 0, 0, Ny, Nx; the periodic box takes no other). The outputs are
// written at the slab's valid cells at least 8 cells in from each cut.
template <typename T>
int launch(Fields<T> a, int Ny, int Nx, int roff, int coff, int Nyt,
           int Nxt, double dx, double dy, double mu_f, double eta_s, int bc,
           double lid, void* stream_ptr) {
  int fy, fx;
  const Axis ay = pyrmt::slab_axis(Ny, roff, Nyt, fy);
  const Axis ax = pyrmt::slab_axis(Nx, coff, Nxt, fx);
  const bool whole = roff == 0 && coff == 0 && Nyt == Ny && Nxt == Nx;
  if (ay.n < 1 || ax.n < 1 || (bc == pyrmt::kPeriodic && !whole))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t f = static_cast<size_t>(fy) * Nx + fx, stride = Nx;
  for (const T** q : {&a.u, &a.v, &a.p, &a.sxx_el, &a.sxy_el, &a.syy_el,
                      &a.Hf, &a.rho, &a.mkv})
    *q += f;
  if (a.fx) {
    a.fx += f;
    a.fy += f;
  }
  a.u_new += f;
  a.v_new += f;
  if (bc == pyrmt::kPeriodic)
    return a.fx ? launch_tiles<T, true, true, false>(a, ay, ax, stride, dx,
                                                     dy, mu_f, eta_s, bc, lid,
                                                     stream_ptr)
                : launch_tiles<T, false, true, false>(a, ay, ax, stride, dx,
                                                      dy, mu_f, eta_s, bc,
                                                      lid, stream_ptr);
  auto run = a.fx ? (whole ? launch_tiles<T, true, false, false>
                           : launch_tiles<T, true, false, true>)
                  : (whole ? launch_tiles<T, false, false, false>
                           : launch_tiles<T, false, false, true>);
  return run(a, ay, ax, stride, dx, dy, mu_f, eta_s, bc, lid, stream_ptr);
}

}  // namespace

#define PYRMT_MOMENTUM_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* u, const T* v, const T* p, const T* sxx_el,   \
                      const T* sxy_el, const T* syy_el, const T* Hf,         \
                      const T* rho, const T* mkv, const T* fx, const T* fy,  \
                      const T* dt, T* u_new, T* v_new, int Ny, int Nx,       \
                      int roff, int coff, int Nyt, int Nxt, double dx,       \
                      double dy, double mu_f, double eta_s, int bc,          \
                      double lid, void* stream) {                            \
    return launch<T>(Fields<T>{u, v, p, sxx_el, sxy_el, syy_el, Hf, rho, mkv,  \
                               fx, fy, dt, u_new, v_new},                    \
                     Ny, Nx, roff, coff, Nyt, Nxt, dx, dy, mu_f, eta_s, bc,  \
                     lid, stream);                                           \
  }

PYRMT_MOMENTUM_ENTRY(pyrmt_momentum_rk4_f32, float)
PYRMT_MOMENTUM_ENTRY(pyrmt_momentum_rk4_f64, double)
