// The RMT solid pipeline of one step, on Hopper, in two entry points:
//
// pyrmt_rmt_block_*  the fused tier, in one launch: rebuild,
//   shared-backtrace semi-Lagrangian RK4 advection, mask, layer-synchronous
//   least-squares extrapolation, rebuild, neo-Hookean stress and J,
//   smoothed Heaviside and the mixture blends. One solid, shaped as a Disc
//   given by runtime scalars. Replaces
//   pyrmt_tpu/kernels/rmt_block.py::rmt_block_fused (the pl.pallas_call at
//   rmt_block.py:825); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.rmt_block_plain.
// pyrmt_advext_*  the split tier's kernel A: the same advection, mask and
//   extrapolation with the pre-advection phi given as a field (any level
//   set, S solids one after another). Replaces
//   pyrmt_tpu/kernels/rmt_block.py::advext_block_fused (the pl.pallas_call
//   at rmt_block.py:1085); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.advext_block_plain.
//
// The fused tier: one block per 2D output tile (Span in common.cuh), with
// the state (X1, X2, known) of a panel of the tile plus 4L+1 cells each
// side in shared memory (L = num_layers):
//   vote     is any cell of the panel widened by 1 solid (phi = disc(X)
//            <= 0, or not finite) or fast enough that a backtrace may not
//            be finite (|u| or |v| times 8 max(1, |dt|/dx, |dt|/dy) not
//            below the type's largest value; dt not finite counts too)?
//            __syncthreads_or over the block.
//   skip     if not, every mask and known flag that can reach the tile is
//            0, so the pipeline yields the zero map there exactly: the
//            tile writes the post stage's own outputs for X1e = X2e = 0
//            (any disc, one that holds the origin included), computed once
//            for an interior and once for an edge cell, the only two
//            cases. The tile reads X1, X2, u, v and writes its 12 outputs.
//            The tile-activity skip of the Pallas kernel
//            (rmt_block.py:632-685), made exact for non-finite inputs too.
//   advect   phi0 = disc(X) -> RK4 backtrace through three bilinear samples
//            of (u, v) -> bilinear sample of X1, X2 -> times mask
//            (phi0 <= 0); known = phi0 < 0: over the whole panel, reading
//            u, v from the vote's copy and X1, X2 within +-1 cell
//   layers   L sweeps ping-ponging the panel's state in shared memory; a
//            sweep reads a 9x9 window, so sweep l is computed 4l cells in
//            from the panel's inner edges. The frontier cells (a thin ring)
//            are listed first and solved by consecutive threads: one lane
//            per warp doing a 9x9 window sum wasted the other 31.
//   post     phi = disc(Xe); stress with one-sided differences next to
//            fluid (interior cells only); H(phi); Hf, rho, (1-H) sigma;
//            written for the tile's own cells (reads Xe at +-1)
// Tile: 32 x 32 output cells where the panel fits a block's 227 KB of
// shared memory, else 16 x 16 or 8 x 8; 512 threads. At the flagship's
// L = 3 the panel is 58 x 58 cells and, with u and v kept from the vote
// for the backtrace (its three dependent samples then come from shared
// memory), 102,912 B in float32 (two blocks per SM at 64 registers),
// 185,600 B in float64 (one); recompute factor (panel / tile cells) 3.3
// for the tiles that do not skip. Where no tile fits (L >= 10 in float32,
// L >= 7 in float64) the panels live in a device-memory workspace, one per
// resident block, and the blocks walk over the tiles (2 per SM), so every
// num_layers runs.
//
// The split tier's entry keeps the staged launches, one thread per cell
// each (rmt_device.cuh): advect_kernel, then one layer_kernel per layer,
// ping-ponging a (6, Ny, Nx) scratch.
//
// What bounds the fused tier on the H100: the byte bound is 4 fields read
// and 12 written per cell (20.0 us at N=1024 float32); the kernel runs
// well above it (PERF.md), held back by the skip tiles (a vote that reads
// four fields over 3.5x the tile's cells, then the stores) and by the
// tiles at the disc, which recompute the backtrace over 3.3x their cells.
//
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "rmt_device.cuh"

namespace {

using pyrmt::Disc;
using pyrmt::Rows;
using pyrmt::Span;
using pyrmt::Taps;

constexpr int kBx = 32, kBy = 16;  // threads of a block: columns x rows
constexpr int kThreads = kBx * kBy;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's most on sm_90

// The 12 outputs of the fused tier.
template <typename T>
struct Outs {
  T *x1e, *x2e, *phi, *sxx, *sxy, *syy, *J, *Hf, *rho, *sbxx, *sbxy, *sbyy;
};

template <typename T>
__device__ constexpr T largest();
template <>
__device__ constexpr float largest<float>() {
  return 3.402823466e+38f;
}
template <>
__device__ constexpr double largest<double>() {
  return 1.7976931348623157e+308;
}

// The 12 outputs at one cell.
template <typename T>
struct Post {
  T x1e, x2e, phi, sxx, sxy, syy, J, Hf, rho, sbxx, sbxy, sbyy;

  __device__ void store(const Outs<T>& o, size_t g) const {
    o.x1e[g] = x1e;
    o.x2e[g] = x2e;
    o.phi[g] = phi;
    o.sxx[g] = sxx;
    o.sxy[g] = sxy;
    o.syy[g] = syy;
    o.J[g] = J;
    o.Hf[g] = Hf;
    o.rho[g] = rho;
    o.sbxx[g] = sbxx;
    o.sbxy[g] = sbxy;
    o.sbyy[g] = sbyy;
  }
};

// The post stage at cell (j, i), element n of a map whose rows are sy
// apart: phi = disc(Xe); the interior-mode stress with one-sided
// differences where exactly one neighbour along the axis is fluid; the
// smoothed Heaviside and the one-solid blends.
template <typename T>
__device__ Post<T> post_at(const T* X1, const T* X2, size_t n, size_t sy,
                           int j, int i, int Ny, int Nx, const Disc<T>& disc,
                           T mu_s, T kappa, T rho_s, T rho_f, double dx,
                           double dy, double w_t) {
  const T x1 = X1[n], x2 = X2[n];
  const T ph = disc(x1, x2);
  T s_xx = T(0), s_xy = T(0), s_yy = T(0), jac = T(1);
  bool interior = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
  if (interior && ph <= T(0)) {
    const size_t e = n + 1, w = n - 1, no = n + sy, so = n - sy;
    const T inv_dx = static_cast<T>(1.0 / dx), inv_dy = static_cast<T>(1.0 / dy);
    const T inv_2dx = static_cast<T>(1.0 / (2.0 * dx));
    const T inv_2dy = static_cast<T>(1.0 / (2.0 * dy));
    bool lf = disc(X1[w], X2[w]) > T(0), rf = disc(X1[e], X2[e]) > T(0);
    bool bf = disc(X1[so], X2[so]) > T(0), tf = disc(X1[no], X2[no]) > T(0);
    T g11, g21, g12, g22;
    if (lf && !rf) {
      g11 = (X1[e] - x1) * inv_dx;
      g21 = (X2[e] - x2) * inv_dx;
    } else if (rf && !lf) {
      g11 = (x1 - X1[w]) * inv_dx;
      g21 = (x2 - X2[w]) * inv_dx;
    } else {
      g11 = (X1[e] - X1[w]) * inv_2dx;
      g21 = (X2[e] - X2[w]) * inv_2dx;
    }
    if (bf && !tf) {
      g12 = (X1[no] - x1) * inv_dy;
      g22 = (X2[no] - x2) * inv_dy;
    } else if (tf && !bf) {
      g12 = (x1 - X1[so]) * inv_dy;
      g22 = (x2 - X2[so]) * inv_dy;
    } else {
      g12 = (X1[no] - X1[so]) * inv_2dy;
      g22 = (X2[no] - X2[so]) * inv_2dy;
    }
    T detG = g11 * g22 - g12 * g21;
    if (fabs(detG) >= static_cast<T>(1e-10)) {
      T inv_det = T(1) / detG;
      T f11 = g22 * inv_det, f12 = -g12 * inv_det;
      T f21 = -g21 * inv_det, f22 = g11 * inv_det;
      T b11 = f11 * f11 + f12 * f12;
      T b12 = f11 * f21 + f12 * f22;
      T b22 = f21 * f21 + f22 * f22;
      T vol = kappa * (inv_det - T(1));
      s_xx = mu_s * b11 + vol;
      s_xy = mu_s * b12;
      s_yy = mu_s * b22 + vol;
      jac = inv_det;
    }
  }
  // ops/stress.py::smoothed_heaviside
  const T inv_wt = static_cast<T>(1.0 / w_t);
  const T pi = static_cast<T>(3.141592653589793);  // math.pi
  const T inv_pi = static_cast<T>(1.0 / 3.141592653589793);
  T H = T(0.5) * (T(1) + ph * inv_wt + sin(pi * ph * inv_wt) * inv_pi);
  if (ph > static_cast<T>(w_t)) H = T(1);
  if (ph < static_cast<T>(-w_t)) H = T(0);
  const T hf = H - T(0);  // Hf = sum_i H_i - (S - 1) with S = 1
  const T omh = T(1) - H;
  return {x1,        x2,        ph,        s_xx,      s_xy,
          s_yy,      jac,       hf,        hf * rho_f + omh * rho_s,
          omh * s_xx, omh * s_xy, omh * s_yy};
}

// Bytes of a panel `width` cells square: two (X1, X2) buffers, u and v on
// the panel widened by 1, two known-flag buffers (bytes) and a list of
// frontier cells (panel indices); rounded up so that workspace panels stay
// aligned.
template <typename T>
size_t panel_bytes(int width) {
  const size_t n = static_cast<size_t>(width) * width;
  const size_t nv = static_cast<size_t>(width + 2) * (width + 2);
  return ((4 * n + 2 * nv) * sizeof(T) + (2 + sizeof(int)) * n + 4 + 255) /
         256 * 256;
}

// The fused tier's tile and where its panels live.
struct Plan {
  int tile;
  size_t bytes;  // one panel
  bool in_smem;
};

template <typename T>
Plan plan(int num_layers) {
  const int halo = 4 * num_layers + 1;
  const int tiles[] = {32, 16, 8};
  for (int tile : tiles) {
    const size_t b = panel_bytes<T>(tile + 2 * halo);
    if (b <= kMaxSmem) return {tile, b, true};
  }
  return {tiles[0], panel_bytes<T>(tiles[0] + 2 * halo), false};
}

__host__ __device__ unsigned num_tiles(int Ny, int Nx, int tile) {
  return pyrmt::tiles_for(Ny, tile) * pyrmt::tiles_for(Nx, tile);
}

// Blocks of a launch: one per tile, or with the panels in a workspace two
// per SM (sms of them), each walking over the tiles.
unsigned num_blocks(const Plan& p, int Ny, int Nx, int sms) {
  const unsigned n = num_tiles(Ny, Nx, p.tile);
  const unsigned resident = 2u * static_cast<unsigned>(sms);
  return p.in_smem || n < resident ? n : resident;
}

// The tile's own cells [out_lo, out_hi) of an axis, as a span of its own.
__device__ inline Span own(Span s) {
  s.lo = s.out_lo;
  s.hi = s.out_hi;
  return s;
}

// A panel widened by the advection's +-1 reads, clipped to [0, n).
__device__ inline Span widen(Span s, int n) {
  s.lo = max(0, s.lo - 1);
  s.hi = min(n, s.hi + 1);
  return s;
}

// f(lj, li) for each cell of a ph x pw panel, r cells in from its inner
// edges: warps along the rows, 16 rows at a time.
template <typename F>
__device__ __forceinline__ void for_panel(const Span& ys, const Span& xs,
                                          int r, F&& f) {
  const int ph = ys.size(), pw = xs.size();
  for (int lj = threadIdx.y; lj < ph; lj += kBy) {
    if (!ys.inside(lj, r)) continue;
    for (int li = threadIdx.x; li < pw; li += kBx)
      if (xs.inside(li, r)) f(lj, li);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    rmt_tile_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ X1, const T* __restrict__ X2,
                    const T* __restrict__ dt_ptr,
                    const T* __restrict__ params, Disc<T> disc, Outs<T> o,
                    int Ny, int Nx, double dx, double dy, int L, double w_t,
                    Taps<T> tp, int tile, unsigned char* ws,
                    size_t panel_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nfront;
  const int halo = 4 * L + 1;
  const int W = tile + 2 * halo;  // the panel buffers' row stride
  const size_t NP = static_cast<size_t>(W) * W;
  const size_t NV = static_cast<size_t>(W + 2) * (W + 2);
  // [X1 X1' X2 X2' u v known known' frontier list] (panel_bytes)
  T* const base =
      reinterpret_cast<T*>(ws ? ws + blockIdx.x * panel_stride : smem);
  T* const us = base + 4 * NP;
  T* const vs = us + NV;
  unsigned char* const kbase = reinterpret_cast<unsigned char*>(vs + NV);
  int* const flist = reinterpret_cast<int*>(
      kbase + (2 * NP + sizeof(int) - 1) / sizeof(int) * sizeof(int));
  const T dt = *dt_ptr;
  const T mu_s = params[0], kappa = params[1], rho_s = params[2];
  const T rho_f = params[3];
  // the vote's bound on |u|, |v|: below it every backtrace displacement
  // and every sum of the RK4 stages is finite
  const T big = largest<T>();
  const T inv_h = static_cast<T>(1.0 / (dx < dy ? dx : dy));
  T vscale = T(8) * (fabs(dt) * inv_h);
  if (!(vscale >= T(8))) vscale = T(8);
  const bool dt_bad = !isfinite(dt);
  // the zero map's outputs, at an interior cell and at an edge cell (they
  // differ only there); the post stage's own code on X1e = X2e = 0
  const T zero[9] = {};
  const Post<T> zero_in = post_at<T>(zero, zero, 4, 3, 1, 1, 3, 3, disc, mu_s,
                                     kappa, rho_s, rho_f, dx, dy, w_t);
  const Post<T> zero_edge = post_at<T>(zero, zero, 4, 3, 0, 0, 3, 3, disc,
                                       mu_s, kappa, rho_s, rho_f, dx, dy, w_t);
  const int ntx = static_cast<int>(pyrmt::tiles_for(Nx, tile));
  const int ntiles = static_cast<int>(num_tiles(Ny, Nx, tile));

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Span ys = pyrmt::tile_span((t / ntx) * tile, tile, Ny, halo);
    const Span xs = pyrmt::tile_span((t % ntx) * tile, tile, Nx, halo);
    const Span oy = own(ys), ox = own(xs);

    // vote over the panel widened by the advection's +-1 reads, keeping
    // u and v there for the backtrace
    const Span vy = widen(ys, Ny), vx = widen(xs, Nx);
    bool active = dt_bad;
    for_panel(vy, vx, 0, [&](int lj, int li) {
      const size_t g = static_cast<size_t>(vy.lo + lj) * Nx + (vx.lo + li);
      const T ug = u[g], vg = v[g];
      us[lj * (W + 2) + li] = ug;
      vs[lj * (W + 2) + li] = vg;
      const T ph = disc(X1[g], X2[g]);
      active |= !(ph > T(0) && ph <= big && fabs(ug) * vscale < big &&
                  fabs(vg) * vscale < big);
    });
    if (!__syncthreads_or(active)) {
      for_panel(oy, ox, 0, [&](int lj, int li) {
        const int j = oy.lo + lj, i = ox.lo + li;
        const bool in = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
        (in ? zero_in : zero_edge).store(o, static_cast<size_t>(j) * Nx + i);
      });
      continue;
    }

    // advect over the whole panel, u and v from the vote's copy
    const Rows<T> ut{us, static_cast<size_t>(W + 2), vy.lo, vx.lo};
    const Rows<T> vt{vs, static_cast<size_t>(W + 2), vy.lo, vx.lo};
    const Rows<T> x1g{X1, static_cast<size_t>(Nx), 0, 0};
    const Rows<T> x2g{X2, static_cast<size_t>(Nx), 0, 0};
    for_panel(ys, xs, 0, [&](int lj, int li) {
      const int j = ys.lo + lj, i = xs.lo + li;
      const size_t g = static_cast<size_t>(j) * Nx + i;
      const size_t l = static_cast<size_t>(lj) * W + li;
      T x1a, x2a, known;
      pyrmt::advect_at<T>(ut, vt, x1g, x2g, dt, disc(X1[g], X2[g]), j, i, Ny,
                          Nx, dx, dy, x1a, x2a, known);
      base[l] = x1a;
      base[2 * NP + l] = x2a;
      kbase[l] = known > T(0);
    });
    __syncthreads();

    // the layer sweeps, each 4 cells further in: the cells off the
    // frontier keep their state, the frontier cells (a thin ring) are
    // listed and then solved by consecutive threads
    for (int layer = 1; layer <= L; ++layer) {
      const size_t src = (layer - 1) & 1, dst = layer & 1;
      const T* x1s = base + src * NP;
      const T* x2s = base + (2 + src) * NP;
      const unsigned char* ks = kbase + src * NP;
      if (threadIdx.x == 0 && threadIdx.y == 0) nfront = 0;
      __syncthreads();
      for_panel(ys, xs, 4 * layer, [&](int lj, int li) {
        const size_t l = static_cast<size_t>(lj) * W + li;
        if (pyrmt::frontier_at<T, unsigned char>(ks, l, W, ys.lo + lj,
                                                 xs.lo + li, Ny, Nx)) {
          flist[atomicAdd(&nfront, 1)] = static_cast<int>(l);
        } else {
          base[dst * NP + l] = x1s[l];
          base[(2 + dst) * NP + l] = x2s[l];
          kbase[dst * NP + l] = ks[l];
        }
      });
      __syncthreads();
      for (int f = threadIdx.y * kBx + threadIdx.x; f < nfront;
           f += kThreads) {
        const int l = flist[f], lj = l / W, li = l - lj * W;
        T x1, x2, k;
        pyrmt::layer_at<T, unsigned char>(x1s, x2s, ks, l, W, ys.lo + lj,
                                          xs.lo + li, Ny, Nx, tp, x1, x2, k);
        base[dst * NP + l] = x1;
        base[(2 + dst) * NP + l] = x2;
        kbase[dst * NP + l] = k > T(0);
      }
      __syncthreads();
    }

    // post, for the tile's own cells
    const size_t e = L & 1;
    for_panel(oy, ox, 0, [&](int lj, int li) {
      const int j = oy.lo + lj, i = ox.lo + li;
      post_at<T>(base + e * NP, base + (2 + e) * NP,
                 static_cast<size_t>(j - ys.lo) * W + (i - xs.lo), W, j, i,
                 Ny, Nx, disc, mu_s, kappa, rho_s, rho_f, dx, dy, w_t)
          .store(o, static_cast<size_t>(j) * Nx + i);
    });
    __syncthreads();  // before the next tile overwrites the panel
  }
}

template <typename T>
long long workspace_bytes(int Ny, int Nx, int num_layers, int sms) {
  const Plan p = plan<T>(num_layers);
  if (p.in_smem) return 0;
  return static_cast<long long>(num_blocks(p, Ny, Nx, sms)) *
         static_cast<long long>(p.bytes);
}

// ws: workspace_bytes(...) bytes of device memory (unused when 0); sms:
// the card's SM count.
template <typename T>
int launch(const T* u, const T* v, const T* X1, const T* X2, const T* dt,
           const T* params, const Outs<T>& o, void* ws, int Ny, int Nx,
           double dx, double dy, int num_layers, double w_t, double x0,
           double y0, double R, const double* taps, int sms,
           void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  const Plan p = plan<T>(num_layers);
  const size_t smem = p.in_smem ? p.bytes : 0;
  int err = pyrmt::allow_smem(rmt_tile_kernel<T>, smem, allowed);
  if (err) return err;
  const Disc<T> disc{static_cast<T>(x0), static_cast<T>(y0),
                     static_cast<T>(R)};
  rmt_tile_kernel<T><<<num_blocks(p, Ny, Nx, sms), dim3(kBx, kBy), smem,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      u, v, X1, X2, dt, params, disc, o, Ny, Nx, dx, dy, num_layers, w_t,
      pyrmt::load_taps<T>(taps), p.tile,
      p.in_smem ? nullptr : static_cast<unsigned char*>(ws), p.bytes);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

// Split tier: per solid s, advect + mask with phi = phis[s], then
// num_layers sweeps into (x1e[s], x2e[s]). dt on the device.
template <typename T>
int launch_advext(const T* u, const T* v, const T* X1s, const T* X2s,
                  const T* phis, const T* dt, T* x1e, T* x2e, T* scratch,
                  int S, int Ny, int Nx, double dx, double dy, int num_layers,
                  const double* taps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t N = static_cast<size_t>(Ny) * Nx;
  const unsigned nb = pyrmt::blocks_for(static_cast<long long>(N));
  const Taps<T> tp = pyrmt::load_taps<T>(taps);
  T* const buf[2][3] = {{scratch, scratch + N, scratch + 2 * N},
                        {scratch + 3 * N, scratch + 4 * N, scratch + 5 * N}};
  for (int s = 0; s < S; ++s) {
    const size_t o = static_cast<size_t>(s) * N;
    pyrmt::advect_kernel<T><<<nb, pyrmt::kThreads, 0, stream>>>(
        u, v, X1s + o, X2s + o, dt, phis + o, buf[0][0], buf[0][1], buf[0][2],
        Ny, Nx, dx, dy);
    PYRMT_RETURN_IF_ERROR();
    int err = pyrmt::run_layers<T>(buf, x1e + o, x2e + o, num_layers, Ny, Nx,
                                   tp, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

#define PYRMT_RMT_ENTRY(NAME, WS_NAME, T)                                     \
  extern "C" long long WS_NAME(int Ny, int Nx, int num_layers, int sms) {     \
    return workspace_bytes<T>(Ny, Nx, num_layers, sms);                       \
  }                                                                           \
  extern "C" int NAME(const T* u, const T* v, const T* X1, const T* X2,       \
                      const T* dt, const T* params, T* x1e, T* x2e, T* phi,   \
                      T* sxx, T* sxy, T* syy, T* J, T* Hf, T* rho, T* sbxx,   \
                      T* sbxy, T* sbyy, void* ws, int Ny, int Nx, double dx,  \
                      double dy, int num_layers, double w_t, double x0,       \
                      double y0, double R, const double* taps, int sms,       \
                      void* stream) {                                         \
    const Outs<T> o{x1e, x2e, phi, sxx, sxy, syy, J, Hf, rho, sbxx, sbxy,     \
                    sbyy};                                                    \
    return launch<T>(u, v, X1, X2, dt, params, o, ws, Ny, Nx, dx, dy,         \
                     num_layers, w_t, x0, y0, R, taps, sms, stream);          \
  }

PYRMT_RMT_ENTRY(pyrmt_rmt_block_f32, pyrmt_rmt_block_workspace_f32, float)
PYRMT_RMT_ENTRY(pyrmt_rmt_block_f64, pyrmt_rmt_block_workspace_f64, double)

#define PYRMT_ADVEXT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* u, const T* v, const T* X1s, const T* X2s,     \
                      const T* phis, const T* dt, T* x1e, T* x2e,             \
                      T* scratch, int S, int Ny, int Nx, double dx,           \
                      double dy, int num_layers, const double* taps,          \
                      void* stream) {                                         \
    return launch_advext<T>(u, v, X1s, X2s, phis, dt, x1e, x2e, scratch, S,   \
                            Ny, Nx, dx, dy, num_layers, taps, stream);        \
  }

PYRMT_ADVEXT_ENTRY(pyrmt_advext_f32, float)
PYRMT_ADVEXT_ENTRY(pyrmt_advext_f64, double)
