// The RMT solid pipeline of one step, on Hopper, in two entry points:
//
// pyrmt_rmt_block_*  the fused tier, in one launch: rebuild,
//   shared-backtrace semi-Lagrangian RK4 advection (bilinear or bicubic
//   final sample), mask, layer-synchronous least-squares extrapolation,
//   rebuild, neo-Hookean stress and J (interior or band mode; det G
//   clamped to [1/c, c] where the step clamps it: two solids and more, or
//   the band mode), smoothed Heaviside and the mixture blends. S solids (1 to kMaxSolids),
//   each a Disc or an Ellipse (common.cuh) given by runtime scalars. Replaces
//   pyrmt_tpu/kernels/rmt_block.py::rmt_block_fused (the pl.pallas_call at
//   rmt_block.py:825); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.rmt_block_plain.
// pyrmt_advext_*  the split tier's kernel A: the same advection, mask and
//   extrapolation with the pre-advection phi given as a field (any level
//   set, S solids sharing one backtrace). Replaces
//   pyrmt_tpu/kernels/rmt_block.py::advext_block_fused (the pl.pallas_call
//   at rmt_block.py:1085); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.advext_block_plain.
//
// The fused tier: one block per 2D output tile (Span in common.cuh), with
// the state (X1, X2, known) of a panel of the tile plus 4L+1 cells each
// side in shared memory (L = num_layers; the panels, tiles and layer
// sweeps are panel_device.cuh's, shared with extrapolate_fused.cu):
//   vote     is any cell of the panel widened by the final sample's reach
//            (1 cell, 2 for bicubic) solid (phi = shape(X) <= 0, or not
//            finite) or fast enough that a backtrace may not be finite
//            (|u| or |v| times 8 max(1, |dt|/dx, |dt|/dy) not below the
//            type's largest value; dt not finite counts too)?
//            __syncthreads_or over the block.
//   skip     if not, every mask and known flag that can reach the tile is
//            0, so the pipeline yields the zero map there exactly: the
//            tile writes the post stage's own outputs for X1e = X2e = 0
//            (any shape, one that holds the origin included), computed once
//            for an interior and once for an edge cell, the only two
//            cases. The tile reads X1, X2, u, v and writes its 12 outputs.
//            The tile-activity skip of the Pallas kernel
//            (rmt_block.py:632-685), made exact for non-finite inputs too.
//   advect   phi0 = shape(X) -> RK4 backtrace through three bilinear samples
//            of (u, v) -> bilinear sample of X1, X2 (bicubic: see below)
//            -> times mask (phi0 <= 0); known = phi0 < 0: over the whole
//            panel, reading u, v (panel widened by 1) from the vote's copy
//            and X1, X2 from device memory within +-1 cell (+-2)
//   layers   L sweeps ping-ponging the panel's state in shared memory; a
//            sweep reads a 9x9 window, so sweep l is computed 4l cells in
//            from the panel's inner edges. The frontier cells (a thin ring)
//            are listed first and solved by consecutive threads: one lane
//            per warp doing a 9x9 window sum wasted the other 31.
//   post     phi = shape(Xe); stress with one-sided differences next to
//            fluid over phi <= 0 (interior mode), or central differences
//            over phi < w_cut (band mode: a runtime operand, one uniform
//            branch), interior cells only; H(phi); Hf, rho, (1-H) sigma;
//            written for the tile's own cells (reads Xe at +-1)
// With S >= 2 solids (a second instantiation; S = 1 compiles to the code
// above) a tile runs vote, skip or advect, layers and post once per solid
// on the same panel: solid s writes its seven stacks' slices, and the
// mixture sums of its own cells go through the five mixture outputs in
// device memory (each cell read and written by the same thread): H_0 + H_1
// + ..., 1 - H_i and (1 - H_i) sigma_i summed in the solids' order, the
// last solid writing Hf = sum H - (S - 1) and rho. A skipped solid adds its
// zero map's terms, so every tile sums the plain version's terms: bit for
// bit for S = 2 (a sum of two terms), to a few ulps for S > 2, where
// torch.sum over the stack may add in another order.
// The level set: the shape is a template parameter (Sh) of the tile kernel.
// Discs alone compile to the code they had before the ellipse (Disc, for
// S = 1 the flagship's and for S >= 2 the collision's); one ellipse is an
// instantiation of its own (Ellipse), and S >= 2 solids with an ellipse
// among them take each solid's kind at run time (Shape, a uniform branch
// per solid: +12-18 % on two discs when every multi-solid call took it,
// PERF.md). The skip needs
// nothing of the shape: the vote reads the evaluated level set, and a finite
// ellipse phi bounds |X| too (a finite r bounds |fx| by the root of the
// type's largest value, so |X| by that times a), far below what a sample
// needs to stay finite.
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
// The bicubic final sample (kBicubic, a template parameter of both tile
// kernels, so that the bilinear instantiations keep their code): the
// 4x4 Catmull-Rom stencil of ops/interp.py::gather_bicubic_local at each
// panel cell, clamped to its taps' min/max, each tap's global index
// clipped into the grid (rmt_device.cuh's Bicubic); with the band guard
// the bilinear sample where the target cell's pre-advection phi0 is not
// below -sl_guard. The stage samples of (u, v) stay bilinear.
//   halo     stays 4L + 1. The final sample reads X1, X2 from device
//            memory, not from the panel, so its wider reach costs reads,
//            not halo: the sweeps consume the advected map only at panel
//            cells, each computed whole. (The Pallas kernel's 4L + 4 halo
//            closes exactly for bicubic because its slab holds X itself.)
//   vote     widened to the panel plus 2: every map value that a panel
//            cell's sample reads. Raw bicubic samples a fluid cell too
//            (times mask 0), and a non-finite map value within +-2 makes
//            that NaN in the plain version. With the guard on, every
//            fluid target (phi0 > 0 >= -sl_guard) takes the bilinear
//            sample, within +-1; the one rule serves both. A finite
//            phi = |X - c| - R bounds |X| (by ~1.8e19 in float32), far
//            below what a Catmull-Rom sum (at most 144 times its largest
//            tap) needs to stay finite, so the fused tier's phi test
//            covers overflow too; the split tier reads phi as a field, so
//            its pre-pass tests |X| * 256 against the largest value.
//   rounding cubic_convolution's terms in the plain version's order;
//            min, max and clamp propagate NaN as torch.minimum,
//            torch.maximum and torch.clamp do; -sl_guard and w_cut are
//            doubles rounded to T once, as PyTorch rounds a Python scalar
//            compared with a tensor.
//
// The split tier's entry, pyrmt_advext_*, runs the same panels and layer
// sweeps (panel_device.cuh) with phi read from the S fields phis[s], in one
// tile kernel, after a pre-pass for its skip:
//   flags    advext_flag_kernel, one block per 32 x 32 cells: a byte per
//            8 x 8 cells, set where a cell is not quiet_at (a phi not above
//            0, a map value past half the type's largest, a velocity past
//            the backtrace's bound); each input read once
//   vote     a tile is active if dt is not finite or any flag over the
//            panel widened by the final sample's reach (+-1, bicubic +-2)
//            is set (at most 9 x 9 bytes read: the flags dilated by the
//            panel's reach, 8 cells coarse); an inactive tile writes
//            X1e = X2e = 0 for every solid,
//            the plain version's value there (mask 0, no known cell, an
//            empty frontier, 0 * finite = 0), and moves on
//   advect   u, v over the widened panel into shared memory, the RK4
//            backtrace once per cell for all S solids (the plain version
//            advects the stack of all maps with one backtrace); per solid,
//            the masked sample of X1s[s], X2s[s] with phis[s], bilinear or
//            bicubic with the guard taken from phis[s] (for S > 1 the
//            displacements wait in u and v's place)
//   layers   the fused tier's L sweeps, then the tile's own cells of
//            x1e[s], x2e[s]
// The pre-pass replaced a vote inside the tile kernel over the widened
// panel, as the fused tier's, which read 2 + 3S fields over 3.5x the tile's
// cells and was slower in every case measured (PERF.md).
//
// What bounds the fused tier on the H100: the byte bound is 2 + 2S fields
// read and 7S + 5 written per cell (16 fields, 20.0 us at N=1024 float32
// for S = 1; 25 and 31.3 us for S = 2; the bicubic and band modes move the
// same fields, so the same bound); the kernel runs well above it
// (PERF.md), held back by the skip tiles (a vote that reads four fields
// over 3.5x the tile's cells, then the stores; per solid), by the tiles at
// a disc, which recompute the backtrace over 3.3x their cells, and for
// S >= 2 by the mixture sums' reads and writes per solid.
// The split tier's bound is 2 + 3S fields read and 2S written (8.8 us at
// N=1024 float32, S = 1); the pre-pass reads those once, the skip tiles
// (most of the flagship's) then only write, and the active tiles, which
// recompute the backtrace over 3.3x their cells and run the sweeps, take
// most of the time (PERF.md).
//
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "panel_device.cuh"

namespace {

using pyrmt::Disc;
using pyrmt::Ellipse;
using pyrmt::Guard;
using pyrmt::flag_bytes;
using pyrmt::flag_cols;
using pyrmt::for_panel;
using pyrmt::kBx;
using pyrmt::kBy;
using pyrmt::kFlag;
using pyrmt::kFlagTile;
using pyrmt::kThreads;
using pyrmt::num_blocks;
using pyrmt::num_tiles;
using pyrmt::own;
using pyrmt::Panel;
using pyrmt::Plan;
using pyrmt::plan;
using pyrmt::Rows;
using pyrmt::Shape;
using pyrmt::Span;
using pyrmt::sweeps;
using pyrmt::Taps;

constexpr int kMaxSolids = 16;  // kernels/rmt_block.py MAX_SOLIDS

// The fused tier's solids, passed by value: Disc<T> for discs alone,
// Ellipse<T> for one ellipse, Shape<T> for S >= 2 with an ellipse.
template <typename Sh>
struct Shapes {
  Sh d[kMaxSolids];
};

// The stress's det G clamp: [lo, hi] where on (lo from the host as the
// plain version's torch.clamp takes it, 1.0 / c in double).
template <typename T>
struct Clamp {
  T lo, hi;
  bool on;
};

// The stress's band mode (ops/stress.py, w_cut > 0): where on, the stress
// is taken over phi < w_cut (w_cut rounded to T as the plain version's
// comparison rounds it) with central differences on both axes; where off,
// the interior mode.
template <typename T>
struct Band {
  T w_cut;
  bool on;
};

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

// The skip's bound on |u| and |v| is largest / vote_scale: below it every
// backtrace displacement and every sum of the RK4 stages is finite.
template <typename T>
__device__ T vote_scale(T dt, double dx, double dy) {
  const T inv_h = static_cast<T>(1.0 / (dx < dy ? dx : dy));
  T vscale = T(8) * (fabs(dt) * inv_h);
  if (!(vscale >= T(8))) vscale = T(8);
  return vscale;
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
// apart: phi = shape(Xe); the interior-mode stress with one-sided
// differences where exactly one neighbour along the axis is fluid, or the
// band mode's central differences over phi < w_cut (no shape evaluated at
// the neighbours); the smoothed Heaviside and the one-solid blends.
template <typename T, typename Sh>
__device__ Post<T> post_at(const T* X1, const T* X2, size_t n, size_t sy,
                           int j, int i, int Ny, int Nx, const Sh& disc,
                           T mu_s, T kappa, T rho_s, T rho_f, double dx,
                           double dy, double w_t, const Clamp<T>& clamp,
                           const Band<T>& band) {
  const T x1 = X1[n], x2 = X2[n];
  const T ph = disc(x1, x2);
  T s_xx = T(0), s_xy = T(0), s_yy = T(0), jac = T(1);
  bool interior = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
  if (interior && (band.on ? ph < band.w_cut : ph <= T(0))) {
    const size_t e = n + 1, w = n - 1, no = n + sy, so = n - sy;
    const T inv_dx = static_cast<T>(1.0 / dx), inv_dy = static_cast<T>(1.0 / dy);
    const T inv_2dx = static_cast<T>(1.0 / (2.0 * dx));
    const T inv_2dy = static_cast<T>(1.0 / (2.0 * dy));
    // band mode: no neighbour counts as fluid, so both axes are central
    bool lf = false, rf = false, bf = false, tf = false;
    if (!band.on) {
      lf = disc(X1[w], X2[w]) > T(0);
      rf = disc(X1[e], X2[e]) > T(0);
      bf = disc(X1[so], X2[so]) > T(0);
      tf = disc(X1[no], X2[no]) > T(0);
    }
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
      if (clamp.on) {  // torch.clamp: the upper end wins past the lower
        detG = detG < clamp.lo ? clamp.lo : detG;
        detG = detG > clamp.hi ? clamp.hi : detG;
      }
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

// A panel widened by r cells (the advection's reads), clipped to [0, n).
__device__ inline Span widen(Span s, int n, int r = 1) {
  s.lo = max(0, s.lo - r);
  s.hi = min(n, s.hi + r);
  return s;
}

// The fused tier's tile kernel (the source note above); kMulti: S >= 2;
// kBicubic: the bicubic final sample; Sh: the level sets' type.
template <typename T, bool kMulti, bool kBicubic, typename Sh>
__global__ void __launch_bounds__(kThreads, 2)
    rmt_tile_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ X1, const T* __restrict__ X2,
                    const T* __restrict__ dt_ptr,
                    const T* __restrict__ params, Shapes<Sh> discs, int S,
                    Clamp<T> clamp, Band<T> band, Guard<T> guard, Outs<T> o,
                    int Ny, int Nx, double dx, double dy, int L, double w_t,
                    Taps<T> tp, int tile, unsigned char* ws,
                    size_t panel_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nfront;
  const int halo = 4 * L + 1;
  const Panel<T> P(ws ? ws + blockIdx.x * panel_stride : smem,
                   tile + 2 * halo, true);
  const int W = P.W;
  const size_t N = static_cast<size_t>(Ny) * Nx;
  const T dt = *dt_ptr;
  const T mu_s = params[0], kappa = params[1], rho_s = params[2];
  const T rho_f = params[3];
  const T big = largest<T>();
  const T vscale = vote_scale<T>(dt, dx, dy);
  const bool dt_bad = !isfinite(dt);
  // a solid's zero map's outputs, at an interior cell and at an edge cell
  // (they differ only there); the post stage's own code on X1e = X2e = 0
  const T zero[9] = {};
  auto zero_post = [&](const Sh& disc, int at) {
    return post_at<T>(zero, zero, 4, 3, at, at, 3, 3, disc, mu_s, kappa,
                      rho_s, rho_f, dx, dy, w_t, clamp, band);
  };
  Post<T> zero_in = zero_post(discs.d[0], 1);
  Post<T> zero_edge = zero_post(discs.d[0], 0);
  // solid s's outputs at cell (j, i): with one solid the 12 outputs; with
  // more its stacks' slices and its terms of the mixture sums (the source
  // note above)
  auto emit = [&](int s, int j, int i, const Post<T>& p) {
    const size_t g = static_cast<size_t>(j) * Nx + i;
    if constexpr (!kMulti) {
      p.store(o, g);
    } else {
      const size_t n = s * N + g;
      o.x1e[n] = p.x1e;
      o.x2e[n] = p.x2e;
      o.phi[n] = p.phi;
      o.sxx[n] = p.sxx;
      o.sxy[n] = p.sxy;
      o.syy[n] = p.syy;
      o.J[n] = p.J;
      // one solid's Hf is its H, and (1 - H) sigma its sb terms
      T h = p.Hf, omh = T(1) - p.Hf, a = p.sbxx, b = p.sbxy, c = p.sbyy;
      if (s > 0) {
        h = o.Hf[g] + h;
        omh = o.rho[g] + omh;
        a = o.sbxx[g] + a;
        b = o.sbxy[g] + b;
        c = o.sbyy[g] + c;
      }
      if (s == S - 1) {
        h = h - static_cast<T>(S - 1);
        omh = h * rho_f + omh * rho_s;  // rho, from the sum of 1 - H_i
      }
      o.Hf[g] = h;
      o.rho[g] = omh;
      o.sbxx[g] = a;
      o.sbxy[g] = b;
      o.sbyy[g] = c;
    }
  };
  const int ntx = static_cast<int>(pyrmt::tiles_for(Nx, tile));
  const int ntiles = static_cast<int>(num_tiles(Ny, Nx, tile));

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Span ys = pyrmt::tile_span((t / ntx) * tile, tile, Ny, halo);
    const Span xs = pyrmt::tile_span((t % ntx) * tile, tile, Nx, halo);
    const Span oy = own(ys), ox = own(xs);
    const Span vy = widen(ys, Ny), vx = widen(xs, Nx);
    // the vote's reach: the final sample's, +-2 for bicubic
    const Span ry = kBicubic ? widen(ys, Ny, 2) : vy;
    const Span rx = kBicubic ? widen(xs, Nx, 2) : vx;

    for (int s = 0; s < (kMulti ? S : 1); ++s) {
      const Sh disc = discs.d[s];
      const T* X1s = X1 + s * N;
      const T* X2s = X2 + s * N;
      if constexpr (kMulti) {
        zero_in = zero_post(disc, 1);
        zero_edge = zero_post(disc, 0);
      }

      // vote over the panel widened by the final sample's reach, keeping
      // u and v over the panel widened by 1 for the backtrace
      bool active = dt_bad;
      for_panel(ry, rx, 0, [&](int lj, int li) {
        const size_t g = static_cast<size_t>(ry.lo + lj) * Nx + (rx.lo + li);
        const T ug = u[g], vg = v[g];
        if constexpr (kBicubic) {
          const int vj = ry.lo + lj - vy.lo, vi = rx.lo + li - vx.lo;
          if (vj >= 0 && vj < vy.size() && vi >= 0 && vi < vx.size()) {
            P.us[vj * (W + 2) + vi] = ug;
            P.vs[vj * (W + 2) + vi] = vg;
          }
        } else {
          P.us[lj * (W + 2) + li] = ug;
          P.vs[lj * (W + 2) + li] = vg;
        }
        const T ph = disc(X1s[g], X2s[g]);
        active |= !(ph > T(0) && ph <= big && fabs(ug) * vscale < big &&
                    fabs(vg) * vscale < big);
      });
      if (!__syncthreads_or(active)) {
        for_panel(oy, ox, 0, [&](int lj, int li) {
          const int j = oy.lo + lj, i = ox.lo + li;
          const bool in = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
          emit(s, j, i, in ? zero_in : zero_edge);
        });
        continue;
      }

      // advect over the whole panel, u and v from the vote's copy
      const Rows<T> ut{P.us, static_cast<size_t>(W + 2), vy.lo, vx.lo};
      const Rows<T> vt{P.vs, static_cast<size_t>(W + 2), vy.lo, vx.lo};
      const Rows<T> x1g{X1s, static_cast<size_t>(Nx), 0, 0};
      const Rows<T> x2g{X2s, static_cast<size_t>(Nx), 0, 0};
      for_panel(ys, xs, 0, [&](int lj, int li) {
        const int j = ys.lo + lj, i = xs.lo + li;
        const size_t g = static_cast<size_t>(j) * Nx + i;
        const size_t l = static_cast<size_t>(lj) * W + li;
        T sx, sy;
        pyrmt::backtrace_at<T>(ut, vt, dt, j, i, Ny, Nx, dx, dy, sx, sy);
        bool known;
        pyrmt::masked_sample<T, kBicubic>(x1g, x2g, sx, sy,
                                          disc(X1s[g], X2s[g]), j, i, Ny, Nx,
                                          P.x1(0)[l], P.x2(0)[l], known, guard);
        P.known(0)[l] = known;
      });
      __syncthreads();

      const size_t e = sweeps<T>(P, ys, xs, L, Ny, Nx, tp, nfront);

      // post, for the tile's own cells
      for_panel(oy, ox, 0, [&](int lj, int li) {
        const int j = oy.lo + lj, i = ox.lo + li;
        emit(s, j, i,
             post_at<T>(P.x1(e), P.x2(e),
                        static_cast<size_t>(j - ys.lo) * W + (i - xs.lo), W,
                        j, i, Ny, Nx, disc, mu_s, kappa, rho_s, rho_f, dx,
                        dy, w_t, clamp, band));
      });
      __syncthreads();  // before the next solid or tile overwrites the panel
    }
  }
}

// Can a cell's inputs reach the split tier's output only as its zero map
// (X1e = X2e = 0 where no solid is near)? Every phis[s] > 0; every map value
// small enough that a sample of them stays finite: at most half the type's
// largest for the bilinear one (its weights sum to 1), a 256th for the
// bicubic one (a Catmull-Rom row of values up to M stays within 12 M, the
// column of rows within 144 M); |u| and |v| below the backtrace's bound.
template <typename T, bool kBicubic>
__device__ bool quiet_at(T ug, T vg, const T* __restrict__ X1s,
                         const T* __restrict__ X2s,
                         const T* __restrict__ phis, size_t g, size_t N,
                         int S, T vscale) {
  const T big = largest<T>();
  const T grow = kBicubic ? T(256) : T(2);
  bool q = (fabs(ug) * vscale < big) & (fabs(vg) * vscale < big);
  for (int s = 0; s < S; ++s) {
    const size_t n = s * N + g;
    q &= (phis[n] > T(0)) & (fabs(X1s[n]) * grow < big) &
         (fabs(X2s[n]) * grow < big);
  }
  return q;
}

// The split tier's pre-pass: flags[fj, fi] = 1 where some cell of the 8x8
// cells (fj, fi) is not quiet_at, else 0 (panel_device.cuh's flag_pass).
template <typename T, bool kBicubic>
__global__ void __launch_bounds__(kFlagTile * kFlag)
    advext_flag_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ X1s, const T* __restrict__ X2s,
                       const T* __restrict__ phis,
                       const T* __restrict__ dt_ptr,
                       unsigned char* __restrict__ flags, int S, int Ny,
                       int Nx, double dx, double dy) {
  const T vscale = vote_scale<T>(*dt_ptr, dx, dy);
  const size_t N = static_cast<size_t>(Ny) * Nx;
  pyrmt::flag_pass<1>(flags, Ny, Nx, [&](size_t g) {
    return quiet_at<T, kBicubic>(u[g], v[g], X1s, X2s, phis, g, N, S, vscale)
               ? 0u
               : 1u;
  });
}

// The split tier's tile kernel (the source note above). flags: the
// pre-pass's; kBicubic: the bicubic final sample.
template <typename T, bool kBicubic>
__global__ void __launch_bounds__(kThreads, 2)
    advext_tile_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ X1s, const T* __restrict__ X2s,
                       const T* __restrict__ phis,
                       const T* __restrict__ dt_ptr,
                       const unsigned char* __restrict__ flags,
                       T* __restrict__ x1e, T* __restrict__ x2e, int S,
                       int Ny, int Nx, double dx, double dy, int L,
                       Guard<T> guard, Taps<T> tp, int tile,
                       unsigned char* ws, size_t panel_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nfront;
  const int halo = 4 * L + 1;
  const Panel<T> P(ws ? ws + blockIdx.x * panel_stride : smem,
                   tile + 2 * halo, true);
  const int W = P.W;
  const size_t N = static_cast<size_t>(Ny) * Nx;
  const T dt = *dt_ptr;
  const bool dt_bad = !isfinite(dt);
  const int ntx = static_cast<int>(pyrmt::tiles_for(Nx, tile));
  const int ntiles = static_cast<int>(num_tiles(Ny, Nx, tile));
  const int tid = threadIdx.y * kBx + threadIdx.x;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Span ys = pyrmt::tile_span((t / ntx) * tile, tile, Ny, halo);
    const Span xs = pyrmt::tile_span((t % ntx) * tile, tile, Nx, halo);
    const Span oy = own(ys), ox = own(xs);
    const Span vy = widen(ys, Ny), vx = widen(xs, Nx);
    // the vote's reach: the final sample's, +-2 for bicubic
    const Span ry = kBicubic ? widen(ys, Ny, 2) : vy;
    const Span rx = kBicubic ? widen(xs, Nx, 2) : vx;

    // vote: the pre-pass's flags over the widened panel
    bool active = dt_bad;
    const int fy0 = ry.lo / kFlag, fx0 = rx.lo / kFlag;
    const int fw = (rx.hi - 1) / kFlag + 1 - fx0;
    const int nf = ((ry.hi - 1) / kFlag + 1 - fy0) * fw;
    for (int f = tid; f < nf; f += kThreads)
      active |= flags[static_cast<size_t>(fy0 + f / fw) * flag_cols(Nx) +
                      fx0 + f % fw] != 0;
    if (!__syncthreads_or(active)) {
      for (int s = 0; s < S; ++s)
        for_panel(oy, ox, 0, [&](int lj, int li) {
          const size_t n =
              s * N + static_cast<size_t>(oy.lo + lj) * Nx + (ox.lo + li);
          x1e[n] = T(0);
          x2e[n] = T(0);
        });
      continue;
    }

    // u and v over the widened panel into shared memory
    for_panel(vy, vx, 0, [&](int lj, int li) {
      const size_t g = static_cast<size_t>(vy.lo + lj) * Nx + (vx.lo + li);
      P.us[lj * (W + 2) + li] = u[g];
      P.vs[lj * (W + 2) + li] = v[g];
    });
    __syncthreads();

    // the masked sample of solid s at panel cell (lj, li) from the
    // backtrace's displacement (sx, sy), into buffer 0
    auto sample = [&](int s, int lj, int li, T sx, T sy) {
      const int j = ys.lo + lj, i = xs.lo + li;
      const size_t l = static_cast<size_t>(lj) * W + li;
      const size_t n = s * N + static_cast<size_t>(j) * Nx + i;
      bool known;
      pyrmt::masked_sample<T, kBicubic>(
          Rows<T>{X1s + s * N, static_cast<size_t>(Nx), 0, 0},
          Rows<T>{X2s + s * N, static_cast<size_t>(Nx), 0, 0}, sx, sy,
          phis[n], j, i, Ny, Nx, P.x1(0)[l], P.x2(0)[l], known, guard);
      P.known(0)[l] = known;
    };
    // the backtrace, once per cell for every solid: with one solid its
    // sample at once; with more the displacement waits in buffer 1, then
    // (the backtraces done) in u and v's place
    const Rows<T> ut{P.us, static_cast<size_t>(W + 2), vy.lo, vx.lo};
    const Rows<T> vt{P.vs, static_cast<size_t>(W + 2), vy.lo, vx.lo};
    for_panel(ys, xs, 0, [&](int lj, int li) {
      T sx, sy;
      pyrmt::backtrace_at<T>(ut, vt, dt, ys.lo + lj, xs.lo + li, Ny, Nx, dx,
                             dy, sx, sy);
      if (S == 1) {
        sample(0, lj, li, sx, sy);
      } else {
        const size_t l = static_cast<size_t>(lj) * W + li;
        P.x1(1)[l] = sx;
        P.x2(1)[l] = sy;
      }
    });
    __syncthreads();
    if (S > 1) {
      for_panel(ys, xs, 0, [&](int lj, int li) {
        const size_t l = static_cast<size_t>(lj) * W + li;
        P.us[l] = P.x1(1)[l];
        P.vs[l] = P.x2(1)[l];
      });
      __syncthreads();
    }
    for (int s = 0; s < S; ++s) {
      if (S > 1) {
        for_panel(ys, xs, 0, [&](int lj, int li) {
          const size_t l = static_cast<size_t>(lj) * W + li;
          sample(s, lj, li, P.us[l], P.vs[l]);
        });
        __syncthreads();
      }
      const size_t e = sweeps<T>(P, ys, xs, L, Ny, Nx, tp, nfront);
      for_panel(oy, ox, 0, [&](int lj, int li) {
        const int j = oy.lo + lj, i = ox.lo + li;
        const size_t l = static_cast<size_t>(j - ys.lo) * W + (i - xs.lo);
        const size_t n = s * N + static_cast<size_t>(j) * Nx + i;
        x1e[n] = P.x1(e)[l];
        x2e[n] = P.x2(e)[l];
      });
      __syncthreads();  // before the next solid or tile overwrites the panel
    }
  }
}

// Both tiers' panels: the tile plus 4L + 1 cells each side (the sweeps'
// 9x9 windows and the advection's +-1 reads), u and v included.
template <typename T>
Plan rmt_plan(int num_layers) {
  return plan<T>(4 * num_layers + 1, true);
}

template <typename T>
long long workspace_bytes(int Ny, int Nx, int num_layers, int sms) {
  return pyrmt::workspace_bytes<T>(Ny, Nx, 4 * num_layers + 1, true, sms);
}

// The fused tier's runtime operands, gathered for one instantiation's
// launch.
template <typename T>
struct Fused {
  const T *u, *v, *X1, *X2, *dt, *params;
  const int* kinds;
  const double* shapes;
  int S;
  Clamp<T> clamp;
  Band<T> band;
  Guard<T> guard;
  Outs<T> o;
  void* ws;
  int Ny, Nx;
  double dx, dy;
  int num_layers;
  double w_t;
  const double* taps;
  int sms;
  void* stream;
};

// A solid's level set from the host's kind and four doubles (x0, y0, then
// R for a disc, a and b for an ellipse).
template <typename T>
void set_shape(Disc<T>& d, int, const double* q) {
  d = Disc<T>{static_cast<T>(q[0]), static_cast<T>(q[1]),
              static_cast<T>(q[2])};
}
template <typename T>
void set_shape(Ellipse<T>& e, int, const double* q) {
  e = Ellipse<T>{static_cast<T>(q[0]), static_cast<T>(q[1]),
                 static_cast<T>(1.0 / q[2]), static_cast<T>(1.0 / q[3])};
}
template <typename T>
void set_shape(Shape<T>& s, int kind, const double* q) {
  s.kind = kind;
  s.x0 = static_cast<T>(q[0]);
  s.y0 = static_cast<T>(q[1]);
  s.p = static_cast<T>(kind == 0 ? q[2] : 1.0 / q[2]);
  s.q = static_cast<T>(kind == 0 ? 0.0 : 1.0 / q[3]);
}

// One instantiation's launch (kMulti: S >= 2; kBicubic: the bicubic final
// sample; Sh: the level sets' type).
template <typename T, bool kMulti, bool kBicubic, typename Sh>
int launch_tiles(const Fused<T>& a) {
  static size_t allowed = 48 * 1024;
  const Plan p = rmt_plan<T>(a.num_layers);
  const size_t smem = p.in_smem ? p.bytes : 0;
  int err = pyrmt::allow_smem(rmt_tile_kernel<T, kMulti, kBicubic, Sh>,
                              smem, allowed);
  if (err) return err;
  Shapes<Sh> shapes{};
  for (int s = 0; s < a.S; ++s)
    set_shape(shapes.d[s], a.kinds[s], a.shapes + 4 * s);
  rmt_tile_kernel<T, kMulti, kBicubic, Sh>
      <<<num_blocks(p, a.Ny, a.Nx, a.sms), dim3(kBx, kBy), smem,
         static_cast<cudaStream_t>(a.stream)>>>(
          a.u, a.v, a.X1, a.X2, a.dt, a.params, shapes, a.S, a.clamp,
          a.band, a.guard, a.o, a.Ny, a.Nx, a.dx, a.dy, a.num_layers, a.w_t,
          pyrmt::load_taps<T>(a.taps), p.tile,
          p.in_smem ? nullptr : static_cast<unsigned char*>(a.ws), p.bytes);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

template <typename T, bool kMulti, typename Sh>
int launch_sampler(const Fused<T>& a, bool bicubic) {
  return bicubic ? launch_tiles<T, kMulti, true, Sh>(a)
                 : launch_tiles<T, kMulti, false, Sh>(a);
}

// kinds: S shape kinds (0 disc, 1 ellipse); shapes: 4 S host doubles, each
// solid's (x0, y0, R, unused) or (x0, y0, a, b); clamp: det G's upper end,
// 0 for no
// clamp, clamp_lo its lower end (1.0 / clamp in double); w_cut: the band
// mode's cut, 0 for the interior mode; bicubic: the final sample, with
// guarded the band guard bicubic where phi0 < guard_thr (-sl_guard); ws:
// workspace_bytes(...) bytes of device memory (unused when 0); sms: the
// card's SM count.
template <typename T>
int launch(const T* u, const T* v, const T* X1, const T* X2, const T* dt,
           const T* params, const Outs<T>& o, void* ws, int S,
           const int* kinds, const double* shapes, int Ny, int Nx, double dx,
           double dy,
           int num_layers, double w_t, double clamp, double clamp_lo,
           double w_cut, int bicubic, int guarded, double guard_thr,
           const double* taps, int sms, void* stream_ptr) {
  if (S < 1 || S > kMaxSolids) return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < S; ++s)
    if (kinds[s] != 0 && kinds[s] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
  Fused<T> a{u, v, X1, X2, dt, params, kinds, shapes, S,
             Clamp<T>{static_cast<T>(clamp_lo), static_cast<T>(clamp),
                      clamp > 0.0},
             Band<T>{static_cast<T>(w_cut), w_cut > 0.0},
             Guard<T>{static_cast<T>(guard_thr), guarded != 0}, o, ws, Ny, Nx,
             dx, dy, num_layers, w_t, taps, sms, stream_ptr};
  bool discs = true;
  for (int s = 0; s < S; ++s) discs &= kinds[s] == 0;
  const bool bc = bicubic != 0;
  if (S > 1)
    return discs ? launch_sampler<T, true, Disc<T>>(a, bc)
                 : launch_sampler<T, true, Shape<T>>(a, bc);
  return discs ? launch_sampler<T, false, Disc<T>>(a, bc)
               : launch_sampler<T, false, Ellipse<T>>(a, bc);
}

// The split tier's device scratch: the skip flags, then the panels'
// workspace (none where a panel fits shared memory).
template <typename T>
long long advext_scratch_bytes(int Ny, int Nx, int num_layers, int sms) {
  return static_cast<long long>(flag_bytes(Ny, Nx)) +
         workspace_bytes<T>(Ny, Nx, num_layers, sms);
}

// Split tier: the pre-pass, then the tile kernel. dt on the device;
// scratch: advext_scratch_bytes(...) bytes; kBicubic: the bicubic final
// sample under guard.
template <typename T, bool kBicubic>
int launch_advext(const T* u, const T* v, const T* X1s, const T* X2s,
                  const T* phis, const T* dt, T* x1e, T* x2e, void* scratch,
                  int S, int Ny, int Nx, double dx, double dy, int num_layers,
                  const Guard<T>& guard, const double* taps, int sms,
                  void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p = rmt_plan<T>(num_layers);
  const size_t smem = p.in_smem ? p.bytes : 0;
  int err = pyrmt::allow_smem(advext_tile_kernel<T, kBicubic>, smem, allowed);
  if (err) return err;
  unsigned char* flags = static_cast<unsigned char*>(scratch);
  unsigned char* ws = flags + flag_bytes(Ny, Nx);
  const dim3 grid(pyrmt::tiles_for(Nx, kFlagTile),
                  pyrmt::tiles_for(Ny, kFlagTile));
  advext_flag_kernel<T, kBicubic><<<grid, dim3(kFlagTile, kFlag), 0, stream>>>(
      u, v, X1s, X2s, phis, dt, flags, S, Ny, Nx, dx, dy);
  PYRMT_RETURN_IF_ERROR();
  advext_tile_kernel<T, kBicubic>
      <<<num_blocks(p, Ny, Nx, sms), dim3(kBx, kBy), smem, stream>>>(
          u, v, X1s, X2s, phis, dt, flags, x1e, x2e, S, Ny, Nx, dx, dy,
          num_layers, guard, pyrmt::load_taps<T>(taps), p.tile,
          p.in_smem ? nullptr : ws, p.bytes);
  PYRMT_RETURN_IF_ERROR();
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
                      T* sbxy, T* sbyy, void* ws, int S, const int* kinds,    \
                      const double* shapes, int Ny, int Nx, double dx,        \
                      double dy, int num_layers,                              \
                      double w_t, double clamp, double clamp_lo,              \
                      double w_cut, int bicubic, int guarded,                 \
                      double guard_thr, const double* taps, int sms,          \
                      void* stream) {                                         \
    const Outs<T> o{x1e, x2e, phi, sxx, sxy, syy, J, Hf, rho, sbxx, sbxy,     \
                    sbyy};                                                    \
    return launch<T>(u, v, X1, X2, dt, params, o, ws, S, kinds, shapes, Ny,  \
                     Nx, dx, dy, num_layers, w_t, clamp, clamp_lo, w_cut,     \
                     bicubic,                                                 \
                     guarded, guard_thr, taps, sms, stream);                  \
  }

PYRMT_RMT_ENTRY(pyrmt_rmt_block_f32, pyrmt_rmt_block_workspace_f32, float)
PYRMT_RMT_ENTRY(pyrmt_rmt_block_f64, pyrmt_rmt_block_workspace_f64, double)

#define PYRMT_ADVEXT_ENTRY(NAME, SCRATCH_NAME, T)                             \
  extern "C" long long SCRATCH_NAME(int Ny, int Nx, int num_layers,           \
                                    int sms) {                                \
    return advext_scratch_bytes<T>(Ny, Nx, num_layers, sms);                  \
  }                                                                           \
  extern "C" int NAME(const T* u, const T* v, const T* X1s, const T* X2s,     \
                      const T* phis, const T* dt, T* x1e, T* x2e,             \
                      void* scratch, int S, int Ny, int Nx, double dx,        \
                      double dy, int num_layers, int bicubic, int guarded,    \
                      double guard_thr, const double* taps, int sms,          \
                      void* stream) {                                         \
    const Guard<T> g{static_cast<T>(guard_thr), guarded != 0};                \
    return bicubic ? launch_advext<T, true>(u, v, X1s, X2s, phis, dt, x1e,    \
                                            x2e, scratch, S, Ny, Nx, dx, dy,  \
                                            num_layers, g, taps, sms, stream) \
                   : launch_advext<T, false>(u, v, X1s, X2s, phis, dt, x1e,   \
                                             x2e, scratch, S, Ny, Nx, dx, dy, \
                                             num_layers, g, taps, sms,        \
                                             stream);                         \
  }

PYRMT_ADVEXT_ENTRY(pyrmt_advext_f32, pyrmt_advext_scratch_f32, float)
PYRMT_ADVEXT_ENTRY(pyrmt_advext_f64, pyrmt_advext_scratch_f64, double)
