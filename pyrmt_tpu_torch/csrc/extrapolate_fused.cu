// The whole narrow-band extrapolation of one reference map, on Hopper:
// max_layers layer-synchronous Gaussian least-squares sweeps from the
// known cells (phi < 0) outward, as a flag pre-pass and one tile kernel.
//
// Replaces: pyrmt_tpu/kernels/extrapolate_fused.py::
// extrapolate_reference_map_fused (the pl.pallas_call at
// extrapolate_fused.py:202). The plain version is
// pyrmt_tpu_torch.ops.extrapolate.extrapolate_reference_map.
//
// What bounds it on the H100: bytes. The work is 3 fields read (X1, X2,
// phi) and 2 written (X1e, X2e) per cell; the 9x9 window sums and the
// Cramer solve run only on the frontier, a ring a few cells wide around the
// solid. A cell changes only as a frontier cell: unknown, with a known cell
// within L cells (Chebyshev) of it, since the known set grows by one ring a
// sweep. So most tiles only copy, and the design (panel_device.cuh's
// panels, tiles, sweeps and skip flags, shared with rmt_block.cu's split
// tier):
//   flags    extrap_flag_kernel, one block per 32 x 32 cells: a byte per
//            8 x 8 cells, bit 0 set where one of them is known (phi < 0),
//            bit 1 where one is not (NaN included); phi read once
//   own      each thread of the tile kernel reads its cells of the tile's
//            X1, X2 into registers, ahead of the vote
//   vote     is a flag of the tile's own cells unknown, and one of the tile
//            widened by L (at most 6 x 6 flags at L = 3) known?
//            __syncthreads_or over the block
//   copy     if not, no cell of the tile can change: the tile writes X1, X2
//            from its registers, the plain result bit for bit for any X,
//            NaN and infinities included
//   sweeps   else X1, X2 and the known flags of the tile plus 4L cells each
//            side into shared memory (each sweep reads a 9x9 window, so
//            after L sweeps the tile is exact; outside the domain the
//            panel is clipped and layer_at reads zero, as the plain
//            version's window does), the L sweeps in place (the frontier
//            listed, then solved by consecutive threads), the tile's own
//            cells of the last state written
// The pre-pass replaced a vote inside the tile kernel that read phi over
// the tile widened by L: at N=4096 that was slower, at N=1024 level
// (PERF.md). The copies then move the bound's bytes; the few tiles at the
// solid, latency-bound in the sweeps, take the rest of the time.
// Tile: 32 x 32 where the panel fits a block's shared memory, else 16 x 16
// or 8 x 8; 512 threads. The panel holds no u, v: 4 W^2 sizeof(T) + 6 W^2
// bytes, 69,120 B at L = 3 in float32 (W = 56; two blocks per SM, held
// there by registers), 119,296 B in float64 (one). Where no tile fits
// (L >= 12 in float32, L >= 9 in float64) the panels live in a
// device-memory workspace after the flags, so every max_layers runs; with
// max_layers = 0 every tile copies.
//
// The sharding offsets (the domain decomposition of
// pyrmt_tpu_torch/parallel; the semantics of rmt_block.cu's): the inputs
// are one shard's slab, element (0, 0) at global (roff, coff), possibly
// negative, of an Nyt x Nxt domain. The launcher runs the pre-pass and the
// tiles over the slab's valid cells (common.cuh's slab_axis: the zero halo
// beyond the domain is never read); in the kSlab instantiation (SlabSpan)
// the interior predicate and the window's zero taps take the global index
// and the domain's extents, so a cell beside a cut is interior and its
// window reads the slab's cells there. A tile writes only the cells 4L or
// more in from a cut (the sweeps read 4 cells a layer): the cut's stale
// cells stay as the wrapper left them (0, as the plain twin leaves them).
// The vote reads the flags of the valid cells; an output cell 4L from a
// cut widened by L stays inside them, so the copy stays exact. A whole
// field (0, 0, Ny, Nx) takes the instantiation without kSlab, whose code
// is the kernel's without offsets.
//
// Built with --fmad=false: the sums and the solve round as in the plain
// PyTorch version, so the two agree bit for bit (chip_smoke.py).
#include "panel_device.cuh"

namespace {

using pyrmt::Axis;
using pyrmt::flag_bytes;
using pyrmt::flag_cols;
using pyrmt::kBx;
using pyrmt::kBy;
using pyrmt::kFlag;
using pyrmt::kFlagTile;
using pyrmt::kThreads;
using pyrmt::Panel;
using pyrmt::Plan;
using pyrmt::Slab;
using pyrmt::SpanOf;
using pyrmt::Taps;

constexpr int kOwn = pyrmt::kMaxTile * pyrmt::kMaxTile / kThreads;  // cells

// The pre-pass: flags[fj, fi] = (some cell of the 8x8 cells (fj, fi)
// known) | (some cell not known) << 1 (panel_device.cuh's flag_pass), over
// ny x nx cells whose rows are `stride` apart.
template <typename T>
__global__ void __launch_bounds__(kFlagTile * kFlag)
    extrap_flag_kernel(const T* __restrict__ phi,
                       unsigned char* __restrict__ flags, int ny, int nx,
                       int stride) {
  pyrmt::flag_pass<2>(flags, ny, nx, stride,
                      [&](size_t g) { return phi[g] < T(0) ? 1u : 2u; });
}

// The tile kernel (the source note above). flags: the pre-pass's; Ny, Nx:
// the slab's extents (a row is Nx apart); ay, ax: its valid cells, the
// pointers at the first of them (kSlab; without it the whole field).
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads, 2)
    extrap_tile_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
                       const T* __restrict__ phi,
                       const unsigned char* __restrict__ flags,
                       T* __restrict__ x1e, T* __restrict__ x2e, int Ny,
                       int Nx, Axis ay, Axis ax, int L, Taps<T> tp, int tile,
                       unsigned char* ws, size_t panel_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nfront;
  const int halo = 4 * L;
  const Panel<T> P(ws ? ws + blockIdx.x * panel_stride : smem,
                   tile + 2 * halo, false);
  const int W = P.W;
  // ny, nx: the valid cells; NyT, NxT: the domain's extents
  const int ny = kSlab ? ay.n : Ny, nx = kSlab ? ax.n : Nx;
  const int NyT = kSlab ? ay.total : Ny, NxT = kSlab ? ax.total : Nx;
  const Axis yax = kSlab ? ay : Axis{Ny, 0, Ny};
  const Axis xax = kSlab ? ax : Axis{Nx, 0, Nx};
  const int ntx = static_cast<int>(pyrmt::tiles_for(nx, tile));
  const int ntiles = static_cast<int>(pyrmt::num_tiles(ny, nx, tile));
  const int tid = threadIdx.y * kBx + threadIdx.x;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    using Sp = SpanOf<kSlab>;
    // the sweeps read no cell beyond the panel: no reach to keep from a cut
    const Sp ys = pyrmt::span_of<kSlab>((t / ntx) * tile, tile, yax, halo, 0);
    const Sp xs = pyrmt::span_of<kSlab>((t % ntx) * tile, tile, xax, halo, 0);
    const Sp oy = pyrmt::own(ys), ox = pyrmt::own(xs);
    // a slab's tile within 4L of a cut may own no cell (a uniform skip)
    if (kSlab && (oy.size() <= 0 || ox.size() <= 0)) continue;
    const int ow = ox.size(), n_own = oy.size() * ow;

    // own: the thread's cells of the tile, q = tid + r * kThreads
    T a1[kOwn], a2[kOwn];
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const int q = tid + r * kThreads;
      if (q < n_own) {
        const size_t g =
            static_cast<size_t>(oy.lo + q / ow) * Nx + (ox.lo + q % ow);
        a1[r] = X1[g];
        a2[r] = X2[g];
      }
    }

    // vote: the flags of the tile widened by L (own tiles start at a
    // multiple of 8 cells, so their flags hold their own cells only; beside
    // a cut a few more, and the vote errs towards the sweeps, which are
    // exact)
    const int fy = max(0, oy.lo - L) / kFlag, fx = max(0, ox.lo - L) / kFlag;
    const int fh = (min(ny, oy.hi + L) - 1) / kFlag + 1 - fy;
    const int fw = (min(nx, ox.hi + L) - 1) / kFlag + 1 - fx;
    bool unknown = false, known = false;
    for (int q = tid; q < fh * fw; q += kThreads) {
      const int fj = fy + q / fw, fi = fx + q % fw;
      const unsigned b = flags[static_cast<size_t>(fj) * flag_cols(nx) + fi];
      known |= (b & 1u) != 0;
      unknown |= (b & 2u) != 0 && fj >= oy.lo / kFlag &&
                 fj <= (oy.hi - 1) / kFlag && fi >= ox.lo / kFlag &&
                 fi <= (ox.hi - 1) / kFlag;
    }
    const bool any_unknown = __syncthreads_or(unknown);
    const bool any_known = __syncthreads_or(known);

    if (L == 0 || !any_unknown || !any_known) {  // copy
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const int q = tid + r * kThreads;
        if (q < n_own) {
          const size_t g =
              static_cast<size_t>(oy.lo + q / ow) * Nx + (ox.lo + q % ow);
          x1e[g] = a1[r];
          x2e[g] = a2[r];
        }
      }
      continue;
    }

    // sweeps, on the tile plus 4L cells each side
    pyrmt::for_panel(ys, xs, 0, [&](int lj, int li) {
      const size_t g = static_cast<size_t>(ys.lo + lj) * Nx + (xs.lo + li);
      const size_t l = static_cast<size_t>(lj) * W + li;
      P.x1(0)[l] = X1[g];
      P.x2(0)[l] = X2[g];
      P.known(0)[l] = phi[g] < T(0);
    });
    __syncthreads();
    const size_t e = pyrmt::sweeps<T>(P, ys, xs, L, NyT, NxT, tp, nfront);
    pyrmt::for_panel(oy, ox, 0, [&](int lj, int li) {
      const int j = oy.lo + lj, i = ox.lo + li;
      const size_t l = static_cast<size_t>(j - ys.lo) * W + (i - xs.lo);
      const size_t g = static_cast<size_t>(j) * Nx + i;
      x1e[g] = P.x1(e)[l];
      x2e[g] = P.x2(e)[l];
    });
    __syncthreads();  // before the next tile overwrites the panel
  }
}

// The device scratch: the skip flags, then the panels' workspace (none
// where a panel fits shared memory). The panels: the tile plus 4L cells
// each side (the sweeps' 9x9 windows), no u, v.
template <typename T>
long long scratch_bytes(int Ny, int Nx, int max_layers, int sms) {
  return static_cast<long long>(flag_bytes(Ny, Nx)) +
         pyrmt::workspace_bytes<T>(Ny, Nx, 4 * max_layers, false, sms);
}

// The pre-pass, then the tile kernel, over the slab's valid cells (a
// whole field's: all of them). scratch: scratch_bytes(...) bytes of device
// memory; sms: the card's SM count.
template <typename T, bool kSlab>
int launch_tiles(const T* X1, const T* X2, const T* phi, T* x1e, T* x2e,
                 void* scratch, int Ny, int Nx, const Slab& b, int max_layers,
                 const double* taps, int sms, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p = pyrmt::plan<T>(4 * max_layers, false);
  const size_t smem = p.in_smem ? p.bytes : 0;
  int err = pyrmt::allow_smem(extrap_tile_kernel<T, kSlab>, smem, allowed);
  if (err) return err;
  const size_t f = b.first;
  const int ny = b.ay.n, nx = b.ax.n;
  unsigned char* flags = static_cast<unsigned char*>(scratch);
  const dim3 grid(pyrmt::tiles_for(nx, kFlagTile),
                  pyrmt::tiles_for(ny, kFlagTile));
  extrap_flag_kernel<T><<<grid, dim3(kFlagTile, kFlag), 0, stream>>>(
      phi + f, flags, ny, nx, Nx);
  PYRMT_RETURN_IF_ERROR();
  extrap_tile_kernel<T, kSlab>
      <<<pyrmt::num_blocks(p, ny, nx, sms), dim3(kBx, kBy), smem, stream>>>(
          X1 + f, X2 + f, phi + f, flags, x1e + f, x2e + f, Ny, Nx, b.ay,
          b.ax, max_layers, pyrmt::load_taps<T>(taps), p.tile,
          p.in_smem ? nullptr : flags + flag_bytes(Ny, Nx), p.bytes);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

// Ny, Nx: the slab's extents; roff, coff: the global (row, column) of its
// element (0, 0), negative for an edge shard's zero halo; Nyt, Nxt: the
// domain's extents (a whole field: 0, 0, Ny, Nx). The slab must hold a
// valid cell. Outputs are written at the valid cells 4 max_layers or more
// in from each cut (every valid cell without a cut).
template <typename T>
int launch(const T* X1, const T* X2, const T* phi, T* x1e, T* x2e,
           void* scratch, int Ny, int Nx, int roff, int coff, int Nyt,
           int Nxt, int max_layers, const double* taps, int sms,
           void* stream) {
  const Slab b = pyrmt::slab(Ny, Nx, roff, coff, Nyt, Nxt);
  if (b.ay.n < 1 || b.ax.n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool slab = roff != 0 || coff != 0 || Nyt != Ny || Nxt != Nx;
  return (slab ? launch_tiles<T, true> : launch_tiles<T, false>)(
      X1, X2, phi, x1e, x2e, scratch, Ny, Nx, b, max_layers, taps, sms,
      stream);
}

}  // namespace

#define PYRMT_EXTRAP_ENTRY(NAME, SCRATCH_NAME, T)                             \
  extern "C" long long SCRATCH_NAME(int Ny, int Nx, int max_layers,           \
                                    int sms) {                                \
    return scratch_bytes<T>(Ny, Nx, max_layers, sms);                         \
  }                                                                           \
  extern "C" int NAME(const T* X1, const T* X2, const T* phi, T* x1e,         \
                      T* x2e, void* scratch, int Ny, int Nx, int roff,        \
                      int coff, int Nyt, int Nxt, int max_layers,             \
                      const double* taps, int sms, void* stream) {            \
    return launch<T>(X1, X2, phi, x1e, x2e, scratch, Ny, Nx, roff, coff, Nyt, \
                     Nxt, max_layers, taps, sms, stream);                     \
  }

PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f32,
                   pyrmt_extrapolate_fused_scratch_f32, float)
PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f64,
                   pyrmt_extrapolate_fused_scratch_f64, double)
