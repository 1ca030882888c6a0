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
// Built with --fmad=false: the sums and the solve round as in the plain
// PyTorch version, so the two agree bit for bit (chip_smoke.py).
#include "panel_device.cuh"

namespace {

using pyrmt::flag_bytes;
using pyrmt::flag_cols;
using pyrmt::kBx;
using pyrmt::kBy;
using pyrmt::kFlag;
using pyrmt::kFlagTile;
using pyrmt::kThreads;
using pyrmt::Panel;
using pyrmt::Plan;
using pyrmt::Span;
using pyrmt::Taps;

constexpr int kOwn = pyrmt::kMaxTile * pyrmt::kMaxTile / kThreads;  // cells

// The pre-pass: flags[fj, fi] = (some cell of the 8x8 cells (fj, fi)
// known) | (some cell not known) << 1 (panel_device.cuh's flag_pass).
template <typename T>
__global__ void __launch_bounds__(kFlagTile * kFlag)
    extrap_flag_kernel(const T* __restrict__ phi,
                       unsigned char* __restrict__ flags, int Ny, int Nx) {
  pyrmt::flag_pass<2>(flags, Ny, Nx, Nx,
                      [&](size_t g) { return phi[g] < T(0) ? 1u : 2u; });
}

// The tile kernel (the source note above). flags: the pre-pass's.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    extrap_tile_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
                       const T* __restrict__ phi,
                       const unsigned char* __restrict__ flags,
                       T* __restrict__ x1e, T* __restrict__ x2e, int Ny,
                       int Nx, int L, Taps<T> tp, int tile, unsigned char* ws,
                       size_t panel_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nfront;
  const int halo = 4 * L;
  const Panel<T> P(ws ? ws + blockIdx.x * panel_stride : smem,
                   tile + 2 * halo, false);
  const int W = P.W;
  const int ntx = static_cast<int>(pyrmt::tiles_for(Nx, tile));
  const int ntiles = static_cast<int>(pyrmt::num_tiles(Ny, Nx, tile));
  const int tid = threadIdx.y * kBx + threadIdx.x;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Span ys = pyrmt::tile_span((t / ntx) * tile, tile, Ny, halo);
    const Span xs = pyrmt::tile_span((t % ntx) * tile, tile, Nx, halo);
    const Span oy = pyrmt::own(ys), ox = pyrmt::own(xs);
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
    // multiple of 8 cells, so their flags hold their own cells only)
    const int fy = max(0, oy.lo - L) / kFlag, fx = max(0, ox.lo - L) / kFlag;
    const int fh = (min(Ny, oy.hi + L) - 1) / kFlag + 1 - fy;
    const int fw = (min(Nx, ox.hi + L) - 1) / kFlag + 1 - fx;
    bool unknown = false, known = false;
    for (int q = tid; q < fh * fw; q += kThreads) {
      const int fj = fy + q / fw, fi = fx + q % fw;
      const unsigned b = flags[static_cast<size_t>(fj) * flag_cols(Nx) + fi];
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
    const size_t e = pyrmt::sweeps<T>(P, ys, xs, L, Ny, Nx, tp, nfront);
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

// The pre-pass, then the tile kernel. scratch: scratch_bytes(...) bytes of
// device memory; sms: the card's SM count.
template <typename T>
int launch(const T* X1, const T* X2, const T* phi, T* x1e, T* x2e,
           void* scratch, int Ny, int Nx, int max_layers, const double* taps,
           int sms, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p = pyrmt::plan<T>(4 * max_layers, false);
  const size_t smem = p.in_smem ? p.bytes : 0;
  int err = pyrmt::allow_smem(extrap_tile_kernel<T>, smem, allowed);
  if (err) return err;
  unsigned char* flags = static_cast<unsigned char*>(scratch);
  const dim3 grid(pyrmt::tiles_for(Nx, kFlagTile),
                  pyrmt::tiles_for(Ny, kFlagTile));
  extrap_flag_kernel<T><<<grid, dim3(kFlagTile, kFlag), 0, stream>>>(
      phi, flags, Ny, Nx);
  PYRMT_RETURN_IF_ERROR();
  extrap_tile_kernel<T><<<pyrmt::num_blocks(p, Ny, Nx, sms), dim3(kBx, kBy),
                          smem, stream>>>(
      X1, X2, phi, flags, x1e, x2e, Ny, Nx, max_layers,
      pyrmt::load_taps<T>(taps), p.tile,
      p.in_smem ? nullptr : flags + flag_bytes(Ny, Nx), p.bytes);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_EXTRAP_ENTRY(NAME, SCRATCH_NAME, T)                             \
  extern "C" long long SCRATCH_NAME(int Ny, int Nx, int max_layers,           \
                                    int sms) {                                \
    return scratch_bytes<T>(Ny, Nx, max_layers, sms);                         \
  }                                                                           \
  extern "C" int NAME(const T* X1, const T* X2, const T* phi, T* x1e,         \
                      T* x2e, void* scratch, int Ny, int Nx, int max_layers,  \
                      const double* taps, int sms, void* stream) {            \
    return launch<T>(X1, X2, phi, x1e, x2e, scratch, Ny, Nx, max_layers,      \
                     taps, sms, stream);                                      \
  }

PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f32,
                   pyrmt_extrapolate_fused_scratch_f32, float)
PYRMT_EXTRAP_ENTRY(pyrmt_extrapolate_fused_f64,
                   pyrmt_extrapolate_fused_scratch_f64, double)
