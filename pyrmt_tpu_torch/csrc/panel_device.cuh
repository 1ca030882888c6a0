// The panels and layer sweeps of the reference-map tile kernels, shared by
// rmt_block.cu (the fused tier and the split tier's advect-extrapolate
// block) and extrapolate_fused.cu (the standalone extrapolation):
//   Panel, panel_bytes  a block's state (X1, X2, known) in two buffers for
//                       the sweeps' ping-pong, u and v where the kernel
//                       advects, and a list of frontier cells
//   plan, num_blocks, workspace_bytes
//                       the tile (32, 16 or 8 cells a side) whose panel fits
//                       a block's shared memory; where none does, panels in
//                       a device-memory workspace, one per resident block,
//                       the blocks walking over the tiles
//   for_panel           a function over the cells of a panel, r cells in
//   sweeps              L layer sweeps of a panel, the frontier cells listed
//                       and then solved by consecutive threads
//   flag_cols, flag_bytes, flag_pass
//                       the skip flags of a flag pre-pass, a byte per 8x8
//                       cells, 32x32 cells a pre-pass block
// A tile kernel runs kBx x kBy threads a block.
#pragma once

#include "rmt_device.cuh"

namespace pyrmt {

constexpr int kBx = 32, kBy = 16;  // threads of a block: columns x rows
constexpr int kThreads = kBx * kBy;
constexpr int kMaxTile = 32;         // cells along a tile's side, at most
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's most on sm_90
constexpr int kFlag = 8;       // skip flags: one per 8x8 cells
constexpr int kFlagTile = 32;  // cells per side of a pre-pass block

// Bytes of a panel `width` cells square: two (X1, X2) buffers, with uv u
// and v on the panel widened by 1, two known-flag buffers (bytes) and a
// list of frontier cells (panel indices); rounded up so that workspace
// panels stay aligned.
template <typename T>
size_t panel_bytes(int width, bool uv) {
  const size_t n = static_cast<size_t>(width) * width;
  const size_t nv = uv ? static_cast<size_t>(width + 2) * (width + 2) : 0;
  return ((4 * n + 2 * nv) * sizeof(T) + (2 + sizeof(int)) * n + 4 + 255) /
         256 * 256;
}

// A block's panel buffers, laid out as panel_bytes counts them: [X1 X1' X2
// X2' (u v) known known' frontier list], the state in two buffers for the
// sweeps' ping-pong.
template <typename T>
struct Panel {
  int W;           // the row stride of the state buffers: the panel's width
  size_t NP, NV;   // cells of a state buffer and of u, v (0 without them)
  T* base;
  T* us;
  T* vs;
  unsigned char* kbase;
  int* flist;

  __device__ Panel(unsigned char* mem, int width, bool uv)
      : W(width),
        NP(static_cast<size_t>(width) * width),
        NV(uv ? static_cast<size_t>(width + 2) * (width + 2) : 0) {
    base = reinterpret_cast<T*>(mem);
    us = base + 4 * NP;
    vs = us + NV;
    kbase = reinterpret_cast<unsigned char*>(vs + NV);
    flist = reinterpret_cast<int*>(
        kbase + (2 * NP + sizeof(int) - 1) / sizeof(int) * sizeof(int));
  }
  __device__ T* x1(size_t b) const { return base + b * NP; }
  __device__ T* x2(size_t b) const { return base + (2 + b) * NP; }
  __device__ unsigned char* known(size_t b) const { return kbase + b * NP; }
};

// The tile and where its panels live.
struct Plan {
  int tile;
  size_t bytes;  // one panel
  bool in_smem;
};

// The panel of a tile plus `halo` cells each side, with or without u, v.
template <typename T>
Plan plan(int halo, bool uv) {
  const int tiles[] = {kMaxTile, kMaxTile / 2, kMaxTile / 4};
  for (int tile : tiles) {
    const size_t b = panel_bytes<T>(tile + 2 * halo, uv);
    if (b <= kMaxSmem) return {tile, b, true};
  }
  return {tiles[0], panel_bytes<T>(tiles[0] + 2 * halo, uv), false};
}

__host__ __device__ inline unsigned num_tiles(int Ny, int Nx, int tile) {
  return tiles_for(Ny, tile) * tiles_for(Nx, tile);
}

// Blocks of a launch: one per tile, or with the panels in a workspace two
// per SM (sms of them), each walking over the tiles.
inline unsigned num_blocks(const Plan& p, int Ny, int Nx, int sms) {
  const unsigned n = num_tiles(Ny, Nx, p.tile);
  const unsigned resident = 2u * static_cast<unsigned>(sms);
  return p.in_smem || n < resident ? n : resident;
}

// Bytes of device memory for the panels (0 where a panel fits a block).
template <typename T>
long long workspace_bytes(int Ny, int Nx, int halo, bool uv, int sms) {
  const Plan p = plan<T>(halo, uv);
  if (p.in_smem) return 0;
  return static_cast<long long>(num_blocks(p, Ny, Nx, sms)) *
         static_cast<long long>(p.bytes);
}

__host__ __device__ inline unsigned flag_cols(int Nx) {
  return tiles_for(Nx, kFlag);
}

// Bytes of the skip flags, rounded up so that a workspace after them stays
// aligned.
inline size_t flag_bytes(int Ny, int Nx) {
  return (static_cast<size_t>(tiles_for(Ny, kFlag)) * flag_cols(Nx) + 255) /
         256 * 256;
}

// The body of a flag pre-pass: flags[fj, fi] = the OR of bits_at(g) (kBits
// bits) over the 8x8 cells (fj, fi) of an Ny x Nx field whose rows are
// `stride` apart, g = j * stride + i. One block of kFlagTile x kFlag
// threads per 32 x 32 cells (4 x 4 flags); each thread reads one cell in
// each of 4 rows.
template <int kBits, typename F>
__device__ __forceinline__ void flag_pass(unsigned char* __restrict__ flags,
                                          int Ny, int Nx, size_t stride,
                                          F&& bits_at) {
  constexpr int kPer = kFlagTile / kFlag;  // flags along a block's side
  __shared__ unsigned bits;                // kBits bits a flag
  const int tid = threadIdx.y * kFlagTile + threadIdx.x;
  if (tid == 0) bits = 0;
  __syncthreads();
  const int i = blockIdx.x * kFlagTile + threadIdx.x;
  unsigned mine = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = blockIdx.y * kFlagTile + r * kFlag + threadIdx.y;
    if (i < Nx && j < Ny)
      mine |= bits_at(static_cast<size_t>(j) * stride + i)
              << (kBits * (r * kPer + threadIdx.x / kFlag));
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (threadIdx.x == 0 && mine) atomicOr(&bits, mine);
  __syncthreads();
  if (tid < kPer * kPer) {
    const unsigned fj = blockIdx.y * kPer + tid / kPer;
    const unsigned fi = blockIdx.x * kPer + tid % kPer;
    if (fj < tiles_for(Ny, kFlag) && fi < flag_cols(Nx))
      flags[static_cast<size_t>(fj) * flag_cols(Nx) + fi] =
          (bits >> (kBits * tid)) & ((1u << kBits) - 1u);
  }
}

// The tile's own cells [out_lo, out_hi) of an axis, as a span of its own
// (a Span or a SlabSpan).
template <typename S>
__device__ inline S own(S s) {
  s.lo = s.out_lo;
  s.hi = s.out_hi;
  return s;
}

// f(lj, li) for each cell of a ph x pw panel, r cells in from its inner
// edges: warps along the rows, kBy rows at a time.
template <typename S, typename F>
__device__ __forceinline__ void for_panel(const S& ys, const S& xs, int r,
                                          F&& f) {
  const int ph = ys.size(), pw = xs.size();
  for (int lj = threadIdx.y; lj < ph; lj += kBy) {
    if (!ys.inside(lj, r)) continue;
    for (int li = threadIdx.x; li < pw; li += kBx)
      if (xs.inside(li, r)) f(lj, li);
  }
}

// The L layer sweeps from the state in buffer 0, each 4 cells further in:
// the cells off the frontier keep their state, the frontier cells (a thin
// ring) are listed and then solved by consecutive threads (one lane per
// warp doing a 9x9 window sum wasted the other 31). Returns the buffer
// that holds the last sweep's state, valid 4L cells in from the panel's
// inner edges. Ny, Nx: the domain's extents (the spans' global indices
// choose the domain's edge). nfront: an int in shared memory.
template <typename T, typename S>
__device__ size_t sweeps(const Panel<T>& P, const S& ys, const S& xs, int L,
                         int Ny, int Nx, const Taps<T>& tp, int& nfront) {
  for (int layer = 1; layer <= L; ++layer) {
    const size_t src = (layer - 1) & 1, dst = layer & 1;
    const T* x1s = P.x1(src);
    const T* x2s = P.x2(src);
    const unsigned char* ks = P.known(src);
    if (threadIdx.x == 0 && threadIdx.y == 0) nfront = 0;
    __syncthreads();
    for_panel(ys, xs, 4 * layer, [&](int lj, int li) {
      const size_t l = static_cast<size_t>(lj) * P.W + li;
      if (frontier_at<T>(ks, l, P.W, ys.global(lj), xs.global(li), Ny,
                         Nx)) {
        P.flist[atomicAdd(&nfront, 1)] = static_cast<int>(l);
      } else {
        P.x1(dst)[l] = x1s[l];
        P.x2(dst)[l] = x2s[l];
        P.known(dst)[l] = ks[l];
      }
    });
    __syncthreads();
    for (int f = threadIdx.y * kBx + threadIdx.x; f < nfront;
         f += kThreads) {
      const int l = P.flist[f], lj = l / P.W, li = l - lj * P.W;
      T x1, x2, k;
      layer_at<T>(x1s, x2s, ks, l, P.W, ys.global(lj), xs.global(li), Ny,
                  Nx, tp, x1, x2, k);
      P.x1(dst)[l] = x1;
      P.x2(dst)[l] = x2;
      P.known(dst)[l] = k > T(0);
    }
    __syncthreads();
  }
  return L & 1;
}

}  // namespace pyrmt
