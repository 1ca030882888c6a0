// Shared helpers of the pyrmt_tpu_torch CUDA kernels.
//
// Every kernel is a tile kernel (momentum_rk4.cu, momentum_rhs.cu,
// projection_stencils.cu, both entries of rmt_block.cu,
// extrapolate_fused.cu): one block per 2D tile of a row-major (Ny, Nx)
// field, with a halo (Span). Every kernel evaluates its expressions in
// the order of the plain PyTorch version (built with --fmad=false, see
// kernels/_build.py), so the two round alike.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#define PYRMT_RETURN_IF_ERROR()                      \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

namespace pyrmt {

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ inline T clampf(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One axis of a field that may be one shard's slab of a larger grid (the
// domain decomposition of pyrmt_tpu_torch/parallel): its valid cells
// [0, n), the caller's pointers already at the first of them, cell l at
// global index g0 + l of a domain of `total` cells. A slab's rows or
// columns outside the domain (the zero halo beyond an edge shard) are not
// among the valid cells: they are never data. The slab ends at a cut,
// where a neighbour's cells follow that this slab does not hold, unless it
// ends at the domain's edge. A whole field is Axis{n, 0, n}.
struct Axis {
  int n, g0, total;
  __host__ __device__ bool cut_lo() const { return g0 > 0; }
  __host__ __device__ bool cut_hi() const { return g0 + n < total; }
};

// The valid cells of a slab axis of `extent` cells whose cell 0 lies at
// global index `offset` (negative for an edge shard's zero halo) of a
// domain of `total` cells; `first` gets the slab index of the first valid
// cell. n < 1: no valid cell.
inline Axis slab_axis(int extent, int offset, int total, int& first) {
  first = offset < 0 ? -offset : 0;
  const int last = extent < total - offset ? extent : total - offset;
  return Axis{last - first, offset + first, total};
}

// One axis of a tile kernel's tile. The block writes the cells [out_lo,
// out_hi) and computes over the panel [lo, hi): the core [core_lo,
// core_hi), which is the output cells widened to a whole tile where the
// domain's end cuts the tile short, plus `halo` cells on each side,
// clipped to the domain [0, n). Widening the core keeps a short last tile
// as deep in the panel as a whole one: the one-sided closures at the
// domain's edge reach further inward than the interior stencils do.
struct Span {
  int lo, hi, core_lo, core_hi, out_lo, out_hi, n;

  __device__ int size() const { return hi - lo; }
  // the global index of panel index l (a whole field's: lo + l)
  __device__ int global(int l) const { return lo + l; }

  // Panel index l lies in the panel, at least r cells in from each panel
  // edge that is not the domain's edge: a stage whose inputs are valid
  // r - d cells in is valid there when it reads d cells around.
  __device__ bool inside(int l, int r) const {
    return l < hi - lo && (lo == 0 || l >= r) && (hi == n || l < hi - lo - r);
  }
};

// A slab's valid cells (slab_axis) for a launch: the axes and the flat
// offset of the first valid cell in a slab of Ny x Nx cells whose (0, 0)
// is global cell (roff, coff) of an Nyt x Nxt domain.
struct Slab {
  Axis ay, ax;
  size_t first;
};

inline Slab slab(int Ny, int Nx, int roff, int coff, int Nyt, int Nxt) {
  int fy, fx;
  Slab b;
  b.ay = slab_axis(Ny, roff, Nyt, fy);
  b.ax = slab_axis(Nx, coff, Nxt, fx);
  b.first = static_cast<size_t>(fy) * Nx + fx;
  return b;
}

__device__ inline Span tile_span(int t0, int t, int n, int halo) {
  Span s;
  s.n = n;
  s.out_lo = t0;
  s.out_hi = min(t0 + t, n);
  s.core_lo = max(0, min(t0, n - t));
  s.core_hi = min(n, s.core_lo + t);
  s.lo = max(0, s.core_lo - halo);
  s.hi = min(n, s.core_hi + halo);
  return s;
}

// A Span on a slab axis (Axis): indices are the valid cells', panel index
// l is at global index g0 + lo + l, and every edge or interior decision
// takes that. edge_lo, edge_hi: the panel ends there at the domain's edge;
// every other panel end (inside the field, or at the slab's cut) has
// cells beyond it that the panel does not hold.
struct SlabSpan {
  int lo, hi, core_lo, core_hi, out_lo, out_hi, n, g0;
  bool edge_lo, edge_hi;

  __device__ int size() const { return hi - lo; }
  __device__ int global(int l) const { return g0 + lo + l; }
  __device__ bool inside(int l, int r) const {
    return l < hi - lo && (edge_lo || l >= r) && (edge_hi || l < hi - lo - r);
  }
};

// The tile at t0 on a slab axis: Span's panel, clipped to the domain's
// edges and, at a cut, `reach` cells short of it (reach: how far beyond
// the panel a stage reads device memory); its output cells kept `halo`
// cells in from every panel end that is not the domain's edge, so that a
// tile beside a cut writes only the cells it computes from the slab's
// data (the others, the cut's stale cells, stay as the caller left them).
__device__ inline SlabSpan slab_span(int t0, int t, const Axis& a, int halo,
                                     int reach) {
  SlabSpan s;
  s.n = a.n;
  s.g0 = a.g0;
  s.out_lo = t0;
  s.out_hi = min(t0 + t, a.n);
  s.core_lo = max(0, min(t0, a.n - t));
  s.core_hi = min(a.n, s.core_lo + t);
  s.lo = max(a.cut_lo() ? reach : 0, s.core_lo - halo);
  s.hi = min(a.cut_hi() ? a.n - reach : a.n, s.core_hi + halo);
  s.edge_lo = s.lo == 0 && !a.cut_lo();
  s.edge_hi = s.hi == a.n && !a.cut_hi();
  if (!s.edge_lo) s.out_lo = max(s.out_lo, s.lo + halo);
  if (!s.edge_hi) s.out_hi = min(s.out_hi, s.hi - halo);
  return s;
}

// The span type of a tile kernel's instantiation: kSlab, a shard's slab
// (SlabSpan); else a whole field (Span: the code of a kernel without
// offsets, whose instantiation stays as it was), and its tile.
template <bool kSlab>
using SpanOf = typename std::conditional<kSlab, SlabSpan, Span>::type;

template <bool kSlab>
__device__ inline SpanOf<kSlab> span_of(int t0, int t, const Axis& a,
                                        int halo, int reach) {
  if constexpr (kSlab)
    return slab_span(t0, t, a, halo, reach);
  else
    return tile_span(t0, t, a.n, halo);
}

__host__ __device__ inline unsigned tiles_for(int n, int t) {
  return static_cast<unsigned>((n + t - 1) / t);
}

// Raise a kernel's limit of dynamic shared memory to `bytes` (needed above
// 48 KB) once per kernel; returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed = bytes;
  return 0;
}

// phi = |x - (x0, y0)| - R: the Disc shape of ops/levelset.py
template <typename T>
struct Disc {
  T x0, y0, R;
  __device__ T operator()(T x1, T x2) const {
    T ex = x1 - x0;
    T ey = x2 - y0;
    return sqrt(ex * ex + ey * ey) - R;
  }
};

// The quasi signed distance of ops/levelset.py's Ellipse, its operations in
// its order: (r - 1) / (|(fx / a, fy / b)| / r + 1e-12), r = |(fx, fy)|
// with 1e-30 under the root, fx = (x - x0) / a, fy = (y - y0) / b, each
// division by a semi-axis a product by inv_a = 1.0 / a (in double, rounded
// to T once, as PyTorch rounds the Python scalar).
template <typename T>
struct Ellipse {
  T x0, y0, inv_a, inv_b;
  __device__ T operator()(T x1, T x2) const {
    const T fx = (x1 - x0) * inv_a;
    const T fy = (x2 - y0) * inv_b;
    const T r = sqrt(fx * fx + fy * fy + static_cast<T>(1e-30));
    const T f = r - T(1);
    const T ga = fx * inv_a;
    const T gb = fy * inv_b;
    const T grad = sqrt(ga * ga + gb * gb) / r + static_cast<T>(1e-12);
    return f / grad;
  }
};

// A solid's level set chosen at run time (kernels/rmt_block.py SHAPES):
// kind 0 a Disc (p = R), 1 an Ellipse (p = inv_a, q = inv_b).
template <typename T>
struct Shape {
  int kind;
  T x0, y0, p, q;
  __device__ T operator()(T x1, T x2) const {
    return kind == 0 ? Disc<T>{x0, y0, p}(x1, x2)
                     : Ellipse<T>{x0, y0, p, q}(x1, x2);
  }
};

}  // namespace pyrmt

extern "C" const char* pyrmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
