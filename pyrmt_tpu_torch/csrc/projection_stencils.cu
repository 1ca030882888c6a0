// The projection's two stencil passes around the DCT solve, on Hopper.
//
// Replaces: pyrmt_tpu/kernels/projection_stencils.py::rc_rhs_pallas (the
// pl.pallas_call at projection_stencils.py:185) and ::grad_correct_pallas
// (the pl.pallas_call at projection_stencils.py:218), which
// projection_method='pallas' runs. The plain versions are rc_rhs_plain and
// grad_correct_plain of pyrmt_tpu_torch/kernels/projection_stencils.py,
// composed from ops/poisson.py and the BC.
//
//   rc_rhs_kernel        rhs = rho div(u_face) / dt with Rhie-Chow face
//                        velocities 0.5 (a + a+) - d ((p+ - p) / dx
//                        - 0.5 (g + g+)), g the cell-centred gradient of p,
//                        d = dt / mean(rho); 0 on the boundary ring
//   grad_correct_kernel  a - (dt / rho) grad p_corr (one-sided at the walls,
//                        the tangential component 0 on the boundary ring),
//                        then the velocity BC from the spec
//
// One launch each, one block of 256 threads per 64 x 32 tile of output
// cells. The block copies its panels from device memory into shared memory
// with cp.async (16 bytes a copy where the rows and the fields start at
// 16-byte boundaries, as at N=1024 and 4096; an element a copy on other
// grids, such as the tests' 203x301), waits once, and then each thread
// computes one column over a run of 8 rows from shared memory alone.
//   rc_rhs: p over the tile's rows and 2 more on each side, a over its
//   rows, both with 4 padding columns each side (the x stencils read 2 and
//   1); b over the rows and 1 more each side; rho over the tile: 1.11x the
//   tile's cells of the 4 fields, 36.5 KB in float32. Down its run a thread
//   carries the cell-centred dp/dy and the y face in registers, so each is
//   computed once but for one extra face at the top of each run; it
//   computes both x faces of its cell, so each x face twice (passing the
//   face to the neighbour by a warp shuffle instead, with lane 0 and lane
//   31 computing the warp seams' faces, measured slower at N=1024 and no
//   faster at 4096, PERF.md).
//   grad_correct: p_corr over the rows and 1 more each side, padded; a, b,
//   rho over the tile: 1.05x the cells, 34.4 KB. The free-slip BC's copies
//   of the corrected a of rows 1 and Ny - 2 and the corrected b of columns
//   1 and Nx - 2 are computed by the wall cells' threads from the panels:
//   a tile cut short by the domain's end is widened to a whole one inward
//   (common.cuh's Span), so those rows and columns lie in the wall's tile,
//   and so do the 2 cells inward that the one-sided closures read
//   (tests/test_torch_tile_halo.py pins both kernels' radii on the CPU).
// A tile whose columns and their 2-column halo lie off the side walls runs
// a copy of the code without the column closures' tests.
//
// What bounds it on the H100: device-memory traffic at N=4096 (rc_rhs
// reads 4 fields and writes 1, grad_correct reads 4 and writes 2); at
// N=1024 the ~500 tiles give ~4 blocks to an SM and rc_rhs's ~50 flops a
// cell, the divide among them, keep it at about half its byte bound. A
// block that marched down a strip of rows instead, with a ring of row
// slots filled by cp.async, waited and synchronised on every row, issued
// several times the instructions per cell and ran slower (PERF.md).
//
// Rounding: built with --fmad=false, every expression in the plain
// version's order. The plain version keeps the JAX package's division by
// dx and dy (so that it stays close to JAX on the CPU); PyTorch on CUDA
// evaluates x / c, c a Python float, as x * r with r = 1 / c taken in
// double and rounded to the tensor's dtype, and so does this kernel (rdx,
// rdy). (1.0f / float(dx) is another float at N=256: an earlier kernel
// computed that first and differed from the plain version by an ulp there.)
#include <cstdint>

#include "stencil_device.cuh"

namespace {

using pyrmt::Span;

constexpr int kTx = 64, kTy = 32;             // output cells of a tile
constexpr int kRun = 8;                       // rows of a thread's run
constexpr int kThreads = kTx * kTy / kRun;    // a column and a run each
constexpr int kPad = 4;   // panel columns each side of the tile: 16 bytes
constexpr int kW = kTx + 2 * kPad;            // a padded panel row
template <typename T>
constexpr int kBlocksPerSm = sizeof(T) == 4 ? 4 : 2;

// Start an asynchronous copy of one element (of sizeof(T) bytes), or of 16
// bytes, from device memory to the shared-memory address dst.
template <typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async16(unsigned dst, const T* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Start the copies of rows [r0, r1) and columns [c_base, c_base + kWidth)
// of the (Ny, Nx) field f, each clipped to the domain, into the panel at
// shared-memory address s, row r_base and column c_base first, kWidth
// elements a row. vec: 16-byte copies (f, c_base and Nx at multiples of 16
// bytes); else one element a copy.
template <typename T, int kWidth>
__device__ __forceinline__ void copy_panel(unsigned s, const T* f, int r_base,
                                           int r0, int r1, int c_base, int Nx,
                                           bool vec) {
  const int t = threadIdx.x;
  r0 = max(r0, 0);
  if (vec) {
    constexpr int kE = 16 / sizeof(T), kC = kWidth / kE;
    for (int k = t; k < (r1 - r0) * kC; k += kThreads) {
      const int r = r0 + k / kC, c = c_base + (k % kC) * kE;
      if (c >= 0 && c + kE <= Nx)
        cp_async16(s + ((r - r_base) * kWidth + c - c_base) * sizeof(T),
                   f + static_cast<size_t>(r) * Nx + c);
    }
  } else {
    for (int k = t; k < (r1 - r0) * kWidth; k += kThreads) {
      const int r = r0 + k / kWidth, c = c_base + k % kWidth;
      if (c >= 0 && c < Nx)
        cp_async(s + ((r - r_base) * kWidth + c - c_base) * sizeof(T),
                 f + static_cast<size_t>(r) * Nx + c);
    }
  }
}

// fd.grad_central_{x,y}_2nd at one cell from f(k), the field k cells along
// the axis (k in -2 .. 2): central inside, 2nd-order one-sided at m = 0
// and m = n - 1 (m the cell's index along the axis, n its length).
template <typename T, typename F>
__device__ __forceinline__ T grad_rel(F f, int m, int n, T inv) {
  if (m == 0) return (T(-3) * f(0) + T(4) * f(1) - f(2)) * inv;
  if (m == n - 1) return (T(3) * f(0) - T(4) * f(-1) + f(-2)) * inv;
  return (f(1) - f(-1)) * inv;
}

// The Rhie-Chow face velocity between two cells (a0, p0, g0 and a1, p1,
// g1), ops/poisson.py's u_face - d (face_dpdx - avg_dpdx).
template <typename T>
__device__ __forceinline__ T rc_face(T a0, T a1, T p0, T p1, T g0, T g1, T d,
                                     T rh) {
  return T(0.5) * (a0 + a1) - d * ((p1 - p0) * rh - T(0.5) * (g0 + g1));
}

// rc_rhs's panels: p over rows core - 2 .. core + 2 and a over the core's
// rows, both padded kPad columns each side; b over rows core - 1 .. core
// + 1 and rho over the core, the tile's columns.
constexpr int kRcA = (kTy + 4) * kW, kRcB = kRcA + kTy * kW;
constexpr int kRcR = kRcB + (kTy + 2) * kTx, kRcCells = kRcR + kTy * kTx;
// grad_correct's panels: p_corr over rows core - 1 .. core + 1, padded;
// a, b, rho over the core
constexpr int kGcA = (kTy + 2) * kW, kGcB = kGcA + kTy * kTx;
constexpr int kGcR = kGcB + kTy * kTx, kGcCells = kGcR + kTy * kTx;

// A thread's column and run of rows [jb, je) in its tile.
struct Cell {
  int tx, i, jb, je;
  __device__ Cell(const Span& xs, const Span& ys)
      : tx(threadIdx.x % kTx),
        i(xs.core_lo + tx),
        jb(ys.core_lo + kRun * (threadIdx.x / kTx)),
        je(min(jb + kRun, ys.core_hi)) {}
};

// kEdge false: the tile's columns and their 2-column halo lie inside the
// domain, so every x stencil is the interior one; the closures' tests are
// given a mid index (2 of 5) and fold away.
template <typename T, bool kEdge>
__device__ __forceinline__ void rc_rhs_tile(
    T* sm, const Span& xs, const Span& ys, const T* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ p,
    const T* __restrict__ rho, T h, T d, T* __restrict__ out, int Ny, int Nx,
    T inv2x, T inv2y, T rdx, T rdy, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  const int cl = xs.core_lo - kPad, y0 = ys.core_lo;
  copy_panel<T, kW>(s, p, y0 - 2, y0 - 2, min(ys.core_hi + 2, Ny), cl, Nx,
                    vec);
  copy_panel<T, kW>(s + kRcA * sizeof(T), a, y0, y0, ys.core_hi, cl, Nx, vec);
  copy_panel<T, kTx>(s + kRcB * sizeof(T), b, y0 - 1, y0 - 1,
                     min(ys.core_hi + 1, Ny), xs.core_lo, Nx, vec);
  copy_panel<T, kTx>(s + kRcR * sizeof(T), rho, y0, y0, ys.core_hi,
                     xs.core_lo, Nx, vec);
  cp_wait_all();
  __syncthreads();

  const Cell q(xs, ys);
  const int mi = kEdge ? q.i : 2, nx = kEdge ? Nx : 5;
  // the panels' elements at (j, i): p and a at sm[P + j kW], sm[A + j kW]
  // (then + k for column i + k), b and rho at sm[B + j kTx], sm[R + j kTx]
  const int P = (2 - y0) * kW + kPad + q.tx, A = kRcA - y0 * kW + kPad + q.tx;
  const int B = kRcB + (1 - y0) * kTx + q.tx, R = kRcR - y0 * kTx + q.tx;
  auto gy_at = [&](int j) {
    return grad_rel<T>([&](int k) { return sm[P + (j + k) * kW]; }, j, Ny,
                       inv2y);
  };
  auto fy_at = [&](int j, T g0, T g1) {  // the face at j + 1/2
    return rc_face(sm[B + j * kTx], sm[B + (j + 1) * kTx], sm[P + j * kW],
                   sm[P + (j + 1) * kW], g0, g1, d, rdy);
  };
  const bool writes = q.i >= xs.out_lo && q.i < xs.out_hi;
  T gy = T(0), fy = T(0);
  if (q.jb < q.je) {
    gy = gy_at(q.jb);
    if (q.jb >= 1) fy = fy_at(q.jb - 1, gy_at(q.jb - 1), gy);
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int j = q.jb + r;
    if (j >= q.je) break;
    const T fy_prev = fy;  // the face at j - 1/2
    if (j + 1 < Ny) {      // the face at j + 1/2
      const T gn = gy_at(j + 1);
      fy = fy_at(j, gy, gn);
      gy = gn;
    }
    if (j < ys.out_lo) continue;
    T res = T(0);
    if (j > 0 && j < Ny - 1) {
      const T* pr = sm + (P + j * kW);  // pr[k]: p(j, i + k)
      const T* ar = sm + (A + j * kW);
      auto px = [&](int o) { return [=](int k) { return pr[o + k]; }; };
      // both x faces of the cell: the one at i + 1/2 is also the right
      // neighbour's, which computes it again (faster, measured, than
      // passing it by a warp shuffle with the seams' lanes diverging)
      const T gx0 = grad_rel<T>(px(-1), mi - 1, nx, inv2x);
      const T gx = grad_rel<T>(px(0), mi, nx, inv2x);
      const T gx1 = grad_rel<T>(px(1), mi + 1, nx, inv2x);
      const T fr = rc_face(ar[0], ar[1], pr[0], pr[1], gx, gx1, d, rdx);
      const T fl = rc_face(ar[-1], ar[0], pr[-1], pr[0], gx0, gx, d, rdx);
      const T div = (fr - fl) * rdx + (fy - fy_prev) * rdy;
      res = sm[R + j * kTx] * div / h;
    }
    if (writes)
      out[static_cast<size_t>(j) * Nx + q.i] =
          (kEdge && (q.i == 0 || q.i == Nx - 1)) ? T(0) : res;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
    rc_rhs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ p, const T* __restrict__ rho,
                  const T* __restrict__ dt, const T* __restrict__ d_scalar,
                  T* __restrict__ out, int Ny, int Nx, T inv2x, T inv2y,
                  T rdx, T rdy, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const Span xs = pyrmt::tile_span(blockIdx.x * kTx, kTx, Nx, 2);
  const Span ys = pyrmt::tile_span(blockIdx.y * kTy, kTy, Ny, 2);
  const T h = dt[0], d = d_scalar[0];
  if (xs.core_lo >= 2 && xs.core_hi + 2 <= Nx)
    rc_rhs_tile<T, false>(sm, xs, ys, a, b, p, rho, h, d, out, Ny, Nx, inv2x,
                          inv2y, rdx, rdy, vec);
  else
    rc_rhs_tile<T, true>(sm, xs, ys, a, b, p, rho, h, d, out, Ny, Nx, inv2x,
                         inv2y, rdx, rdy, vec);
}

template <typename T, bool kEdge>
__device__ __forceinline__ void grad_correct_tile(
    T* sm, const Span& xs, const Span& ys, const T* __restrict__ pc,
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ rho, T h, T* __restrict__ a_out,
    T* __restrict__ b_out, int Ny, int Nx, T inv2x, T inv2y, int bc, T lid,
    bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  const int cl = xs.core_lo - kPad, y0 = ys.core_lo;
  copy_panel<T, kW>(s, pc, y0 - 1, y0 - 1, min(ys.core_hi + 1, Ny), cl, Nx,
                    vec);
  copy_panel<T, kTx>(s + kGcA * sizeof(T), a, y0, y0, ys.core_hi, xs.core_lo,
                     Nx, vec);
  copy_panel<T, kTx>(s + kGcB * sizeof(T), b, y0, y0, ys.core_hi, xs.core_lo,
                     Nx, vec);
  copy_panel<T, kTx>(s + kGcR * sizeof(T), rho, y0, y0, ys.core_hi,
                     xs.core_lo, Nx, vec);
  cp_wait_all();
  __syncthreads();

  const Cell q(xs, ys);
  const int nx = kEdge ? Nx : 5;
  // p_corr(j, core_lo + l) at sm[PC + j kW + l]; a, b, rho at (j, core_lo
  // + l) at sm[A + j kTx + l], sm[B + ...], sm[R + ...]
  const int PC = (1 - y0) * kW + kPad, A = kGcA - y0 * kTx;
  const int B = kGcB - y0 * kTx, R = kGcR - y0 * kTx;
  // a - (dt / rho) dp/dx and b - (dt / rho) dp/dy at (j, c), l = c - core_lo
  auto corr_a = [&](int j, int l, int c) {
    T g = T(0);
    if ((kEdge && (c == 0 || c == Nx - 1)) || (j > 0 && j < Ny - 1))
      g = grad_rel<T>([&](int k) { return sm[PC + j * kW + l + k]; },
                      kEdge ? c : 2, nx, inv2x);
    return sm[A + j * kTx + l] - (h / sm[R + j * kTx + l]) * g;
  };
  auto corr_b = [&](int j, int l, int c) {
    T g = T(0);
    if (j == 0 || j == Ny - 1 || !kEdge || (c > 0 && c < Nx - 1))
      g = grad_rel<T>([&](int k) { return sm[PC + (j + k) * kW + l]; }, j,
                      Ny, inv2y);
    return sm[B + j * kTx + l] - (h / sm[R + j * kTx + l]) * g;
  };
  if (q.i < xs.out_lo || q.i >= xs.out_hi) return;
  const int i = q.i, tx = q.tx;
  const bool col_b = kEdge && (i == 0 || i == Nx - 1);
#pragma unroll 1
  for (int j = max(q.jb, ys.out_lo); j < q.je; ++j) {
    const bool row_b = j == 0 || j == Ny - 1;
    T ua, vb;
    if (bc == pyrmt::kLid) {
      ua = (j == Ny - 1 && !col_b) ? lid
           : (col_b || row_b)      ? T(0)
                                   : corr_a(j, tx, i);
      vb = (col_b || row_b) ? T(0) : corr_b(j, tx, i);
    } else if (bc == pyrmt::kFreeSlip) {
      // the u columns are zeroed before the rows are copied (bcs.py)
      ua = col_b       ? T(0)
           : j == 0      ? corr_a(1, tx, i)
           : j == Ny - 1 ? corr_a(Ny - 2, tx, i)
                         : corr_a(j, tx, i);
      vb = row_b                       ? T(0)
           : (kEdge && i == 0)         ? corr_b(j, tx + 1, 1)
           : (kEdge && i == Nx - 1)    ? corr_b(j, tx - 1, Nx - 2)
                                       : corr_b(j, tx, i);
    } else {
      ua = corr_a(j, tx, i);
      vb = corr_b(j, tx, i);
    }
    const size_t g = static_cast<size_t>(j) * Nx + i;
    a_out[g] = ua;
    b_out[g] = vb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
    grad_correct_kernel(const T* __restrict__ pc, const T* __restrict__ a,
                        const T* __restrict__ b, const T* __restrict__ rho,
                        const T* __restrict__ dt, T* __restrict__ a_out,
                        T* __restrict__ b_out, int Ny, int Nx, T inv2x,
                        T inv2y, int bc, T lid, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const Span xs = pyrmt::tile_span(blockIdx.x * kTx, kTx, Nx, 1);
  const Span ys = pyrmt::tile_span(blockIdx.y * kTy, kTy, Ny, 1);
  const T h = dt[0];
  if (xs.core_lo >= 2 && xs.core_hi + 2 <= Nx)
    grad_correct_tile<T, false>(sm, xs, ys, pc, a, b, rho, h, a_out, b_out,
                                Ny, Nx, inv2x, inv2y, bc, lid, vec);
  else
    grad_correct_tile<T, true>(sm, xs, ys, pc, a, b, rho, h, a_out, b_out, Ny,
                               Nx, inv2x, inv2y, bc, lid, vec);
}

// 16-byte copies: rows of a multiple of 16 bytes, each field at a 16-byte
// boundary.
template <typename T>
bool vec16(int Nx, const T* f0, const T* f1, const T* f2, const T* f3) {
  auto aligned = [](const T* f) {
    return reinterpret_cast<std::uintptr_t>(f) % 16 == 0;
  };
  return Nx % (16 / sizeof(T)) == 0 && aligned(f0) && aligned(f1) &&
         aligned(f2) && aligned(f3);
}

template <typename T>
int launch_rc_rhs(const T* a, const T* b, const T* p, const T* rho,
                  const T* dt, const T* d_scalar, T* out, int Ny, int Nx,
                  double dx, double dy, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  const size_t smem = kRcCells * sizeof(T);
  int err = pyrmt::allow_smem(rc_rhs_kernel<T>, smem, allowed);
  if (err) return err;
  const dim3 grid(pyrmt::tiles_for(Nx, kTx), pyrmt::tiles_for(Ny, kTy));
  rc_rhs_kernel<T><<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      a, b, p, rho, dt, d_scalar, out, Ny, Nx,
      static_cast<T>(1.0 / (2.0 * dx)), static_cast<T>(1.0 / (2.0 * dy)),
      static_cast<T>(1.0 / dx), static_cast<T>(1.0 / dy),
      vec16(Nx, p, a, b, rho));
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int launch_grad_correct(const T* pc, const T* a, const T* b, const T* rho,
                        const T* dt, T* a_out, T* b_out, int Ny, int Nx,
                        double dx, double dy, int bc, double lid,
                        void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  const size_t smem = kGcCells * sizeof(T);
  int err = pyrmt::allow_smem(grad_correct_kernel<T>, smem, allowed);
  if (err) return err;
  const dim3 grid(pyrmt::tiles_for(Nx, kTx), pyrmt::tiles_for(Ny, kTy));
  grad_correct_kernel<T><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      pc, a, b, rho, dt, a_out, b_out, Ny, Nx,
      static_cast<T>(1.0 / (2.0 * dx)), static_cast<T>(1.0 / (2.0 * dy)), bc,
      static_cast<T>(lid), vec16(Nx, pc, a, b, rho));
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_RC_RHS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* a, const T* b, const T* p, const T* rho,      \
                      const T* dt, const T* d_scalar, T* out, int Ny,        \
                      int Nx, double dx, double dy, void* stream) {          \
    return launch_rc_rhs<T>(a, b, p, rho, dt, d_scalar, out, Ny, Nx, dx, dy, \
                            stream);                                         \
  }

#define PYRMT_GRAD_CORRECT_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const T* pc, const T* a, const T* b, const T* rho,     \
                      const T* dt, T* a_out, T* b_out, int Ny, int Nx,       \
                      double dx, double dy, int bc, double lid,              \
                      void* stream) {                                        \
    return launch_grad_correct<T>(pc, a, b, rho, dt, a_out, b_out, Ny, Nx,   \
                                  dx, dy, bc, lid, stream);                  \
  }

PYRMT_RC_RHS_ENTRY(pyrmt_rc_rhs_f32, float)
PYRMT_RC_RHS_ENTRY(pyrmt_rc_rhs_f64, double)
PYRMT_GRAD_CORRECT_ENTRY(pyrmt_grad_correct_f32, float)
PYRMT_GRAD_CORRECT_ENTRY(pyrmt_grad_correct_f64, double)
