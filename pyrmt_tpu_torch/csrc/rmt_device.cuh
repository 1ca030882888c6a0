// Device code of the reference-map kernels at one cell, shared by the tile
// kernels of rmt_block.cu (the fused tier and the split tier's
// advect-extrapolate block) and extrapolate_fused.cu (the standalone
// extrapolation); the panels and the layer sweeps over them are
// panel_device.cuh's:
//   Bilinear       ops/interp.py::gather_bilinear_local at one cell
//   Bicubic        ops/interp.py::gather_bicubic_local at one cell
//   backtrace_at   the shared RK4 backtrace of the map at one cell
//   masked_sample  the advected map at one cell times the mask (phi <= 0),
//                  and the known flag (phi < 0), given the cell's
//                  pre-advection phi: the bilinear final sample, or with
//                  kBicubic the bicubic one (bilinear where the band guard
//                  rejects the cell)
//   frontier_at, layer_at
//                  one layer-synchronous least-squares extrapolation step at
//                  one cell of a shared-memory panel
// Every expression in the order of the plain PyTorch version (built with
// --fmad=false), so kernel and plain version round alike.
#pragma once

#include "common.cuh"

namespace pyrmt {

constexpr int kWin = 4;  // 9x9 extrapolation window

// The separable 1D factors of ops/extrapolate.py::_kernels_1d, in T.
template <typename T>
struct Taps {
  T wx[9], wxd[9], wxd2[9], wy[9], wyd[9], wyd2[9];
};

// taps: 6 x 9 host doubles (wx, wxd, wxd2, wy, wyd, wyd2).
template <typename T>
Taps<T> load_taps(const double* taps) {
  Taps<T> tp;
  for (int t = 0; t < 9; ++t) {
    tp.wx[t] = static_cast<T>(taps[t]);
    tp.wxd[t] = static_cast<T>(taps[9 + t]);
    tp.wxd2[t] = static_cast<T>(taps[18 + t]);
    tp.wy[t] = static_cast<T>(taps[27 + t]);
    tp.wyd[t] = static_cast<T>(taps[36 + t]);
    tp.wyd2[t] = static_cast<T>(taps[45 + t]);
  }
  return tp;
}

// A field by global (row, column): element (r - j0) * stride + (c - i0)
// of f: a device field (j0 = i0 = 0, stride Nx) or a shared-memory copy of
// a window of one.
template <typename T>
struct Rows {
  const T* f;
  size_t stride;
  int j0, i0;
  __device__ T operator()(int r, int c) const {
    return f[static_cast<size_t>(r - j0) * stride + (c - i0)];
  }
};

// ops/interp.py::gather_bilinear_local at one cell: clip the displacement,
// clamp the query into the domain, pick the corners by the signs at this
// cell; edge-clamped neighbours.
template <typename T>
struct Bilinear {
  int r0, r1, a0, a1;  // the corners' rows and columns
  T w00, w10, w01, w11;
  bool finite;

  __device__ Bilinear(int j, int i, T sx, T sy, int Ny, int Nx) {
    finite = isfinite(sx) && isfinite(sy);
    if (!finite) sx = sy = T(0);
    const T lo = static_cast<T>(-1.0 + 1e-6), hi = static_cast<T>(1.0 - 1e-6);
    sx = clampf(sx, lo, hi);
    sy = clampf(sy, lo, hi);
    const T gx = static_cast<T>(i), gy = static_cast<T>(j);
    T x = clampf(gx + sx, T(0), static_cast<T>(Nx - 1.0));
    T y = clampf(gy + sy, T(0), static_cast<T>(Ny - 1.0));
    sx = x - gx;
    sy = y - gy;
    bool neg_x = sx < T(0), neg_y = sy < T(0);
    T fx = neg_x ? sx + T(1) : sx;
    T fy = neg_y ? sy + T(1) : sy;
    if (i >= Nx - 1 && !neg_x) {
      neg_x = true;
      fx = T(1);
    }
    if (j >= Ny - 1 && !neg_y) {
      neg_y = true;
      fy = T(1);
    }
    w00 = (T(1) - fx) * (T(1) - fy);
    w10 = fx * (T(1) - fy);
    w01 = (T(1) - fx) * fy;
    w11 = fx * fy;
    int jl = j - (neg_y ? 1 : 0), il = i - (neg_x ? 1 : 0);
    r0 = clampi(jl, 0, Ny - 1);
    r1 = clampi(jl + 1, 0, Ny - 1);
    a0 = clampi(il, 0, Nx - 1);
    a1 = clampi(il + 1, 0, Nx - 1);
  }

  __device__ T operator()(const Rows<T>& f) const {
    if (!finite) return static_cast<T>(NAN);
    return w00 * f(r0, a0) + w10 * f(r0, a1) + w01 * f(r1, a0) +
           w11 * f(r1, a1);
  }
};

// torch.minimum, torch.maximum and torch.clamp(x, lo_tensor, hi_tensor) on
// the card: a NaN operand gives NaN (fmin and fmax alone drop it).
template <typename T>
__device__ inline T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}
template <typename T>
__device__ inline T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}
template <typename T>
__device__ inline T nan_clamp(T x, T lo, T hi) {
  return x != x ? x : (lo != lo ? lo : (hi != hi ? hi : fmin(fmax(x, lo), hi)));
}

// ops/interp.py::cubic_convolution, the terms in its order.
template <typename T>
__device__ inline T cubic_convolution(T v0, T v1, T v2, T v3, T t) {
  const T a0 = T(-0.5) * v0 + T(1.5) * v1 - T(1.5) * v2 + T(0.5) * v3;
  const T a1 = v0 - T(2.5) * v1 + T(2) * v2 - T(0.5) * v3;
  const T a2 = T(-0.5) * v0 + T(0.5) * v2;
  return ((a0 * t + a1) * t + a2) * t + v1;
}

// ops/interp.py::gather_bicubic_local at one cell: the displacement clipped
// and the query clamped as Bilinear does, the 4x4 stencil based at i - 1
// (i - 2 where the clipped displacement is negative) along each axis, every
// tap's global index clipped into [0, N - 1] (the plain version's
// edge-replicating shifts), Catmull-Rom row by row, then down the rows,
// clamped to the 16 taps' min/max. Reads within +-2 cells. Where the band
// guard rejects the cell, the bilinear sample at the clipped displacement
// (Bilinear re-clips it, as the plain version's fallback does) replaces it.
template <typename T>
struct Bicubic {
  int r[4], c[4];  // the stencil's rows and columns
  T fx, fy, sx, sy;
  int j, i, Ny, Nx;
  bool finite;

  __device__ Bicubic(int j_, int i_, T sx_, T sy_, int Ny_, int Nx_)
      : j(j_), i(i_), Ny(Ny_), Nx(Nx_) {
    finite = isfinite(sx_) && isfinite(sy_);
    if (!finite) sx_ = sy_ = T(0);
    const T lo = static_cast<T>(-1.0 + 1e-6), hi = static_cast<T>(1.0 - 1e-6);
    sx_ = clampf(sx_, lo, hi);
    sy_ = clampf(sy_, lo, hi);
    const T gx = static_cast<T>(i), gy = static_cast<T>(j);
    T x = clampf(gx + sx_, T(0), static_cast<T>(Nx - 1.0));
    T y = clampf(gy + sy_, T(0), static_cast<T>(Ny - 1.0));
    sx = x - gx;
    sy = y - gy;
    const bool neg_x = sx < T(0), neg_y = sy < T(0);
    fx = neg_x ? sx + T(1) : sx;
    fy = neg_y ? sy + T(1) : sy;
    const int bx = i - (neg_x ? 2 : 1), by = j - (neg_y ? 2 : 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = clampi(by + k, 0, Ny - 1);
      c[k] = clampi(bx + k, 0, Nx - 1);
    }
  }

  // the bicubic sample, or with use_bilinear the bilinear one
  __device__ T operator()(const Rows<T>& f, bool use_bilinear) const {
    if (!finite) return static_cast<T>(NAN);
    if (use_bilinear) return Bilinear<T>(j, i, sx, sy, Ny, Nx)(f);
    T lo = T(0), hi = T(0), rows[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      T v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = f(r[m], c[n]);
        lo = m == 0 && n == 0 ? v[n] : nan_min(lo, v[n]);
        hi = m == 0 && n == 0 ? v[n] : nan_max(hi, v[n]);
      }
      rows[m] = cubic_convolution(v[0], v[1], v[2], v[3], fx);
    }
    return nan_clamp(cubic_convolution(rows[0], rows[1], rows[2], rows[3], fy),
                     lo, hi);
  }
};

// The RK4 backtrace of the map at cell (j, i) through three bilinear
// samples of (u, v), each read within +-1 cell: the displacement (sx, sy),
// in cells, of the final sample. One backtrace serves every field that
// the step advects (the plain version samples the stack of all maps).
template <typename T>
__device__ void backtrace_at(const Rows<T>& u, const Rows<T>& v, T dt, int j,
                             int i, int Ny, int Nx, double dx, double dy,
                             T& sx, T& sy) {
  const T inv_dx = static_cast<T>(1.0 / dx), inv_dy = static_cast<T>(1.0 / dy);
  T k1x = u(j, i), k1y = v(j, i);
  const T half = T(-0.5) * dt;
  Bilinear<T> b2(j, i, half * k1x * inv_dx, half * k1y * inv_dy, Ny, Nx);
  T k2x = b2(u), k2y = b2(v);
  Bilinear<T> b3(j, i, half * k2x * inv_dx, half * k2y * inv_dy, Ny, Nx);
  T k3x = b3(u), k3y = b3(v);
  const T full = -dt;
  Bilinear<T> b4(j, i, full * k3x * inv_dx, full * k3y * inv_dy, Ny, Nx);
  T k4x = b4(u), k4y = b4(v);
  const T sixth = dt * static_cast<T>(-1.0 / 6.0);
  sx = sixth * (k1x + T(2) * k2x + T(2) * k3x + k4x) * inv_dx;
  sy = sixth * (k1y + T(2) * k2y + T(2) * k3y + k4y) * inv_dy;
}

// The band guard of the bicubic final sample: bicubic where the cell's
// pre-advection phi0 < thr (thr = -sl_guard, rounded to T as the plain
// version's comparison rounds it), bilinear elsewhere; everywhere bicubic
// where off (raw bicubic).
template <typename T>
struct Guard {
  T thr;
  bool on;
};

// The advected map at cell (j, i) from its backtrace's displacement: the
// bilinear sample of X1, X2 (read within +-1 cell), or with kBicubic the
// bicubic one under the guard (within +-2), times mask (phi0 <= 0);
// known = phi0 < 0, phi0 being the cell's pre-advection level set.
template <typename T, bool kBicubic>
__device__ void masked_sample(const Rows<T>& X1, const Rows<T>& X2, T sx,
                              T sy, T phi0, int j, int i, int Ny, int Nx,
                              T& x1a, T& x2a, bool& known,
                              const Guard<T>& guard) {
  const T mask = phi0 <= T(0) ? T(1) : T(0);
  known = phi0 < T(0);
  if constexpr (kBicubic) {
    const Bicubic<T> bc(j, i, sx, sy, Ny, Nx);
    const bool bilinear = guard.on && !(phi0 < guard.thr);
    x1a = bc(X1, bilinear) * mask;
    x2a = bc(X2, bilinear) * mask;
  } else {
    Bilinear<T> bf(j, i, sx, sy, Ny, Nx);
    x1a = bf(X1) * mask;
    x2a = bf(X2) * mask;
  }
}

// Is cell (j, i), element n of known flags (bytes) whose rows are sy
// apart, on the extrapolation's frontier: unknown, interior, with a known
// 3x3 neighbour?
template <typename T>
__device__ bool frontier_at(const unsigned char* kf, size_t n, size_t sy,
                            int j, int i, int Ny, int Nx) {
  const long long ss = static_cast<long long>(sy);
  bool interior = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
  bool frontier = false;
  if (interior && static_cast<T>(kf[n]) == T(0)) {
    for (int dj = -1; dj <= 1; ++dj)
      for (int di = -1; di <= 1; ++di)
        frontier = frontier || static_cast<T>(kf[n + dj * ss + di]) > T(0);
  }
  return frontier;
}

// One layer-synchronous extrapolation step at cell (j, i), element n of
// fields whose rows are sy apart (the known flags as bytes): a frontier
// cell solves the 3x3 normal equations of the Gaussian plane
// fit over its 9x9 window (zero outside the domain), summed as the
// separable x-then-y pass of the plain version, in the same order; any
// other cell keeps its state. (x1, x2, k) is the cell's new state.
template <typename T>
__device__ void layer_at(const T* X1, const T* X2, const unsigned char* kf,
                         size_t n, size_t sy, int j, int i, int Ny, int Nx,
                         const Taps<T>& tp, T& x1, T& x2, T& k) {
  x1 = X1[n];
  x2 = X2[n];
  k = static_cast<T>(kf[n]);
  const long long ss = static_cast<long long>(sy);
  if (!frontier_at<T>(kf, n, sy, j, i, Ny, Nx)) return;
  T count = 0, s00 = 0, s01 = 0, s02 = 0, s11 = 0, s12 = 0, s22 = 0;
  T b10 = 0, b11 = 0, b12 = 0, b20 = 0, b21 = 0, b22 = 0;
  for (int dj = -kWin; dj <= kWin; ++dj) {
    int r = j + dj;
    if (r < 0 || r >= Ny) continue;  // zero rows add nothing
    const size_t row = n + dj * ss;
    // x pass of row r: sum over di in ascending order
    T k_1 = 0, k_wx = 0, k_wxd = 0, k_wxd2 = 0;
    T x1_wx = 0, x1_wxd = 0, x2_wx = 0, x2_wxd = 0;
    for (int di = -kWin; di <= kWin; ++di) {
      int col = i + di;
      if (col < 0 || col >= Nx) continue;
      size_t m = row + di;
      T kk = static_cast<T>(kf[m]);
      T kx1 = kk * X1[m], kx2 = kk * X2[m];
      const int t = di + kWin;
      k_1 = k_1 + kk;
      k_wx = k_wx + kk * tp.wx[t];
      k_wxd = k_wxd + kk * tp.wxd[t];
      k_wxd2 = k_wxd2 + kk * tp.wxd2[t];
      x1_wx = x1_wx + kx1 * tp.wx[t];
      x1_wxd = x1_wxd + kx1 * tp.wxd[t];
      x2_wx = x2_wx + kx2 * tp.wx[t];
      x2_wxd = x2_wxd + kx2 * tp.wxd[t];
    }
    const int t = dj + kWin;
    count = count + k_1;
    s00 = s00 + k_wx * tp.wy[t];
    s02 = s02 + k_wx * tp.wyd[t];
    s22 = s22 + k_wx * tp.wyd2[t];
    s01 = s01 + k_wxd * tp.wy[t];
    s12 = s12 + k_wxd * tp.wyd[t];
    s11 = s11 + k_wxd2 * tp.wy[t];
    b10 = b10 + x1_wx * tp.wy[t];
    b12 = b12 + x1_wx * tp.wyd[t];
    b11 = b11 + x1_wxd * tp.wy[t];
    b20 = b20 + x2_wx * tp.wy[t];
    b22 = b22 + x2_wx * tp.wyd[t];
    b21 = b21 + x2_wxd * tp.wy[t];
  }
  // fd.solve3x3_sym's constant coefficient, det threshold 1e-10
  T det = s00 * (s11 * s22 - s12 * s12) - s01 * (s01 * s22 - s12 * s02)
          + s02 * (s01 * s12 - s11 * s02);
  bool ok = fabs(det) > static_cast<T>(1e-10);
  if (ok && count >= T(3)) {
    T inv_det = T(1) / det;
    x1 = (b10 * (s11 * s22 - s12 * s12) - s01 * (b11 * s22 - s12 * b12)
          + s02 * (b11 * s12 - s11 * b12)) * inv_det;
    x2 = (b20 * (s11 * s22 - s12 * s12) - s01 * (b21 * s22 - s12 * b22)
          + s02 * (b21 * s12 - s11 * b22)) * inv_det;
    k = T(1);
  }
}

}  // namespace pyrmt
