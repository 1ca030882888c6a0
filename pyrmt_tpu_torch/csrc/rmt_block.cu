// The RMT solid pipeline of one step, on Hopper: rebuild, shared-backtrace
// semi-Lagrangian RK4 advection, mask, layer-synchronous least-squares
// extrapolation, rebuild, neo-Hookean stress and J, smoothed Heaviside and
// the mixture blends. One solid, shaped as a Disc given by runtime scalars.
//
// Replaces: pyrmt_tpu/kernels/rmt_block.py::rmt_block_fused (the
// pl.pallas_call at rmt_block.py:825). The plain version is
// pyrmt_tpu_torch.kernels.rmt_block.rmt_block_plain.
//
// Stages, one thread per cell each:
//   advect_kernel  phi0 = disc(X) -> RK4 backtrace through three bilinear
//                  samples of (u, v) -> bilinear sample of X1, X2 -> times
//                  mask (phi0 <= 0); known = phi0 < 0
//   layer_kernel   one launch per extrapolation layer, ping-ponging
//                  (X1, X2, known): a frontier cell solves the 3x3 normal
//                  equations of the Gaussian plane fit over its 9x9 window
//                  (zero outside the domain), summed as the separable x-then-
//                  y pass of the plain version, in the same order
//   post_kernel    phi = disc(Xe); stress with one-sided differences next to
//                  fluid (interior cells only); H(phi); Hf, rho, (1-H) sigma
// The tile-activity skip of the Pallas kernel is an exact shortcut and is
// left out.
//
// What bounds it on the H100: device-memory traffic in the advect and post
// stages (a few reads and up to 12 writes per cell), and on the frontier
// cells the layer stage's arithmetic (81 window cells, 13 sums, a Cramer
// solve) — but the frontier is a thin ring, so the layer launches mostly
// copy. The design answers it with coalesced one-thread-per-cell sweeps
// and by recomputing phi = disc(X) at neighbours instead of storing it.
// Fusing the stages into one shared-memory tile with a 4L+4 halo, as the
// Pallas kernel does, is later work.
//
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "common.cuh"

namespace {

using pyrmt::clampf;
using pyrmt::clampi;
using pyrmt::Disc;

constexpr int kWin = 4;  // 9x9 extrapolation window

// The separable 1D factors of ops/extrapolate.py::_kernels_1d, in T.
template <typename T>
struct Taps {
  T wx[9], wxd[9], wxd2[9], wy[9], wyd[9], wyd2[9];
};

// ops/interp.py::gather_bilinear_local at one cell: clip the displacement,
// clamp the query into the domain, pick the corners by the signs at this
// cell; edge-clamped neighbours.
template <typename T>
struct Bilinear {
  size_t c00, c10, c01, c11;
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
    size_t r0 = static_cast<size_t>(clampi(jl, 0, Ny - 1)) * Nx;
    size_t r1 = static_cast<size_t>(clampi(jl + 1, 0, Ny - 1)) * Nx;
    int a0 = clampi(il, 0, Nx - 1), a1 = clampi(il + 1, 0, Nx - 1);
    c00 = r0 + a0;
    c10 = r0 + a1;
    c01 = r1 + a0;
    c11 = r1 + a1;
  }

  __device__ T operator()(const T* f) const {
    if (!finite) return static_cast<T>(NAN);
    return w00 * f[c00] + w10 * f[c10] + w01 * f[c01] + w11 * f[c11];
  }
};

// sc = [dt, mu_s, kappa, rho_s, rho_f] on the device: no host sync.
template <typename T>
__global__ void advect_kernel(const T* u, const T* v, const T* X1,
                              const T* X2, const T* sc, Disc<T> disc, T* X1a,
                              T* X2a, T* kf, int Ny, int Nx, double dx,
                              double dy) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T dt = sc[0];
  const T inv_dx = static_cast<T>(1.0 / dx), inv_dy = static_cast<T>(1.0 / dy);
  T phi0 = disc(X1[n], X2[n]);
  T mask = phi0 <= T(0) ? T(1) : T(0);
  kf[n] = phi0 < T(0) ? T(1) : T(0);

  T k1x = u[n], k1y = v[n];
  const T half = T(-0.5) * dt;
  Bilinear<T> b2(j, i, half * k1x * inv_dx, half * k1y * inv_dy, Ny, Nx);
  T k2x = b2(u), k2y = b2(v);
  Bilinear<T> b3(j, i, half * k2x * inv_dx, half * k2y * inv_dy, Ny, Nx);
  T k3x = b3(u), k3y = b3(v);
  const T full = -dt;
  Bilinear<T> b4(j, i, full * k3x * inv_dx, full * k3y * inv_dy, Ny, Nx);
  T k4x = b4(u), k4y = b4(v);
  const T sixth = dt * static_cast<T>(-1.0 / 6.0);
  T sx = sixth * (k1x + T(2) * k2x + T(2) * k3x + k4x) * inv_dx;
  T sy = sixth * (k1y + T(2) * k2y + T(2) * k3y + k4y) * inv_dy;
  Bilinear<T> bf(j, i, sx, sy, Ny, Nx);
  X1a[n] = bf(X1) * mask;
  X2a[n] = bf(X2) * mask;
}

// One layer-synchronous extrapolation sweep (ops/extrapolate.py).
template <typename T>
__global__ void layer_kernel(const T* X1, const T* X2, const T* kf, T* X1o,
                             T* X2o, T* kfo, int Ny, int Nx, Taps<T> tp) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  T x1 = X1[n], x2 = X2[n], k = kf[n];
  bool interior = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
  bool frontier = false;
  if (interior && k == T(0)) {
    for (int dj = -1; dj <= 1; ++dj)
      for (int di = -1; di <= 1; ++di)
        frontier = frontier || kf[n + static_cast<long long>(dj) * Nx + di] > T(0);
  }
  if (frontier) {
    T count = 0, s00 = 0, s01 = 0, s02 = 0, s11 = 0, s12 = 0, s22 = 0;
    T b10 = 0, b11 = 0, b12 = 0, b20 = 0, b21 = 0, b22 = 0;
    for (int dj = -kWin; dj <= kWin; ++dj) {
      int r = j + dj;
      if (r < 0 || r >= Ny) continue;  // zero rows add nothing
      // x pass of row r: sum over di in ascending order
      T k_1 = 0, k_wx = 0, k_wxd = 0, k_wxd2 = 0;
      T x1_wx = 0, x1_wxd = 0, x2_wx = 0, x2_wxd = 0;
      for (int di = -kWin; di <= kWin; ++di) {
        int col = i + di;
        if (col < 0 || col >= Nx) continue;
        size_t m = static_cast<size_t>(r) * Nx + col;
        T kk = kf[m];
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
  X1o[n] = x1;
  X2o[n] = x2;
  kfo[n] = k;
}

template <typename T>
__global__ void post_kernel(const T* X1, const T* X2, const T* sc,
                            Disc<T> disc, T* phi, T* sxx, T* sxy, T* syy,
                            T* J, T* Hf, T* rho, T* sbxx, T* sbxy, T* sbyy,
                            int Ny, int Nx, double dx, double dy,
                            double w_t) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T mu_s = sc[1], kappa = sc[2], rho_s = sc[3], rho_f = sc[4];
  const T x1 = X1[n], x2 = X2[n];
  const T ph = disc(x1, x2);
  T s_xx = T(0), s_xy = T(0), s_yy = T(0), jac = T(1);
  bool interior = j > 0 && j < Ny - 1 && i > 0 && i < Nx - 1;
  if (interior && ph <= T(0)) {
    // ops/stress.py interior mode: one-sided differences where exactly one
    // neighbour along the axis is fluid
    const long long e = n + 1, w = n - 1, no = n + Nx, so = n - Nx;
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
  phi[n] = ph;
  sxx[n] = s_xx;
  sxy[n] = s_xy;
  syy[n] = s_yy;
  J[n] = jac;
  Hf[n] = hf;
  rho[n] = hf * rho_f + omh * rho_s;
  sbxx[n] = omh * s_xx;
  sbxy[n] = omh * s_xy;
  sbyy[n] = omh * s_yy;
}

// taps: 6 x 9 host doubles (wx, wxd, wxd2, wy, wyd, wyd2).
// scratch: 6 fields (X1, X2, known) x 2 for the ping-pong.
template <typename T>
int launch(const T* u, const T* v, const T* X1, const T* X2, const T* sc,
           T* x1e, T* x2e, T* phi, T* sxx, T* sxy, T* syy, T* J, T* Hf,
           T* rho, T* sbxx, T* sbxy, T* sbyy, T* scratch, int Ny, int Nx,
           double dx, double dy, int num_layers, double w_t, double x0,
           double y0, double R, const double* taps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t N = static_cast<size_t>(Ny) * Nx;
  const unsigned nb = pyrmt::blocks_for(static_cast<long long>(N));
  const int nt = pyrmt::kThreads;
  Disc<T> disc{static_cast<T>(x0), static_cast<T>(y0), static_cast<T>(R)};
  Taps<T> tp;
  for (int t = 0; t < 9; ++t) {
    tp.wx[t] = static_cast<T>(taps[t]);
    tp.wxd[t] = static_cast<T>(taps[9 + t]);
    tp.wxd2[t] = static_cast<T>(taps[18 + t]);
    tp.wy[t] = static_cast<T>(taps[27 + t]);
    tp.wyd[t] = static_cast<T>(taps[36 + t]);
    tp.wyd2[t] = static_cast<T>(taps[45 + t]);
  }
  T* buf[2][3] = {{scratch, scratch + N, scratch + 2 * N},
                  {scratch + 3 * N, scratch + 4 * N, scratch + 5 * N}};
  advect_kernel<T><<<nb, nt, 0, stream>>>(u, v, X1, X2, sc, disc, buf[0][0],
                                          buf[0][1], buf[0][2], Ny, Nx, dx,
                                          dy);
  PYRMT_RETURN_IF_ERROR();
  for (int l = 0; l < num_layers; ++l) {
    T** src = buf[l % 2];
    T** dst = buf[(l + 1) % 2];
    bool last = l == num_layers - 1;
    layer_kernel<T><<<nb, nt, 0, stream>>>(
        src[0], src[1], src[2], last ? x1e : dst[0], last ? x2e : dst[1],
        dst[2], Ny, Nx, tp);
    PYRMT_RETURN_IF_ERROR();
  }
  post_kernel<T><<<nb, nt, 0, stream>>>(x1e, x2e, sc, disc, phi, sxx, sxy,
                                        syy, J, Hf, rho, sbxx, sbxy, sbyy, Ny,
                                        Nx, dx, dy, w_t);
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

#define PYRMT_RMT_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* u, const T* v, const T* X1, const T* X2,       \
                      const T* sc, T* x1e, T* x2e, T* phi, T* sxx, T* sxy,    \
                      T* syy, T* J, T* Hf, T* rho, T* sbxx, T* sbxy,          \
                      T* sbyy, T* scratch, int Ny, int Nx, double dx,         \
                      double dy, int num_layers, double w_t, double x0,       \
                      double y0, double R, const double* taps,                \
                      void* stream) {                                         \
    return launch<T>(u, v, X1, X2, sc, x1e, x2e, phi, sxx, sxy, syy, J, Hf,   \
                     rho, sbxx, sbxy, sbyy, scratch, Ny, Nx, dx, dy,          \
                     num_layers, w_t, x0, y0, R, taps, stream);               \
  }

PYRMT_RMT_ENTRY(pyrmt_rmt_block_f32, float)
PYRMT_RMT_ENTRY(pyrmt_rmt_block_f64, double)
