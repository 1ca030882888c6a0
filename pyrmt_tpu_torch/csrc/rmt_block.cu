// The RMT solid pipeline of one step, on Hopper, in two entry points:
//
// pyrmt_rmt_block_*  the fused tier: rebuild, shared-backtrace
//   semi-Lagrangian RK4 advection, mask, layer-synchronous least-squares
//   extrapolation, rebuild, neo-Hookean stress and J, smoothed Heaviside and
//   the mixture blends. One solid, shaped as a Disc given by runtime
//   scalars. Replaces pyrmt_tpu/kernels/rmt_block.py::rmt_block_fused (the
//   pl.pallas_call at rmt_block.py:825); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.rmt_block_plain.
// pyrmt_advext_*  the split tier's kernel A: the same advection, mask and
//   extrapolation with the pre-advection phi given as a field (any level
//   set, S solids one after another). Replaces
//   pyrmt_tpu/kernels/rmt_block.py::advext_block_fused (the pl.pallas_call
//   at rmt_block.py:1085); plain version
//   pyrmt_tpu_torch.kernels.rmt_block.advext_block_plain.
//
// Stages, one thread per cell each (rmt_device.cuh holds the shared ones):
//   advect_kernel  phi0 = disc(X) or phi[n] -> RK4 backtrace through three
//                  bilinear samples of (u, v) -> bilinear sample of X1, X2
//                  -> times mask (phi0 <= 0); known = phi0 < 0
//   layer_kernel   one launch per extrapolation layer, ping-ponging
//                  (X1, X2, known)
//   post_kernel    (fused tier) phi = disc(Xe); stress with one-sided
//                  differences next to fluid (interior cells only); H(phi);
//                  Hf, rho, (1-H) sigma
// The tile-activity skip of the Pallas kernels is an exact shortcut and is
// left out.
//
// What bounds it on the H100: device-memory traffic in the advect and post
// stages (a few reads and up to 12 writes per cell), and on the frontier
// cells the layer stage's arithmetic (81 window cells, 13 sums, a Cramer
// solve) — but the frontier is a thin ring, so the layer launches mostly
// copy. The design answers it with coalesced one-thread-per-cell sweeps
// and by recomputing phi = disc(X) at neighbours instead of storing it.
// Fusing the stages into one shared-memory tile with a 4L+4 halo, as the
// Pallas kernels do, is later work.
//
// Built with --fmad=false, and a division by a constant is a product by its
// reciprocal here as in the plain PyTorch version, so every operation
// rounds as there: the two agree bit for bit on the H100 (chip_smoke.py).
#include "rmt_device.cuh"

namespace {

using pyrmt::Disc;
using pyrmt::DiscPhi;
using pyrmt::FieldPhi;
using pyrmt::Taps;

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

// sc = [dt, mu_s, kappa, rho_s, rho_f] on the device.
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
  const Taps<T> tp = pyrmt::load_taps<T>(taps);
  T* const buf[2][3] = {{scratch, scratch + N, scratch + 2 * N},
                        {scratch + 3 * N, scratch + 4 * N, scratch + 5 * N}};
  pyrmt::advect_kernel<T, DiscPhi<T>><<<nb, nt, 0, stream>>>(
      u, v, X1, X2, sc, DiscPhi<T>{disc}, buf[0][0], buf[0][1], buf[0][2],
      Ny, Nx, dx, dy);
  PYRMT_RETURN_IF_ERROR();
  int err = pyrmt::run_layers<T>(buf, x1e, x2e, num_layers, Ny, Nx, tp,
                                 stream);
  if (err) return err;
  post_kernel<T><<<nb, nt, 0, stream>>>(x1e, x2e, sc, disc, phi, sxx, sxy,
                                        syy, J, Hf, rho, sbxx, sbxy, sbyy, Ny,
                                        Nx, dx, dy, w_t);
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
    pyrmt::advect_kernel<T, FieldPhi<T>>
        <<<nb, pyrmt::kThreads, 0, stream>>>(
            u, v, X1s + o, X2s + o, dt, FieldPhi<T>{phis + o}, buf[0][0],
            buf[0][1], buf[0][2], Ny, Nx, dx, dy);
    PYRMT_RETURN_IF_ERROR();
    int err = pyrmt::run_layers<T>(buf, x1e + o, x2e + o, num_layers, Ny, Nx,
                                   tp, stream);
    if (err) return err;
  }
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
