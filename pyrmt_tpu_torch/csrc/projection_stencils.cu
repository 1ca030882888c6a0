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
// One launch each, one thread per cell. The TPU kernels' row tiles with a
// 2-row halo become plain neighbour reads: each thread recomputes the four
// faces around its cell (rc_rhs), or, at a free-slip wall, the corrected
// value of the neighbour that the BC copies (grad_correct), with that
// neighbour's own interior/boundary mask. dt and d are 0-d device tensors
// read in the kernel, so the step never waits for the card.
//
// What bounds it on the H100: device-memory traffic. rc_rhs reads 4 fields
// and writes 1, grad_correct reads 4 and writes 2, with ~60 and ~15 flops
// per cell; the recomputed neighbours hit L1/L2. Two launches in place of
// the 116 PyTorch ops of the plain stencil chains (54 and 62, the lid BC
// included).
//
// Rounding: built with --fmad=false, every expression in the plain
// version's order. The plain version keeps the JAX package's division by
// dx and dy (so that it stays close to JAX on the CPU); PyTorch on CUDA
// evaluates x / c, c a Python float, as x * r with r = 1 / c taken in
// double and rounded to the tensor's dtype, and so does this kernel (rdx,
// rdy). (1.0f / float(dx) is another float at N=256: the kernel computed
// that first and differed from the plain version by an ulp there.)
#include "stencil_device.cuh"

namespace {

using pyrmt::grad;

// The Rhie-Chow face velocity between cell c and cell c + s (index m and
// m + 1 of n along the axis of stride s).
template <typename T>
__device__ T rc_face(const T* a, const T* p, T d, size_t c, size_t s, int m,
                     int n, T inv2, T rh) {
  T g0 = grad(p, c, s, m, n, inv2);
  T g1 = grad(p, c + s, s, m + 1, n, inv2);
  return T(0.5) * (a[c] + a[c + s])
         - d * ((p[c + s] - p[c]) * rh - T(0.5) * (g0 + g1));
}

template <typename T>
__global__ void rc_rhs_kernel(const T* a, const T* b, const T* p,
                              const T* rho, const T* dt, const T* d_scalar,
                              T* out, int Ny, int Nx, T inv2x, T inv2y,
                              T rdx, T rdy) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  if (j == 0 || j == Ny - 1 || i == 0 || i == Nx - 1) {
    out[n] = T(0);
    return;
  }
  const T d = d_scalar[0];
  const size_t sy = static_cast<size_t>(Nx);
  T div = (rc_face(a, p, d, n, 1, i, Nx, inv2x, rdx)
           - rc_face(a, p, d, n - 1, 1, i - 1, Nx, inv2x, rdx)) * rdx
          + (rc_face(b, p, d, n, sy, j, Ny, inv2y, rdy)
             - rc_face(b, p, d, n - sy, sy, j - 1, Ny, inv2y, rdy)) * rdy;
  out[n] = rho[n] * div / dt[0];
}

// a - (dt / rho) dp/dx (x) or b - (dt / rho) dp/dy (y) at any cell: the
// field before the BC, which the BC reads at the cell and its neighbour.
template <typename T>
struct Corrected {
  const T* f;
  const T* pc;
  const T* rho;
  T dt;
  int Ny, Nx;
  bool x;
  T inv2;
  __device__ T operator()(int j, int i) const {
    size_t c = static_cast<size_t>(j) * Nx + i;
    T g = T(0);
    if (x) {
      if (i == 0 || i == Nx - 1 || (j > 0 && j < Ny - 1))
        g = grad(pc, c, 1, i, Nx, inv2);
    } else if (j == 0 || j == Ny - 1 || (i > 0 && i < Nx - 1)) {
      g = grad(pc, c, static_cast<size_t>(Nx), j, Ny, inv2);
    }
    return f[c] - (dt / rho[c]) * g;
  }
};

template <typename T>
__global__ void grad_correct_kernel(const T* pc, const T* a, const T* b,
                                    const T* rho, const T* dt, T* a_out,
                                    T* b_out, int Ny, int Nx, T inv2x,
                                    T inv2y, int bc, T lid) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T h = dt[0];
  Corrected<T> ca{a, pc, rho, h, Ny, Nx, true, inv2x};
  Corrected<T> cb{b, pc, rho, h, Ny, Nx, false, inv2y};
  a_out[n] = pyrmt::bc_u<T>(ca, j, i, Ny, Nx, bc, lid);
  b_out[n] = pyrmt::bc_v<T>(cb, j, i, Ny, Nx, bc);
}

template <typename T>
int launch_rc_rhs(const T* a, const T* b, const T* p, const T* rho,
                  const T* dt, const T* d_scalar, T* out, int Ny, int Nx,
                  double dx, double dy, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long N = static_cast<long long>(Ny) * Nx;
  rc_rhs_kernel<T><<<pyrmt::blocks_for(N), pyrmt::kThreads, 0, stream>>>(
      a, b, p, rho, dt, d_scalar, out, Ny, Nx,
      static_cast<T>(1.0 / (2.0 * dx)), static_cast<T>(1.0 / (2.0 * dy)),
      static_cast<T>(1.0 / dx), static_cast<T>(1.0 / dy));
  PYRMT_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int launch_grad_correct(const T* pc, const T* a, const T* b, const T* rho,
                        const T* dt, T* a_out, T* b_out, int Ny, int Nx,
                        double dx, double dy, int bc, double lid,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long N = static_cast<long long>(Ny) * Nx;
  grad_correct_kernel<T><<<pyrmt::blocks_for(N), pyrmt::kThreads, 0,
                           stream>>>(
      pc, a, b, rho, dt, a_out, b_out, Ny, Nx,
      static_cast<T>(1.0 / (2.0 * dx)), static_cast<T>(1.0 / (2.0 * dy)), bc,
      static_cast<T>(lid));
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
