// Stencil device code of the momentum kernels, shared by momentum_rk4.cu
// and momentum_rhs.cu (projection_stencils.cu takes the Bc codes):
//   bc_u, bc_v     bcs.py's velocity BCs at one cell, from a functor that
//                  gives the pre-BC value at any (j, i)
//   grad           fd.grad_central_{x,y}_2nd at one cell
//   upwind         fd.diff_upwind_3rd at one cell
//   At             a field seen from one cell, in device memory or in a
//                  shared-memory tile (its own flat index and row stride)
//   sigma_at       the blended stress of physics.velocity_rhs_blended, plus
//                  the Kelvin-Voigt term of physics.momentum_core
//   rhs_at         the momentum RHS of physics.velocity_rhs_blended at one
//                  cell, with or without the external force
// Every expression in the order of the plain PyTorch version (built with
// --fmad=false), so kernel and plain version round alike.
#pragma once

#include "common.cuh"

namespace pyrmt {

// kPeriodic: momentum_rk4.cu's periodic instantiation, which reads every
// field through the overlap wrap; bc_u and bc_v leave it as the identity.
enum Bc { kNoop = 0, kLid = 1, kFreeSlip = 2, kPeriodic = 3 };

// bcs.make_lid_bc / free_slip_box_bc / noop_bc, evaluated at one cell.
// `raw(j, i)` is the field before the BC; the free-slip copies read it at
// the neighbour, which is why the BC takes a functor and not a value. The
// u columns are zeroed before the rows are copied, so a free-slip corner
// copies a zero (bcs.py's order).
template <typename T, typename Raw>
__device__ T bc_u(const Raw& raw, int j, int i, int Ny, int Nx, int bc,
                  T lid) {
  if (bc == kLid) {
    bool col_b = i == 0 || i == Nx - 1;
    if (j == Ny - 1 && !col_b) return lid;
    if (col_b || j == 0 || j == Ny - 1) return T(0);
  } else if (bc == kFreeSlip) {
    if (i == 0 || i == Nx - 1) return T(0);
    if (j == 0) return raw(1, i);
    if (j == Ny - 1) return raw(Ny - 2, i);
  }
  return raw(j, i);
}

template <typename T, typename Raw>
__device__ T bc_v(const Raw& raw, int j, int i, int Ny, int Nx, int bc) {
  if (bc == kLid) {
    if (i == 0 || i == Nx - 1 || j == 0 || j == Ny - 1) return T(0);
  } else if (bc == kFreeSlip) {
    if (j == 0 || j == Ny - 1) return T(0);
    if (i == 0) return raw(j, 1);
    if (i == Nx - 1) return raw(j, Nx - 2);
  }
  return raw(j, i);
}

// fd.grad_central_{x,y}_2nd at one cell: central inside, 2nd-order
// one-sided on the boundary column/row. `s` is the stride along the axis,
// `m` the cell's index along it and `n` the axis length.
template <typename T>
__device__ T grad(const T* f, size_t c, size_t s, int m, int n, T inv) {
  if (m == 0) return (T(-3) * f[c] + T(4) * f[c + s] - f[c + 2 * s]) * inv;
  if (m == n - 1)
    return (T(3) * f[c] - T(4) * f[c - s] + f[c - 2 * s]) * inv;
  return (f[c + s] - f[c - s]) * inv;
}

// fd.diff_upwind_3rd at one cell: forward at the first index, backward at
// the last, 1st-order upwind at indices 1 and n-2, 3rd-order upwind-biased
// inside, upwinded by the sign of `vel`.
template <typename T>
__device__ T upwind(const T* f, size_t c, size_t s, int m, int n, T vel,
                    T inv_h, T inv_6h) {
  T f0 = f[c];
  if (m == 0) return (f[c + s] - f0) * inv_h;
  if (m == n - 1) return (f0 - f[c - s]) * inv_h;
  T fp1 = f[c + s], fm1 = f[c - s];
  if (m < 2 || m > n - 3) return vel > 0 ? (f0 - fm1) * inv_h : (fp1 - f0) * inv_h;
  T fp2 = f[c + 2 * s], fm2 = f[c - 2 * s];
  if (vel > 0) return (T(2) * fp1 + T(3) * f0 - T(6) * fm1 + fm2) * inv_6h;
  return (-fp2 + T(6) * fp1 - T(3) * f0 - T(2) * fm1) * inv_6h;
}

// A field seen from one cell: element c of f, with rows sy apart and
// columns adjacent. A device field has sy = Nx; a shared-memory tile its
// own width. The closures of grad and upwind still choose by the cell's
// global index along the axis.
template <typename T>
struct At {
  const T* f;
  size_t c, sy;

  __device__ T operator*() const { return f[c]; }
  __device__ T gx(int i, int Nx, T inv) const {
    return grad(f, c, 1, i, Nx, inv);
  }
  __device__ T gy(int j, int Ny, T inv) const {
    return grad(f, c, sy, j, Ny, inv);
  }
  __device__ T ux(int i, int Nx, T vel, T ih, T i6) const {
    return upwind(f, c, 1, i, Nx, vel, ih, i6);
  }
  __device__ T uy(int j, int Ny, T vel, T ih, T i6) const {
    return upwind(f, c, sy, j, Ny, vel, ih, i6);
  }
};

// sigma = Hf mu_f (grad w + grad w^T) + the pre-blended solid stress
// (a, c, b = its xx, xy, yy at the cell), plus the Kelvin-Voigt term
// mkv eta_s (rate of strain) when eta_s > 0 (mkv[g] is read only then).
template <typename T>
__device__ void sigma_at(At<T> wu, At<T> wv, T a, T c, T b, T h,
                         const T* mkv, size_t g, int j, int i, int Ny, int Nx,
                         double dx, double dy, double mu_f, double eta_s,
                         T& sxx, T& sxy, T& syy) {
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  T du_dx = wu.gx(i, Nx, inv_x);
  T dv_dy = wv.gy(j, Ny, inv_y);
  T du_dy = wu.gy(j, Ny, inv_y);
  T dv_dx = wv.gx(i, Nx, inv_x);
  if (eta_s > 0.0) {  // Kelvin-Voigt damping inside the solid
    T m = mkv[g];
    a = a + m * (static_cast<T>(eta_s) * du_dx);
    b = b + m * (static_cast<T>(eta_s) * dv_dy);
    c = c + m * (static_cast<T>(eta_s * 0.5) * (du_dy + dv_dx));
  }
  sxx = h * (static_cast<T>(2.0 * mu_f) * du_dx) + a;
  syy = h * (static_cast<T>(2.0 * mu_f) * dv_dy) + b;
  sxy = h * (static_cast<T>(mu_f) * (du_dy + dv_dx)) + c;
}

// -(w.grad)w + (div sigma + f - grad p) / (rho + 1e-12) at one cell (j, i)
// into (ru, rv); without a force (fx == nullptr) the f term is left out,
// as physics.momentum_core leaves it out without one. fx, fy are read at g.
// p is an At, or any accessor with At's gx and gy (momentum_rk4.cu's
// wrapped one).
template <typename T, typename PAt = At<T>>
__device__ void rhs_at(At<T> wu, At<T> wv, At<T> sxx, At<T> sxy, At<T> syy,
                       PAt p, T rho, const T* fx, const T* fy, size_t g,
                       int j, int i, int Ny, int Nx, double dx, double dy,
                       T& ru, T& rv) {
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  const T ih_x = static_cast<T>(1.0 / dx), ih_y = static_cast<T>(1.0 / dy);
  const T i6_x = static_cast<T>(1.0 / (6.0 * dx));
  const T i6_y = static_cast<T>(1.0 / (6.0 * dy));
  T div_x = sxx.gx(i, Nx, inv_x) + sxy.gy(j, Ny, inv_y);
  T div_y = sxy.gx(i, Nx, inv_x) + syy.gy(j, Ny, inv_y);
  T uc = *wu, vc = *wv;
  T u_adv = (-uc) * wu.ux(i, Nx, uc, ih_x, i6_x)
            - vc * wu.uy(j, Ny, vc, ih_y, i6_y);
  T v_adv = (-uc) * wv.ux(i, Nx, uc, ih_x, i6_x)
            - vc * wv.uy(j, Ny, vc, ih_y, i6_y);
  T dp_dx = p.gx(i, Nx, inv_x);
  T dp_dy = p.gy(j, Ny, inv_y);
  T inv_rho = T(1) / (rho + static_cast<T>(1e-12));
  if (fx) {
    div_x = div_x + fx[g];
    div_y = div_y + fy[g];
  }
  ru = u_adv + (div_x - dp_dx) * inv_rho;
  rv = v_adv + (div_y - dp_dy) * inv_rho;
}

}  // namespace pyrmt
