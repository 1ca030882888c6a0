// Stencil device code of the momentum and projection kernels, shared by
// momentum_rk4.cu, momentum_rhs.cu and projection_stencils.cu:
//   bc_u, bc_v     bcs.py's velocity BCs at one cell, from a functor that
//                  gives the pre-BC value at any (j, i)
//   grad           fd.grad_central_{x,y}_2nd at one cell
//   upwind         fd.diff_upwind_3rd at one cell
//   sigma_kernel   the blended stress of physics.velocity_rhs_blended, plus
//                  the Kelvin-Voigt term of physics.momentum_core
//   rhs_at         the momentum RHS of physics.velocity_rhs_blended at one
//                  cell, with or without the external force
// One thread per cell; every expression in the order of the plain PyTorch
// version (built with --fmad=false), so kernel and plain version round
// alike.
#pragma once

#include "common.cuh"

namespace pyrmt {

enum Bc { kNoop = 0, kLid = 1, kFreeSlip = 2 };

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

// sigma = Hf mu_f (grad w + grad w^T) + the pre-blended solid stress, plus
// the Kelvin-Voigt term mkv eta_s (rate of strain) when eta_s > 0 (mkv is
// read only then).
template <typename T>
__global__ void sigma_kernel(const T* wu, const T* wv, const T* sxx_el,
                             const T* sxy_el, const T* syy_el, const T* Hf,
                             const T* mkv, T* sxx, T* sxy, T* syy, int Ny,
                             int Nx, double dx, double dy, double mu_f,
                             double eta_s) {
  long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(Ny) * Nx) return;
  int j = static_cast<int>(n / Nx), i = static_cast<int>(n % Nx);
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  T du_dx = grad(wu, n, 1, i, Nx, inv_x);
  T dv_dy = grad(wv, n, Nx, j, Ny, inv_y);
  T du_dy = grad(wu, n, Nx, j, Ny, inv_y);
  T dv_dx = grad(wv, n, 1, i, Nx, inv_x);
  T a = sxx_el[n], b = syy_el[n], c = sxy_el[n];
  if (eta_s > 0.0) {  // Kelvin-Voigt damping inside the solid
    T m = mkv[n];
    a = a + m * (static_cast<T>(eta_s) * du_dx);
    b = b + m * (static_cast<T>(eta_s) * dv_dy);
    c = c + m * (static_cast<T>(eta_s * 0.5) * (du_dy + dv_dx));
  }
  T h = Hf[n];
  sxx[n] = h * (static_cast<T>(2.0 * mu_f) * du_dx) + a;
  syy[n] = h * (static_cast<T>(2.0 * mu_f) * dv_dy) + b;
  sxy[n] = h * (static_cast<T>(mu_f) * (du_dy + dv_dx)) + c;
}

// -(w.grad)w + (div sigma + f - grad p) / (rho + 1e-12) at cell n = (j, i)
// into (ru, rv); without a force (fx == nullptr) the f term is left out,
// as the slice's momentum_core leaves it out.
template <typename T>
__device__ void rhs_at(const T* wu, const T* wv, const T* sxx, const T* sxy,
                       const T* syy, const T* p, const T* rho, const T* fx,
                       const T* fy, size_t n, int j, int i, int Ny, int Nx,
                       double dx, double dy, T& ru, T& rv) {
  const T inv_x = static_cast<T>(1.0 / (2.0 * dx));
  const T inv_y = static_cast<T>(1.0 / (2.0 * dy));
  const T ih_x = static_cast<T>(1.0 / dx), ih_y = static_cast<T>(1.0 / dy);
  const T i6_x = static_cast<T>(1.0 / (6.0 * dx));
  const T i6_y = static_cast<T>(1.0 / (6.0 * dy));
  T div_x = grad(sxx, n, 1, i, Nx, inv_x) + grad(sxy, n, Nx, j, Ny, inv_y);
  T div_y = grad(sxy, n, 1, i, Nx, inv_x) + grad(syy, n, Nx, j, Ny, inv_y);
  T uc = wu[n], vc = wv[n];
  T u_adv = (-uc) * upwind(wu, n, 1, i, Nx, uc, ih_x, i6_x)
            - vc * upwind(wu, n, Nx, j, Ny, vc, ih_y, i6_y);
  T v_adv = (-uc) * upwind(wv, n, 1, i, Nx, uc, ih_x, i6_x)
            - vc * upwind(wv, n, Nx, j, Ny, vc, ih_y, i6_y);
  T dp_dx = grad(p, n, 1, i, Nx, inv_x);
  T dp_dy = grad(p, n, Nx, j, Ny, inv_y);
  T inv_rho = T(1) / (rho[n] + static_cast<T>(1e-12));
  if (fx) {
    div_x = div_x + fx[n];
    div_y = div_y + fy[n];
  }
  ru = u_adv + (div_x - dp_dx) * inv_rho;
  rv = v_adv + (div_y - dp_dy) * inv_rho;
}

}  // namespace pyrmt
