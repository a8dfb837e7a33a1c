// The implicit integrator steps of the whole-solve kernel: a fixed number of
// undamped Newton steps on a small nonlinear system, with the derivatives of
// the implicit function theorem. Counterpart of the Newton that the JAX
// package runs through lax.custom_root inside the Pallas kernel
// (hilo_mpc_tpu/core/integrators.py:96-118, reached from
// hilo_mpc_tpu/ops/pallas_ip.py:143 through the problem's dyn), and of the
// port's plain newton_solve (hilo_mpc_tpu_torch/core/integrators.py).
//
// ops/codegen_cuda.py emits, per integrator step, two functors over the
// unknowns w (M of them, a compile-time size):
//   rj(w, r, J)   the residual r(w) and its Jacobian J (M x M, row-major) on
//                 plain values: for collocation J is assembled from each
//                 node's Jacobian by one Dual<T, nx + nz> pass per node
//                 (dual.cuh), plus the constant C[j, r]·I blocks;
//   rs(w, c)      the residual in the active scalar type S at the plain w,
//                 (x, u) carrying their tangents.
// newton() runs the steps on plain values; ift() returns w - (c - plain(c))
// with c = J(w)⁻¹·rs(w): its value is w and its derivative -J⁻¹·∂r/∂(x, u),
// the implicit function theorem's (JAX's custom_root jvp). With S = T the
// tangent part vanishes and ift() is the identity, so dyn<T, T> (the
// rollouts and the line search) runs the plain Newton alone.
//
// The linear solves follow ops/smallalg.py:solve_small, which the plain
// version runs: the scaled adjugate for M <= 3 (1 x 1 a division), LU with
// partial pivoting above it (torch.linalg.solve). Every index is known at
// compile time (row swaps are selects over unrolled rows), so J stays in
// registers where the budget allows.
//
// Everything is __host__ __device__: the host C++ compiler builds the same
// code for the CPU tests.
#pragma once

#include <type_traits>

#include "dual.cuh"

namespace hm {

// G·x = b for a plain G (M x M, row-major): factor once, apply to right-hand
// sides of plain or dual type
template <typename T, int M>
struct SmallSolve {
  T a[M * M];
  int piv[M];
  T den;  // M = 2, 3: det · scale of the scaled adjugate

  HM_HD void factor(const T* G) {
    if constexpr (M == 1) {
      a[0] = G[0];
    } else if constexpr (M <= 3) {
      // scale-invariant cofactor solve: G / max|G_ij| (at least 1e-30)
      T s = T(0);
#pragma unroll
      for (int i = 0; i < M * M; ++i) s = m_fmax(s, m_abs(G[i]));
      s = m_fmax(s, T(1e-30));
      T g[9];
#pragma unroll
      for (int i = 0; i < M * M; ++i) g[i] = G[i] / s;
      if constexpr (M == 2) {
        a[0] = g[3];
        a[1] = -g[1];
        a[2] = -g[2];
        a[3] = g[0];
        den = (g[0] * g[3] - g[1] * g[2]) * s;
      } else {
        const T A00 = g[4] * g[8] - g[5] * g[7], A01 = g[2] * g[7] - g[1] * g[8],
                A02 = g[1] * g[5] - g[2] * g[4], A10 = g[5] * g[6] - g[3] * g[8],
                A11 = g[0] * g[8] - g[2] * g[6], A12 = g[2] * g[3] - g[0] * g[5],
                A20 = g[3] * g[7] - g[4] * g[6], A21 = g[1] * g[6] - g[0] * g[7],
                A22 = g[0] * g[4] - g[1] * g[3];
        const T adj[9] = {A00, A01, A02, A10, A11, A12, A20, A21, A22};
#pragma unroll
        for (int i = 0; i < 9; ++i) a[i] = adj[i];
        den = (g[0] * A00 + g[1] * A10 + g[2] * A20) * s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < M * M; ++i) a[i] = G[i];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        // the pivot: the first largest |a_ik| on and below the diagonal
        int p = k;
        T best = m_abs(a[k * M + k]);
#pragma unroll
        for (int i = k + 1; i < M; ++i) {
          const T v = m_abs(a[i * M + k]);
          if (v > best) {
            best = v;
            p = i;
          }
        }
        piv[k] = p;
#pragma unroll
        for (int i = k + 1; i < M; ++i) {
          if (p == i) {
#pragma unroll
            for (int j = 0; j < M; ++j) {
              const T t = a[k * M + j];
              a[k * M + j] = a[i * M + j];
              a[i * M + j] = t;
            }
          }
        }
#pragma unroll
        for (int i = k + 1; i < M; ++i) {
          const T l = a[i * M + k] / a[k * M + k];
          a[i * M + k] = l;
#pragma unroll
          for (int j = k + 1; j < M; ++j) a[i * M + j] = a[i * M + j] - l * a[k * M + j];
        }
      }
    }
  }

  // b <- G⁻¹ b
  template <typename R>
  HM_HD void apply(R* b) const {
    if constexpr (M == 1) {
      b[0] = b[0] / a[0];
    } else if constexpr (M <= 3) {
      R x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        x[i] = a[i * M] * b[0];
#pragma unroll
        for (int j = 1; j < M; ++j) x[i] = x[i] + a[i * M + j] * b[j];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) b[i] = x[i] / den;
    } else {
#pragma unroll
      for (int k = 0; k < M; ++k) {
#pragma unroll
        for (int i = k + 1; i < M; ++i) {
          if (piv[k] == i) {
            const R t = b[k];
            b[k] = b[i];
            b[i] = t;
          }
        }
      }
#pragma unroll
      for (int i = 1; i < M; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j) b[i] = b[i] - a[i * M + j] * b[j];
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
#pragma unroll
        for (int j = i + 1; j < M; ++j) b[i] = b[i] - a[i * M + j] * b[j];
        b[i] = b[i] / a[i * M + i];
      }
    }
  }
};

// w <- ITERS undamped Newton steps from w on rj's residual
template <typename T, int M, int ITERS, typename ResJac>
HM_HD void newton(T* w, const ResJac& rj) {
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    T r[M], J[M * M];
    rj(w, r, J);
    SmallSolve<T, M> s;
    s.factor(J);
    s.apply(r);
#pragma unroll
    for (int i = 0; i < M; ++i) w[i] = w[i] - r[i];
  }
}

// ws = w - (c - plain(c)), c = J(w)⁻¹·rs(w): the value w with the implicit
// function theorem's tangents (none where S is the plain type)
template <typename T, typename S, int M, typename ResJac, typename ResS>
HM_HD void ift(const T* w, S* ws, const ResJac& rj, const ResS& rs) {
  if constexpr (std::is_same<S, T>::value) {
#pragma unroll
    for (int i = 0; i < M; ++i) ws[i] = w[i];
  } else {
    T r[M], J[M * M];
    rj(w, r, J);
    S c[M];
    rs(w, c);
    SmallSolve<T, M> s;
    s.factor(J);
    s.apply(c);
#pragma unroll
    for (int i = 0; i < M; ++i) ws[i] = S(w[i]) - (c[i] - plain(c[i]));
  }
}

}  // namespace hm
