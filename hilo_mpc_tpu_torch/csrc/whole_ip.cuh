// The whole box-constrained pure-Newton NMPC interior point, one scenario per
// CUDA thread. Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_ip.py:
// solve_ocp_pallas_full (pallas_call at line 842) and computes what its body
// (lines 334-787) computes, in the same order:
//   init      s = max(|c|, s_min), z = mu0 / s at the initial point
//   per iteration, until converged, diverged or at max_iter:
//     linearize F, [A | B] by one dual-number pass through the emitted
//               integrator step (dual.cuh); cost gradients in closed form
//     KKT       stationarity (scaled by s_d), feasibility, complementarity at
//               mu = 0 and at mu; the barrier update on `subdone` with
//               mu^theta_mu = exp(theta_mu log mu)
//     condense  the box rows into Qb, Rb, qb, rb and the terminal Pt, pt
//     Riccati   backward sweep, G = sym(Rb + Bᵀ P B) + reg I by Cholesky;
//               forward rollout with the multipliers lam
//     step      slack and dual directions, fraction to the boundary (alpha =
//               a_s for the primal, a_z for the duals), the 1e-30 floors, the
//               kappa = 1e10 dual clip, the `finite` guard and the keep rule
//   the objective at the final point.
// The per-scenario loop replaces the TPU kernel's per-lane freeze, so the
// iteration count of every scenario is the one its own test gives.
//
// The problem is a struct P that ops/codegen_cuda.py emits per controller:
// the sizes NX, NU, N, NT, the active box rows (row_mask(k) over the 2NU+2NX
// candidate rows [u-ub; lb-u; x-ub; lb-x] of stage k, row_off(k) their
// first slot, TERM_MASK over [x-ub; lb-x] of the terminal stage), the
// integrator step `dyn` over a scalar or dual type, and the quadratic cost in
// closed form. Every number (bound offsets, weights, references, scalings,
// dt, the IP constants) comes from the device array `prm`, so controllers
// that differ only in numbers share one build. The quadratic cost has no
// x-u cross term, so the Riccati step carries no Hux block.
//
// Design. Stage loops stay loops (#pragma unroll 1); only the NX/NU-sized
// algebra is unrolled. The per-stage state (X, U, lam, s, z, the
// linearization, the Riccati stash K, kff, P, p, the step) is about 30
// values per stage and does not fit in registers: it lives in per-thread
// local arrays, which the hardware interleaves across the threads of a warp,
// so their loads and stores coalesce. Bound: the local-memory traffic of the
// five passes over the horizon per iteration; arithmetic is a few thousand
// FLOPs per stage and iteration. Threads past the batch return at once.
// Scenarios of one warp stop at different iterations (accepted here).
#pragma once

#include <stddef.h>

#include "dual.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HM_HDN __host__ __device__
#else
#define HM_HDN
#endif

namespace hm {

template <typename T>
struct WipIn {
  const T* th;   // (B, N+1, NT)
  const T* x0;   // (B, NX)
  const T* X;    // (B, N+1, NX)
  const T* U;    // (B, N, NU)
  const T* prm;  // the problem's numbers
  T mu0;
};

template <typename T>
struct WipOut {
  T* X;    // (B, N+1, NX)
  T* U;    // (B, N, NU)
  T* lam;  // (B, N, NX)
  T* s;    // (B, max(RS, 1)) active stage rows
  T* z;
  T* sN;   // (B, max(RT, 1)) active terminal rows
  T* zN;
  T* mu;   // (B,)
  T* kkt;
  T* obj;
  int* it;
  unsigned char* conv;
  unsigned char* div;
};

// number of set bits of mask below bit r
HM_HD int popc_below(unsigned mask, int r) {
  const unsigned m = mask & ((1u << r) - 1u);
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

template <typename T>
HM_HD bool finite(T v) {
  return v == v && v - v == T(0);
}

template <typename T, typename P>
HM_HDN void solve_scenario(const WipIn<T>& in, const WipOut<T>& out, size_t b) {
  constexpr int NX = P::NX, NU = P::NU, N = P::N, NT = P::NT;
  constexpr int D = NX + NU;
  constexpr int M = 2 * NU + 2 * NX, MN = 2 * NX;
  constexpr int RS = P::RS > 0 ? P::RS : 1, RT = P::RT > 0 ? P::RT : 1;
  constexpr unsigned TM = P::TERM_MASK;
  // candidate row r of a stage: kind, index, sign; terminal row t likewise
  auto row_u = [](int r) { return r < 2 * NU; };
  auto row_i = [](int r) {
    return r < NU ? r : r < 2 * NU ? r - NU : r < 2 * NU + NX ? r - 2 * NU
                                                              : r - 2 * NU - NX;
  };
  auto row_s = [](int r) {
    return (r < NU || (r >= 2 * NU && r < 2 * NU + NX)) ? T(1) : T(-1);
  };

  const T* prm = in.prm;
  const T* th = in.th + b * (N + 1) * NT;
  const T tol = prm[P::P_TOL], tol10 = prm[P::P_TOL10], reg = prm[P::P_REG];
  const T s_min = prm[P::P_SMIN], keps = prm[P::P_KEPS];
  const T kmu = prm[P::P_KMU], tmu = prm[P::P_TMU];
  const T tau_min = prm[P::P_TAUMIN];
  const int max_iter = static_cast<int>(prm[P::P_MAXIT]);
  const T denom = T(N * NX + N * M + MN);
  const T kap = T(1e10);
  const T* roff = prm + P::P_ROW;   // bound offset of each active stage row
  const T* toff = prm + P::P_TROW;  // ... of each active terminal row

  T X[(N + 1) * NX], U[N * NU], lam[N * NX], s[RS], z[RS], sN[RT], zN[RT];
  for (int i = 0; i < (N + 1) * NX; ++i) X[i] = in.X[b * (N + 1) * NX + i];
#pragma unroll
  for (int i = 0; i < NX; ++i) X[i] = in.x0[b * NX + i];
  for (int i = 0; i < N * NU; ++i) U[i] = in.U[b * N * NU + i];
  for (int i = 0; i < N * NX; ++i) lam[i] = T(0);

  // constraint value of candidate row r of stage k / terminal row t
  auto c_row = [&](int k, int r, int ridx) {
    const T v = row_u(r) ? U[k * NU + row_i(r)] : X[k * NX + row_i(r)];
    return row_s(r) * v + roff[ridx];
  };
  auto c_term = [&](int t, int tidx) {
    const T v = X[N * NX + (t < NX ? t : t - NX)];
    return (t < NX ? T(1) : T(-1)) * v + toff[tidx];
  };

  // ---- initial slacks and duals ---------------------------------------------
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const unsigned mask = P::row_mask(k);
    int ridx = P::row_off(k);
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (!((mask >> r) & 1u)) continue;
      const T si = m_fmax(m_abs(c_row(k, r, ridx)), s_min);
      s[ridx] = si;
      z[ridx] = in.mu0 / si;
      ++ridx;
    }
  }
  {
    int tidx = 0;
#pragma unroll
    for (int t = 0; t < MN; ++t) {
      if (!((TM >> t) & 1u)) continue;
      const T si = m_fmax(m_abs(c_term(t, tidx)), s_min);
      sN[tidx] = si;
      zN[tidx] = in.mu0 / si;
      ++tidx;
    }
  }

  T mu = in.mu0, kkt = T(1e30);
  int it = 0;
  bool conv = false, div = false;

  // per-iteration storage: linearization, Riccati stash, step
  T A[N * NX * NX], Bm[N * NX * NU], rd[N * NX], gx[N * NX], gu[N * NU];
  T K[N * NU * NX], kff[N * NU], Pn[N * NX * NX], pn[N * NX];
  T dX[(N + 1) * NX], dU[N * NU], lamN[N * NX];
  T sc[RS], zc[RS], sNc[RT], zNc[RT], gN[NX];

  while (!conv && !div && it < max_iter) {
    // ---- pass 1: linearize; KKT errors at the current iterate ---------------
    T e_stat = T(0), abs_mult = T(0), e_feas = T(0), comp0 = T(0),
      comp_mu = T(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const T* thk = th + k * NT;
      Dual<T, D> xd[NX], ud[NU], Fd[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xd[i] = Dual<T, D>(X[k * NX + i]);
        xd[i].d[i] = T(1);
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        ud[j] = Dual<T, D>(U[k * NU + j]);
        ud[j].d[NX + j] = T(1);
      }
      P::dyn(xd, ud, thk, prm, Fd);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        rd[k * NX + i] = Fd[i].v - X[(k + 1) * NX + i];
#pragma unroll
        for (int j = 0; j < NX; ++j) A[(k * NX + i) * NX + j] = Fd[i].d[j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Bm[(k * NX + i) * NU + j] = Fd[i].d[NX + j];
      }
      P::stage_grad(X + k * NX, U + k * NU, thk, prm, gx + k * NX, gu + k * NU);

      const unsigned mask = P::row_mask(k);
      const int r0 = P::row_off(k);
      // r_u = gu + Bᵀ lam + Cuᵀ z
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T r = gu[k * NU + j];
#pragma unroll
        for (int i = 0; i < NX; ++i) r = r + Bm[(k * NX + i) * NU + j] * lam[k * NX + i];
        if ((mask >> j) & 1u) r = r + z[r0 + popc_below(mask, j)];
        if ((mask >> (NU + j)) & 1u) r = r - z[r0 + popc_below(mask, NU + j)];
        e_stat = m_fmax(e_stat, m_abs(r));
      }
      // r_x (k >= 1) = gx + Aᵀ lam - lam_{k-1} + Cxᵀ z
      if (k >= 1) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T r = gx[k * NX + i] - lam[(k - 1) * NX + i];
#pragma unroll
          for (int l = 0; l < NX; ++l) r = r + A[(k * NX + l) * NX + i] * lam[k * NX + l];
          if ((mask >> (2 * NU + i)) & 1u) r = r + z[r0 + popc_below(mask, 2 * NU + i)];
          if ((mask >> (2 * NU + NX + i)) & 1u)
            r = r - z[r0 + popc_below(mask, 2 * NU + NX + i)];
          e_stat = m_fmax(e_stat, m_abs(r));
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) abs_mult = abs_mult + m_abs(lam[k * NX + i]);
      int ridx = r0;
#pragma unroll
      for (int r = 0; r < M; ++r)
        if ((mask >> r) & 1u) abs_mult = abs_mult + m_abs(z[ridx++]);
#pragma unroll
      for (int i = 0; i < NX; ++i) e_feas = m_fmax(e_feas, m_abs(rd[k * NX + i]));
      ridx = r0;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!((mask >> r) & 1u)) continue;
        const T si = s[ridx], zi = z[ridx];
        e_feas = m_fmax(e_feas, m_abs(c_row(k, r, ridx) + si));
        const T sz = si * zi;
        comp0 = m_fmax(comp0, m_abs(sz));
        comp_mu = m_fmax(comp_mu, m_abs(sz - mu));
        ++ridx;
      }
    }
    P::term_grad(X + N * NX, th + N * NT, prm, gN);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T r = gN[i] - lam[(N - 1) * NX + i];
      if ((TM >> i) & 1u) r = r + zN[popc_below(TM, i)];
      if ((TM >> (NX + i)) & 1u) r = r - zN[popc_below(TM, NX + i)];
      e_stat = m_fmax(e_stat, m_abs(r));
    }
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t)
        if ((TM >> t) & 1u) abs_mult = abs_mult + m_abs(zN[tidx++]);
      tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!((TM >> t) & 1u)) continue;
        const T si = sN[tidx], zi = zN[tidx];
        e_feas = m_fmax(e_feas, m_abs(c_term(t, tidx) + si));
        const T sz = si * zi;
        comp0 = m_fmax(comp0, m_abs(sz));
        comp_mu = m_fmax(comp_mu, m_abs(sz - mu));
        ++tidx;
      }
    }
    const T s_d = m_fmax(T(1), abs_mult / denom);
    e_stat = e_stat / s_d;
    const T base = m_fmax(e_stat, e_feas);
    const T err0 = m_fmax(base, comp0 / s_d);
    const T err_mu = m_fmax(base, comp_mu / s_d);
    const bool converged = err0 <= tol;
    const bool subdone = err_mu <= keps * mu;
    const T mu_pow = m_exp(tmu * m_log(mu));
    const T mu_new = subdone ? m_fmax(tol10, m_fmin(kmu * mu, mu_pow)) : mu;

    // ---- pass 2: condensation and the backward Riccati sweep ----------------
    T Pm[NX][NX], pv[NX];
    P::term_hess(prm, &Pm[0][0]);
#pragma unroll
    for (int i = 0; i < NX; ++i) pv[i] = gN[i];
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!((TM >> t) & 1u)) continue;
        const int i = t < NX ? t : t - NX;
        const T si = sN[tidx], zi = zN[tidx];
        const T r_in = c_term(t, tidx) + si;
        Pm[i][i] = Pm[i][i] + zi / si;
        pv[i] = pv[i] + (t < NX ? T(1) : T(-1)) * ((mu_new + zi * r_in) / si);
        ++tidx;
      }
    }
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      T Qb[NX][NX], Rb[NU][NU], qb[NX], rb[NU];
      P::stage_hess(th + k * NT, prm, &Qb[0][0], &Rb[0][0]);
#pragma unroll
      for (int i = 0; i < NX; ++i) qb[i] = gx[k * NX + i];
#pragma unroll
      for (int j = 0; j < NU; ++j) rb[j] = gu[k * NU + j];
      const unsigned mask = P::row_mask(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!((mask >> r) & 1u)) continue;
        const int i = row_i(r);
        const T si = s[ridx], zi = z[ridx];
        const T sigma = zi / si;
        const T r_in = c_row(k, r, ridx) + si;
        const T zh = (mu_new + zi * r_in) / si;
        if (row_u(r)) {
          Rb[i][i] = Rb[i][i] + sigma;
          rb[i] = rb[i] + row_s(r) * zh;
        } else {
          Qb[i][i] = Qb[i][i] + sigma;
          qb[i] = qb[i] + row_s(r) * zh;
        }
        ++ridx;
      }
      const T* Ak = A + k * NX * NX;
      const T* Bk = Bm + k * NX * NU;
      const T* ck = rd + k * NX;
      T Pc_p[NX], PA[NX][NX], PB[NX][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a = a + Pm[i][l] * ck[l];
        Pc_p[i] = a + pv[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Pm[i][l] * Ak[l * NX + j];
          PA[i][j] = e;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Pm[i][l] * Bk[l * NU + j];
          PB[i][j] = e;
        }
      }
      T G[NU][NU], Gs[NU][NU], Hux[NU][NX], g_u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Bk[l * NU + i] * PB[l][j];
          G[i][j] = Rb[i][j] + e;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Bk[l * NU + i] * PA[l][j];
          Hux[i][j] = e;
        }
        T e = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) e = e + Bk[l * NU + i] * Pc_p[l];
        g_u[i] = rb[i] + e;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j)
          Gs[i][j] = T(0.5) * (G[i][j] + G[j][i]) + (i == j ? reg : T(0));
      // G [K | kff] = -[Hux | g_u] by Cholesky G = L Lᵀ
      T L[NU][NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          T a = Gs[i][j];
#pragma unroll
          for (int l = 0; l < j; ++l) a = a - L[i][l] * L[j][l];
          L[i][j] = (i == j) ? m_sqrt(a) : a / L[j][j];
        }
      }
      T Xc[NU][NX + 1];
#pragma unroll
      for (int m = 0; m <= NX; ++m) {
        T Y[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T a = (m < NX) ? Hux[i][m] : g_u[i];
#pragma unroll
          for (int l = 0; l < i; ++l) a = a - L[i][l] * Y[l];
          Y[i] = a / L[i][i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          T a = Y[i];
#pragma unroll
          for (int l = i + 1; l < NU; ++l) a = a - L[l][i] * Xc[l][m];
          Xc[i][m] = a / L[i][i];
        }
      }
      T Kk[NU][NX], kk[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          Kk[i][j] = -Xc[i][j];
          K[(k * NU + i) * NX + j] = Kk[i][j];
        }
        kk[i] = -Xc[i][NX];
        kff[k * NU + i] = kk[i];
      }
      // stash (P, p)_{k+1} for the multipliers of the forward pass
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        pn[k * NX + i] = pv[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) Pn[(k * NX + i) * NX + j] = Pm[i][j];
      }
      T Pnew[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e1 = T(0), e2 = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e1 = e1 + Ak[l * NX + i] * PA[l][j];
#pragma unroll
          for (int l = 0; l < NU; ++l) e2 = e2 + Hux[l][i] * Kk[l][j];
          Pnew[i][j] = Qb[i][j] + e1 + e2;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Pm[i][j] = T(0.5) * (Pnew[i][j] + Pnew[j][i]);
        T e1 = T(0), e2 = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) e1 = e1 + Ak[l * NX + i] * Pc_p[l];
#pragma unroll
        for (int l = 0; l < NU; ++l) e2 = e2 + Hux[l][i] * kk[l];
        pv[i] = qb[i] + e1 + e2;
      }
    }

    // ---- pass 3: forward rollout, directions, fraction to the boundary ------
    const T tau = m_fmax(tau_min, T(1) - mu_new);
    T a_s = T(1), a_z = T(1);
    auto ratio = [&](T v, T dv) {
      return dv < T(0) ? -tau * v / m_fmin(dv, T(-1e-30)) : T(1);
    };
#pragma unroll
    for (int i = 0; i < NX; ++i) dX[i] = T(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T dx[NX], du[NU], dxn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = dX[k * NX + i];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + K[(k * NU + i) * NX + j] * dx[j];
        du[i] = a + kff[k * NU + i];
        dU[k * NU + i] = du[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0), e = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + A[(k * NX + i) * NX + j] * dx[j];
#pragma unroll
        for (int j = 0; j < NU; ++j) e = e + Bm[(k * NX + i) * NU + j] * du[j];
        dxn[i] = a + e + rd[k * NX + i];
        dX[(k + 1) * NX + i] = dxn[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + Pn[(k * NX + i) * NX + j] * dxn[j];
        lamN[k * NX + i] = a + pn[k * NX + i];
      }
      const unsigned mask = P::row_mask(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!((mask >> r) & 1u)) continue;
        const T dC = row_s(r) * (row_u(r) ? du[row_i(r)] : dx[row_i(r)]);
        const T si = s[ridx], zi = z[ridx];
        const T r_in = c_row(k, r, ridx) + si;
        const T ds = -r_in - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        a_s = m_fmin(a_s, ratio(si, ds));
        a_z = m_fmin(a_z, ratio(zi, dz));
        ++ridx;
      }
    }
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!((TM >> t) & 1u)) continue;
        const T dC = (t < NX ? T(1) : T(-1)) * dX[N * NX + (t < NX ? t : t - NX)];
        const T si = sN[tidx], zi = zN[tidx];
        const T r_in = c_term(t, tidx) + si;
        const T ds = -r_in - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        a_s = m_fmin(a_s, ratio(si, ds));
        a_z = m_fmin(a_z, ratio(zi, dz));
        ++tidx;
      }
    }
    const T alpha = a_s;

    // ---- pass 4: the candidate point and the finite guard -------------------
    bool fin = true;
    auto dual_cand = [&](T si, T zi, T ds, T dz, T* s_out, T* z_out) {
      const T sn = m_fmax(si + alpha * ds, T(1e-30));
      T zn = m_fmax(zi + a_z * dz, T(1e-30));
      zn = m_fmin(m_fmax(zn, mu_new / (kap * sn)), kap * mu_new / sn);
      fin = fin && finite(zn);
      *s_out = sn;
      *z_out = zn;
    };
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const unsigned mask = P::row_mask(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!((mask >> r) & 1u)) continue;
        const T dC = row_s(r) * (row_u(r) ? dU[k * NU + row_i(r)]
                                          : dX[k * NX + row_i(r)]);
        const T si = s[ridx], zi = z[ridx];
        const T ds = -(c_row(k, r, ridx) + si) - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        dual_cand(si, zi, ds, dz, &sc[ridx], &zc[ridx]);
        ++ridx;
      }
    }
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!((TM >> t) & 1u)) continue;
        const T dC = (t < NX ? T(1) : T(-1)) * dX[N * NX + (t < NX ? t : t - NX)];
        const T si = sN[tidx], zi = zN[tidx];
        const T ds = -(c_term(t, tidx) + si) - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        dual_cand(si, zi, ds, dz, &sNc[tidx], &zNc[tidx]);
        ++tidx;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) fin = fin && finite(X[i]);
    for (int i = NX; i < (N + 1) * NX; ++i) {
      dX[i] = X[i] + alpha * dX[i];
      fin = fin && finite(dX[i]);
    }
    for (int i = 0; i < N * NU; ++i) {
      dU[i] = U[i] + alpha * dU[i];
      fin = fin && finite(dU[i]);
    }

    // ---- pass 5: take the step unless converged or non-finite ---------------
    if (!(converged || !fin)) {
      for (int i = NX; i < (N + 1) * NX; ++i) X[i] = dX[i];
      for (int i = 0; i < N * NU; ++i) U[i] = dU[i];
      for (int i = 0; i < N * NX; ++i) lam[i] = lamN[i];
      for (int i = 0; i < P::RS; ++i) {
        s[i] = sc[i];
        z[i] = zc[i];
      }
      for (int i = 0; i < P::RT; ++i) {
        sN[i] = sNc[i];
        zN[i] = zNc[i];
      }
    }
    mu = mu_new;
    kkt = err0;
    it += 1;
    conv = converged;
    div = div || !fin;
  }

  // ---- objective at the final point and the outputs -------------------------
  T obj = T(0);
#pragma unroll 1
  for (int k = 0; k < N; ++k)
    obj = obj + P::stage_cost(X + k * NX, U + k * NU, th + k * NT, prm);
  obj = obj + P::term_cost(X + N * NX, th + N * NT, prm);

  for (int i = 0; i < (N + 1) * NX; ++i) out.X[b * (N + 1) * NX + i] = X[i];
  for (int i = 0; i < N * NU; ++i) out.U[b * N * NU + i] = U[i];
  for (int i = 0; i < N * NX; ++i) out.lam[b * N * NX + i] = lam[i];
  for (int i = 0; i < RS; ++i) {
    out.s[b * RS + i] = P::RS > 0 ? s[i] : T(1);
    out.z[b * RS + i] = P::RS > 0 ? z[i] : T(1);
  }
  for (int i = 0; i < RT; ++i) {
    out.sN[b * RT + i] = P::RT > 0 ? sN[i] : T(1);
    out.zN[b * RT + i] = P::RT > 0 ? zN[i] : T(1);
  }
  out.mu[b] = mu;
  out.kkt[b] = kkt;
  out.obj[b] = obj;
  out.it[b] = it;
  out.conv[b] = conv ? 1 : 0;
  out.div[b] = div ? 1 : 0;
}

// F and [A | B] of one stage by the dual pass (for the host-side tests)
template <typename T, typename P>
void dyn_lin(const T* xs, const T* us, const T* th, const T* prm, T* F, T* AB) {
  constexpr int NX = P::NX, NU = P::NU, D = NX + NU;
  Dual<T, D> xd[NX], ud[NU], Fd[NX];
  for (int i = 0; i < NX; ++i) {
    xd[i] = Dual<T, D>(xs[i]);
    xd[i].d[i] = T(1);
  }
  for (int j = 0; j < NU; ++j) {
    ud[j] = Dual<T, D>(us[j]);
    ud[j].d[NX + j] = T(1);
  }
  P::dyn(xd, ud, th, prm, Fd);
  for (int i = 0; i < NX; ++i) {
    F[i] = Fd[i].v;
    for (int j = 0; j < D; ++j) AB[i * D + j] = Fd[i].d[j];
  }
}

template <typename T>
WipIn<T> wip_in(const void* th, const void* x0, const void* X, const void* U,
                const void* prm, double mu0) {
  return WipIn<T>{static_cast<const T*>(th), static_cast<const T*>(x0),
                  static_cast<const T*>(X), static_cast<const T*>(U),
                  static_cast<const T*>(prm), static_cast<T>(mu0)};
}

template <typename T>
WipOut<T> wip_out(void* X, void* U, void* lam, void* s, void* z, void* sN,
                  void* zN, void* mu, void* kkt, void* obj, void* it,
                  void* conv, void* div) {
  return WipOut<T>{static_cast<T*>(X), static_cast<T*>(U), static_cast<T*>(lam),
                   static_cast<T*>(s), static_cast<T*>(z), static_cast<T*>(sN),
                   static_cast<T*>(zN), static_cast<T*>(mu), static_cast<T*>(kkt),
                   static_cast<T*>(obj), static_cast<int*>(it),
                   static_cast<unsigned char*>(conv),
                   static_cast<unsigned char*>(div)};
}

#ifdef __CUDACC__
template <typename T, typename P>
__global__ void __launch_bounds__(128)
whole_ip_kernel(WipIn<T> in, WipOut<T> out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  solve_scenario<T, P>(in, out, static_cast<size_t>(b));
}

template <typename T, typename P>
int whole_ip_launch(const WipIn<T>& in, const WipOut<T>& out, int B,
                    void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  whole_ip_kernel<T, P><<<(B + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(in, out, B);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace hm

// The C entry points of one generated problem (bound with ctypes). On the
// card: whole_ip_f32 / whole_ip_f64 enqueue the kernel on `stream` and return
// its cudaError_t. On the host: whole_ip_host_f32 / _f64 run the same
// per-scenario solve in a loop, dyn_lin_host_f64 the dual pass.
#define HM_WIP_ARGS                                                          \
  const void *th, const void *x0, const void *X, const void *U,              \
      const void *prm, double mu0, void *Xo, void *Uo, void *lamo, void *so, \
      void *zo, void *sNo, void *zNo, void *mu, void *kkt, void *obj,        \
      void *it, void *conv, void *div, int B
#define HM_WIP_IN(T) hm::wip_in<T>(th, x0, X, U, prm, mu0)
#define HM_WIP_OUT(T) \
  hm::wip_out<T>(Xo, Uo, lamo, so, zo, sNo, zNo, mu, kkt, obj, it, conv, div)

#ifdef __CUDACC__
#define HM_WHOLE_IP_EXPORTS(P)                                               \
  extern "C" int whole_ip_f32(HM_WIP_ARGS, void* stream) {                   \
    return hm::whole_ip_launch<float, P>(HM_WIP_IN(float), HM_WIP_OUT(float), \
                                         B, stream);                         \
  }                                                                          \
  extern "C" int whole_ip_f64(HM_WIP_ARGS, void* stream) {                   \
    return hm::whole_ip_launch<double, P>(HM_WIP_IN(double),                 \
                                          HM_WIP_OUT(double), B, stream);     \
  }
#else
#define HM_WHOLE_IP_EXPORTS(P)                                               \
  extern "C" int whole_ip_host_f32(HM_WIP_ARGS) {                            \
    for (int b = 0; b < B; ++b)                                              \
      hm::solve_scenario<float, P>(HM_WIP_IN(float), HM_WIP_OUT(float), b);  \
    return 0;                                                                \
  }                                                                          \
  extern "C" int whole_ip_host_f64(HM_WIP_ARGS) {                            \
    for (int b = 0; b < B; ++b)                                              \
      hm::solve_scenario<double, P>(HM_WIP_IN(double), HM_WIP_OUT(double), b); \
    return 0;                                                                \
  }                                                                          \
  extern "C" int dyn_lin_host_f64(const double* xs, const double* us,        \
                                  const double* th, const double* prm,       \
                                  double* F, double* AB, int B) {            \
    for (int b = 0; b < B; ++b)                                              \
      hm::dyn_lin<double, P>(xs + b * P::NX, us + b * P::NU, th + b * P::NT, \
                             prm, F + b * P::NX,                             \
                             AB + b * P::NX * (P::NX + P::NU));              \
    return 0;                                                                \
  }
#endif
