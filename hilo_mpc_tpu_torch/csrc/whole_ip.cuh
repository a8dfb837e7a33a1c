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
// The problem is a struct P that ops/codegen_cuda.py emits per controller
// (or ops/codegen_fx.py from a torch.fx trace, its costs' derivatives by
// the dual numbers of traced.cuh):
// the sizes NX, NU, N, NT, the active box rows (row_mask(k, w): word w of
// RW 32-bit words over the 2NU+2NX candidate rows [u-ub; lb-u; x-ub; lb-x]
// of stage k, row r being bit r & 31 of word r >> 5; row_off(k) their first
// slot; term_mask(w), word w of RTW over [x-ub; lb-x] of the terminal
// stage), the
// integrator step `dyn` over a scalar or dual type (an implicit step, a
// collocation or a DAE's algebraic Newton, runs its Newton inside it:
// csrc/implicit.cuh), and the cost in closed
// form: the quadratic terms and the soft state bounds' relu² penalty, whose
// Hessian depends on the point, so stage_hess and term_hess take it (a
// problem without soft bounds ignores it). Every number (bound offsets, weights, references, scalings,
// dt, the IP constants) comes from the device array `prm`, so controllers
// that differ only in numbers share one build. A cost with an x-u cross
// term (an input term of the Δu-augmented problem, whose e = u_prev + Δu
// couples the state's u_prev with the control) sets P::CROSS; stage_hess
// then also writes that block S = d²l/du dx (NU x NX), and the Riccati step
// forms Hux = S + BᵀPA, as the TPU kernel's Huxk (pallas_ip.py:571), which
// the gain, the P update and the forward pass take unchanged. Without it
// (P::CROSS false) Hux = BᵀPA and the build is what it was before.
//
// Bound. Per scenario-iteration the algorithm does ~21,000 operations at the
// flagship (N=20, nx=2, nu=1, RK4; EmittedProblem.flops) on a few hundred
// values of state, so the operations bound it (0.17 ms at B=131072 in
// float32); the inputs and outputs cross HBM once. On the card the limit is
// the issue rate of one long serial chain per thread: ~100 registers in
// float32 and ~190 in float64 allow 10-18 warps per SM, which hide little
// of the latency of dependent arithmetic. The first design also kept ~770 values
// per scenario in thread-local arrays (local memory, through L2 and HBM:
// the resident threads' state was twice the 50 MB L2). The TPU kernel kept
// every per-stage quantity in VMEM.
//
// Design. The same per-scenario arithmetic, the state carried less and
// placed for Hopper:
//  - the candidate point is only checked for finiteness (pass 4) and
//    recomputed in place by the accepting pass (pass 5), from the same
//    formulas; the new multipliers are recomputed there from the stash; P's
//    stash is its upper triangle; the gradients gx, gu are recomputed in the
//    pass that uses them. The linearization of each stage (A, B,
//    F - x_{k+1}) is computed once per iteration, in the KKT pass, and kept
//    for the backward and forward passes. What remains per scenario (WipLay
//    below): theta, X, U, lam, the active rows' s and z, the stash (K, kff,
//    P upper, p), the direction (dX, dU) and the linearization: 730 values
//    at the flagship, theta 168 of them;
//  - that region is scenario-minor in a global scratch the wrapper
//    allocates: a block owns a tile of P::TB scenarios, and element e of
//    its scenario s sits at region[e * TB + s], so a warp's accesses are 32
//    consecutive words;
//  - the tile's inputs (theta, X, U) are one contiguous run each in the
//    batch-first layout: the block copies them word by word (thread t takes
//    words t, t+TB, ...: coalesced) into the region, and stores X, U, lam
//    and the slacks and duals (in the full row layout, masked rows at 1.0)
//    back the same way. No thread-local array remains: the per-stage algebra
//    (the dual pass, P, the Schur complement) lives in registers, every index
//    known at compile time;
//  - __launch_bounds__(P::TB, MINB): tiles of 64; in float32 8 blocks (16
//    warps) per SM, at most 128 registers a thread; float64 spills at that
//    budget and at 5 blocks, so it asks for 4 (~190 registers, no spills).
// ops/codegen_cuda.py writes TB and MINB into the problem. They were chosen
// by timing on an H100 (PERF.md): the region in shared memory (2-3 one-warp
// blocks per SM), 8 warps per SM in float32, recomputing the linearization
// in each pass, and refilling finished lanes from a counter all ran slower.
//
// The block schedule is __host__ __device__: compiled with the host C++
// compiler (ops/_build.py:host_library_path) it runs tile by tile, threads in
// a loop, ragged last tile included, so the CPU tests reach the region
// layout. The launcher takes PyTorch's current stream, allocates nothing and
// never synchronizes.
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
  T* s;    // (B, N, 2NU+2NX): every candidate row, 1.0 where masked
  T* z;
  T* sN;   // (B, 2NX)
  T* zN;
  T* mu;   // (B,)
  T* kkt;
  T* obj;
  int* it;
  unsigned char* conv;
  int* status;  // 0 converged, 1 max_iter, 2 diverged
};

// Offsets of one scenario's region (elements; scenario-minor, stride TB).
template <typename P>
struct WipLay {
  static constexpr int NX = P::NX, NU = P::NU, N = P::N, NT = P::NT;
  static constexpr int NTRI = NX * (NX + 1) / 2;
  static constexpr int TH = 0, X = TH + (N + 1) * NT, U = X + (N + 1) * NX;
  static constexpr int LAM = U + N * NU, S = LAM + N * NX, Z = S + P::RS;
  static constexpr int SN = Z + P::RS, ZN = SN + P::RT;
  static constexpr int K = ZN + P::RT, KF = K + N * NU * NX, PU = KF + N * NU;
  static constexpr int PV = PU + N * NTRI, DX = PV + N * NX, DU = DX + N * NX;
  static constexpr int LW = NX * NX + NX * NU + NX;  // one stage's linearization
  static constexpr int AB = DU + N * NU, E = AB + N * LW;
  // slot of P[i][j], i <= j, in a stage's upper triangle (row-major)
  HM_HD static int tri(int i, int j) { return i * NX - i * (i - 1) / 2 + (j - i); }
};

HM_HD int popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The active rows of a stage (or of the terminal stage) as W 32-bit words:
// row r is bit r & 31 of word r >> 5. In the solve every r is known at
// compile time (its loops over rows are unrolled), so each test is one bit
// of one register and a one-word mask compiles to the single-word tests;
// only the stores of the slacks and duals (stage_slot, term_slot) ask with
// a run-time r.
template <int W>
struct RowMask {
  unsigned w[W];
  HM_HD bool has(int r) const { return (w[r >> 5] >> (r & 31)) & 1u; }
  // the number of active rows below row r: whole words, then the partial one
  HM_HD int below(int r) const {
    int c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < (r >> 5)) c += popc(w[i]);
    return c + popc(w[r >> 5] & ((1u << (r & 31)) - 1u));
  }
};
template <typename P>
HM_HD RowMask<P::RW> stage_rows(int k) {
  RowMask<P::RW> m;
#pragma unroll
  for (int i = 0; i < P::RW; ++i) m.w[i] = P::row_mask(k, i);
  return m;
}
template <typename P>
HM_HD RowMask<P::RTW> term_rows() {
  RowMask<P::RTW> m;
#pragma unroll
  for (int i = 0; i < P::RTW; ++i) m.w[i] = P::term_mask(i);
  return m;
}

template <typename T>
HM_HD bool finite(T v) {
  return v == v && v - v == T(0);
}

// f(t) for this thread on the card; for every thread of the block, in order,
// on the host
template <int TB, typename F>
HM_HD void each_thread(const F& f) {
#ifdef __CUDA_ARCH__
  f(static_cast<int>(threadIdx.x));
#else
  for (int t = 0; t < TB; ++t) f(t);
#endif
}

HM_HD void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// Thread t's share of copying the tile's runs of L words (scenario s's run at
// g + (b0+s)·L) into rows w·TB + s of `rows`: words t, t+TB, ... of the
// tile's nb·L contiguous words, so a warp's loads coalesce.
template <typename T, int TB>
HM_HD void load_runs(T* rows, const T* g, int L, int b0, int nb, int t) {
  const T* src = g + static_cast<size_t>(b0) * L;
  for (int idx = t; idx < nb * L; idx += TB) {
    const int s = idx / L, w = idx - s * L;
    rows[w * TB + s] = src[idx];
  }
}

// The reverse into runs of Lo words per scenario: word w of a scenario's run
// is row slot(w) of `rows`, or 1.0 where slot(w) < 0 (a masked slack row).
template <typename T, int TB, typename Slot>
HM_HD void store_runs(T* g, const T* rows, int Lo, int b0, int nb, int t,
                      const Slot& slot) {
  T* dst = g + static_cast<size_t>(b0) * Lo;
  for (int idx = t; idx < nb * Lo; idx += TB) {
    const int s = idx / Lo, w = idx - s * Lo;
    const int r = slot(w);
    dst[idx] = r >= 0 ? rows[r * TB + s] : T(1);
  }
}

// The region slot of word w of a scenario's full slack layout: stage rows
// (N, 2NU+2NX) and terminal rows (2NX); -1 for a masked row
template <typename P>
HM_HD int stage_slot(int w) {
  constexpr int M = 2 * P::NU + 2 * P::NX;
  const int k = w / M, r = w - k * M;
  const RowMask<P::RW> mask = stage_rows<P>(k);
  return mask.has(r) ? P::row_off(k) + mask.below(r) : -1;
}
template <typename P>
HM_HD int term_slot(int t) {
  const RowMask<P::RTW> tm = term_rows<P>();
  return tm.has(t) ? tm.below(t) : -1;
}

// The solve of scenario b by one thread; st points at its column of the
// block's region (element e at st[e * LD]), into which the block has loaded
// the scenario's theta, X and U (wip_block). Writes the scalar outputs; the
// block stores the rest from the region.
template <typename T, typename P, int LD>
HM_HDN void solve_lane(const WipIn<T>& in, const WipOut<T>& out, T* st, size_t b) {
  using Lay = WipLay<P>;
  constexpr int NX = P::NX, NU = P::NU, N = P::N, NT = P::NT;
  constexpr int D = NX + NU;
  constexpr int M = 2 * NU + 2 * NX, MN = 2 * NX;
  const RowMask<P::RTW> TM = term_rows<P>();
  // candidate row r of a stage: kind, index, sign; terminal row t likewise
  auto row_u = [](int r) { return r < 2 * NU; };
  auto row_i = [](int r) {
    return r < NU ? r : r < 2 * NU ? r - NU : r < 2 * NU + NX ? r - 2 * NU
                                                              : r - 2 * NU - NX;
  };
  auto row_s = [](int r) {
    return (r < NU || (r >= 2 * NU && r < 2 * NU + NX)) ? T(1) : T(-1);
  };
  auto V = [st](int e) -> T& { return st[e * LD]; };

  const T* prm = in.prm;
  const T tol = prm[P::P_TOL], tol10 = prm[P::P_TOL10], reg = prm[P::P_REG];
  const T s_min = prm[P::P_SMIN], keps = prm[P::P_KEPS];
  const T kmu = prm[P::P_KMU], tmu = prm[P::P_TMU];
  const T tau_min = prm[P::P_TAUMIN];
  const int max_iter = static_cast<int>(prm[P::P_MAXIT]);
  const T denom = T(N * NX + N * M + MN);
  const T kap = T(1e10);
  const T* roff = prm + P::P_ROW;   // bound offset of each active stage row
  const T* toff = prm + P::P_TROW;  // ... of each active terminal row

  // stage k's theta, x_k, u_k (and x_{k+1}) from the region into registers
  auto get_th = [&](int k, T* th) {
#pragma unroll
    for (int j = 0; j < NT; ++j) th[j] = V(Lay::TH + k * NT + j);
  };
  auto get_x = [&](int k, T* x) {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = V(Lay::X + k * NX + i);
  };
  auto get_u = [&](int k, T* u) {
#pragma unroll
    for (int j = 0; j < NU; ++j) u[j] = V(Lay::U + k * NU + j);
  };
  // the direction of x_k (dX_0 = 0) and of u_k
  auto get_dx = [&](int k, T* dx) {
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = k == 0 ? T(0) : V(Lay::DX + (k - 1) * NX + i);
  };
  auto get_du = [&](int k, T* du) {
#pragma unroll
    for (int j = 0; j < NU; ++j) du[j] = V(Lay::DU + k * NU + j);
  };
  // F - x_{k+1} and [A | B] of stage k by one dual-number pass
  auto lin = [&](const T* x, const T* u, const T* th, const T* x1, T* A, T* Bm,
                 T* rd) {
    Dual<T, D> xd[NX], ud[NU], Fd[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xd[i] = Dual<T, D>(x[i]);
      xd[i].d[i] = T(1);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      ud[j] = Dual<T, D>(u[j]);
      ud[j].d[NX + j] = T(1);
    }
    P::dyn(xd, ud, th, prm, Fd);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      rd[i] = Fd[i].v - x1[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i * NX + j] = Fd[i].d[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[i * NU + j] = Fd[i].d[NX + j];
    }
  };
  // stage k's linearization: computed and kept (pass 1), or taken from the
  // region (passes 2 and 3)
  auto lin_store = [&](int k, const T* x, const T* u, const T* th, const T* x1, T* A,
                      T* Bm, T* rd) {
    lin(x, u, th, x1, A, Bm, rd);
    const int o = Lay::AB + k * Lay::LW;
#pragma unroll
    for (int e = 0; e < NX * NX; ++e) V(o + e) = A[e];
#pragma unroll
    for (int e = 0; e < NX * NU; ++e) V(o + NX * NX + e) = Bm[e];
#pragma unroll
    for (int e = 0; e < NX; ++e) V(o + NX * NX + NX * NU + e) = rd[e];
  };
  auto lin_load = [&](int k, T* A, T* Bm, T* rd) {
    const int o = Lay::AB + k * Lay::LW;
#pragma unroll
    for (int e = 0; e < NX * NX; ++e) A[e] = V(o + e);
#pragma unroll
    for (int e = 0; e < NX * NU; ++e) Bm[e] = V(o + NX * NX + e);
#pragma unroll
    for (int e = 0; e < NX; ++e) rd[e] = V(o + NX * NX + NX * NU + e);
  };
  // constraint value of candidate row r (slot ridx) of a stage at (x, u);
  // of terminal row t (slot tidx) at x_N
  auto c_row = [&](int r, int ridx, const T* x, const T* u) {
    const T v = row_u(r) ? u[row_i(r)] : x[row_i(r)];
    return row_s(r) * v + roff[ridx];
  };
  auto c_term = [&](int t, int tidx, const T* xN) {
    const T v = xN[t < NX ? t : t - NX];
    return (t < NX ? T(1) : T(-1)) * v + toff[tidx];
  };

  // ---- x_0, lam = 0, the initial slacks and duals ---------------------------
#pragma unroll
  for (int i = 0; i < NX; ++i) V(Lay::X + i) = in.x0[b * NX + i];
#pragma unroll 1
  for (int i = 0; i < N * NX; ++i) V(Lay::LAM + i) = T(0);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    T xk[NX], uk[NU];
    get_x(k, xk);
    get_u(k, uk);
    const RowMask<P::RW> mask = stage_rows<P>(k);
    int ridx = P::row_off(k);
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (!mask.has(r)) continue;
      const T si = m_fmax(m_abs(c_row(r, ridx, xk, uk)), s_min);
      V(Lay::S + ridx) = si;
      V(Lay::Z + ridx) = in.mu0 / si;
      ++ridx;
    }
  }
  {
    T xN[NX];
    get_x(N, xN);
    int tidx = 0;
#pragma unroll
    for (int t = 0; t < MN; ++t) {
      if (!TM.has(t)) continue;
      const T si = m_fmax(m_abs(c_term(t, tidx, xN)), s_min);
      V(Lay::SN + tidx) = si;
      V(Lay::ZN + tidx) = in.mu0 / si;
      ++tidx;
    }
  }

  T mu = in.mu0, kkt = T(1e30);
  int it = 0;
  bool conv = false, div = false;
  while (!conv && !div && it < max_iter) {
    // ---- one interior-point iteration ----------------------------------------
    // ---- pass 1: linearize; KKT errors at the current iterate ---------------
    T e_stat = T(0), abs_mult = T(0), e_feas = T(0), comp0 = T(0),
      comp_mu = T(0);
    T lam_prev[NX];
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T thk[NT], xk[NX], uk[NU], x1[NX], lamk[NX];
      get_th(k, thk);
      get_x(k, xk);
      get_u(k, uk);
      get_x(k + 1, x1);
#pragma unroll
      for (int i = 0; i < NX; ++i) lamk[i] = V(Lay::LAM + k * NX + i);
      T A[NX][NX], Bm[NX][NU], rd[NX], gx[NX], gu[NU];
      lin_store(k, xk, uk, thk, x1, &A[0][0], &Bm[0][0], rd);
      P::stage_grad(xk, uk, thk, prm, gx, gu);

      const RowMask<P::RW> mask = stage_rows<P>(k);
      const int r0 = P::row_off(k);
      // r_u = gu + Bᵀ lam + Cuᵀ z
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T r = gu[j];
#pragma unroll
        for (int i = 0; i < NX; ++i) r = r + Bm[i][j] * lamk[i];
        if (mask.has(j)) r = r + V(Lay::Z + r0 + mask.below(j));
        if (mask.has(NU + j)) r = r - V(Lay::Z + r0 + mask.below(NU + j));
        e_stat = m_fmax(e_stat, m_abs(r));
      }
      // r_x (k >= 1) = gx + Aᵀ lam - lam_{k-1} + Cxᵀ z
      if (k >= 1) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T r = gx[i] - lam_prev[i];
#pragma unroll
          for (int l = 0; l < NX; ++l) r = r + A[l][i] * lamk[l];
          if (mask.has(2 * NU + i))
            r = r + V(Lay::Z + r0 + mask.below(2 * NU + i));
          if (mask.has(2 * NU + NX + i))
            r = r - V(Lay::Z + r0 + mask.below(2 * NU + NX + i));
          e_stat = m_fmax(e_stat, m_abs(r));
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) abs_mult = abs_mult + m_abs(lamk[i]);
      int ridx = r0;
#pragma unroll
      for (int r = 0; r < M; ++r)
        if (mask.has(r)) abs_mult = abs_mult + m_abs(V(Lay::Z + ridx++));
#pragma unroll
      for (int i = 0; i < NX; ++i) e_feas = m_fmax(e_feas, m_abs(rd[i]));
      ridx = r0;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!mask.has(r)) continue;
        const T si = V(Lay::S + ridx), zi = V(Lay::Z + ridx);
        e_feas = m_fmax(e_feas, m_abs(c_row(r, ridx, xk, uk) + si));
        const T sz = si * zi;
        comp0 = m_fmax(comp0, m_abs(sz));
        comp_mu = m_fmax(comp_mu, m_abs(sz - mu));
        ++ridx;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) lam_prev[i] = lamk[i];
    }
    T xN[NX], gN[NX], thN[NT];
    get_th(N, thN);
    get_x(N, xN);
    P::term_grad(xN, thN, prm, gN);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T r = gN[i] - lam_prev[i];
      if (TM.has(i)) r = r + V(Lay::ZN + TM.below(i));
      if (TM.has(NX + i)) r = r - V(Lay::ZN + TM.below(NX + i));
      e_stat = m_fmax(e_stat, m_abs(r));
    }
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t)
        if (TM.has(t)) abs_mult = abs_mult + m_abs(V(Lay::ZN + tidx++));
      tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!TM.has(t)) continue;
        const T si = V(Lay::SN + tidx), zi = V(Lay::ZN + tidx);
        e_feas = m_fmax(e_feas, m_abs(c_term(t, tidx, xN) + si));
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
    P::term_hess(xN, thN, prm, &Pm[0][0]);
#pragma unroll
    for (int i = 0; i < NX; ++i) pv[i] = gN[i];
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!TM.has(t)) continue;
        const int i = t < NX ? t : t - NX;
        const T si = V(Lay::SN + tidx), zi = V(Lay::ZN + tidx);
        const T r_in = c_term(t, tidx, xN) + si;
        Pm[i][i] = Pm[i][i] + zi / si;
        pv[i] = pv[i] + (t < NX ? T(1) : T(-1)) * ((mu_new + zi * r_in) / si);
        ++tidx;
      }
    }
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      T thk[NT], xk[NX], uk[NU];
      get_th(k, thk);
      get_x(k, xk);
      get_u(k, uk);
      T Ak[NX][NX], Bk[NX][NU], ck[NX], qb[NX], rb[NU];
      lin_load(k, &Ak[0][0], &Bk[0][0], ck);
      P::stage_grad(xk, uk, thk, prm, qb, rb);
      T Qb[NX][NX], Rb[NU][NU];
      [[maybe_unused]] T Sc[NU][NX];  // the cost's cross block (P::CROSS)
      if constexpr (P::CROSS)
        P::stage_hess(xk, uk, thk, prm, &Qb[0][0], &Rb[0][0], &Sc[0][0]);
      else
        P::stage_hess(xk, uk, thk, prm, &Qb[0][0], &Rb[0][0]);
      const RowMask<P::RW> mask = stage_rows<P>(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!mask.has(r)) continue;
        const int i = row_i(r);
        const T si = V(Lay::S + ridx), zi = V(Lay::Z + ridx);
        const T sigma = zi / si;
        const T r_in = c_row(r, ridx, xk, uk) + si;
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
          for (int l = 0; l < NX; ++l) e = e + Pm[i][l] * Ak[l][j];
          PA[i][j] = e;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Pm[i][l] * Bk[l][j];
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
          for (int l = 0; l < NX; ++l) e = e + Bk[l][i] * PB[l][j];
          G[i][j] = Rb[i][j] + e;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e = e + Bk[l][i] * PA[l][j];
          if constexpr (P::CROSS)
            Hux[i][j] = Sc[i][j] + e;
          else
            Hux[i][j] = e;
        }
        T e = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) e = e + Bk[l][i] * Pc_p[l];
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
          V(Lay::K + (k * NU + i) * NX + j) = Kk[i][j];
        }
        kk[i] = -Xc[i][NX];
        V(Lay::KF + k * NU + i) = kk[i];
      }
      // stash (P, p)_{k+1} for the multipliers of the accepting pass; P is
      // symmetric, its upper triangle is kept
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        V(Lay::PV + k * NX + i) = pv[i];
#pragma unroll
        for (int j = i; j < NX; ++j) V(Lay::PU + k * Lay::NTRI + Lay::tri(i, j)) = Pm[i][j];
      }
      T Pnew[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e1 = T(0), e2 = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) e1 = e1 + Ak[l][i] * PA[l][j];
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
        for (int l = 0; l < NX; ++l) e1 = e1 + Ak[l][i] * Pc_p[l];
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
    T dx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = T(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T xk[NX], uk[NU];
      get_x(k, xk);
      get_u(k, uk);
      T A[NX][NX], Bm[NX][NU], rd[NX];
      lin_load(k, &A[0][0], &Bm[0][0], rd);
      T du[NU], dxn[NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + V(Lay::K + (k * NU + i) * NX + j) * dx[j];
        du[i] = a + V(Lay::KF + k * NU + i);
        V(Lay::DU + k * NU + i) = du[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0), e = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + A[i][j] * dx[j];
#pragma unroll
        for (int j = 0; j < NU; ++j) e = e + Bm[i][j] * du[j];
        dxn[i] = a + e + rd[i];
        V(Lay::DX + k * NX + i) = dxn[i];
      }
      const RowMask<P::RW> mask = stage_rows<P>(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!mask.has(r)) continue;
        const T dC = row_s(r) * (row_u(r) ? du[row_i(r)] : dx[row_i(r)]);
        const T si = V(Lay::S + ridx), zi = V(Lay::Z + ridx);
        const T r_in = c_row(r, ridx, xk, uk) + si;
        const T ds = -r_in - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        a_s = m_fmin(a_s, ratio(si, ds));
        a_z = m_fmin(a_z, ratio(zi, dz));
        ++ridx;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
    }
    {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!TM.has(t)) continue;
        const T dC = (t < NX ? T(1) : T(-1)) * dx[t < NX ? t : t - NX];
        const T si = V(Lay::SN + tidx), zi = V(Lay::ZN + tidx);
        const T r_in = c_term(t, tidx, xN) + si;
        const T ds = -r_in - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        a_s = m_fmin(a_s, ratio(si, ds));
        a_z = m_fmin(a_z, ratio(zi, dz));
        ++tidx;
      }
    }
    const T alpha = a_s;

    // the candidate slack and dual of one row
    auto dual_cand = [&](T si, T zi, T ds, T dz, T& sn, T& zn) {
      sn = m_fmax(si + alpha * ds, T(1e-30));
      zn = m_fmax(zi + a_z * dz, T(1e-30));
      zn = m_fmin(m_fmax(zn, mu_new / (kap * sn)), kap * mu_new / sn);
    };
    // every active row's candidate slack and dual: checked for finiteness
    // (pass 4) or written (pass 5); stage k at (xk, uk) with directions
    // (dxk, duk), the terminal rows at xN with dx_N
    bool fin = true;
    auto stage_cands = [&](int k, const T* xk, const T* uk, const T* dxk,
                           const T* duk, bool write) {
      const RowMask<P::RW> mask = stage_rows<P>(k);
      int ridx = P::row_off(k);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (!mask.has(r)) continue;
        const T dC = row_s(r) * (row_u(r) ? duk[row_i(r)] : dxk[row_i(r)]);
        const T si = V(Lay::S + ridx), zi = V(Lay::Z + ridx);
        const T ds = -(c_row(r, ridx, xk, uk) + si) - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        T sn, zn;
        dual_cand(si, zi, ds, dz, sn, zn);
        if (write) {
          V(Lay::S + ridx) = sn;
          V(Lay::Z + ridx) = zn;
        } else {
          fin = fin && finite(zn);
        }
        ++ridx;
      }
    };
    auto term_cands = [&](bool write) {
      int tidx = 0;
#pragma unroll
      for (int t = 0; t < MN; ++t) {
        if (!TM.has(t)) continue;
        const T dC = (t < NX ? T(1) : T(-1)) * dx[t < NX ? t : t - NX];
        const T si = V(Lay::SN + tidx), zi = V(Lay::ZN + tidx);
        const T ds = -(c_term(t, tidx, xN) + si) - dC;
        const T dz = (mu_new - si * zi - zi * ds) / si;
        T sn, zn;
        dual_cand(si, zi, ds, dz, sn, zn);
        if (write) {
          V(Lay::SN + tidx) = sn;
          V(Lay::ZN + tidx) = zn;
        } else {
          fin = fin && finite(zn);
        }
        ++tidx;
      }
    };

    // ---- pass 4: is the candidate point finite? -----------------------------
#pragma unroll
    for (int i = 0; i < NX; ++i) fin = fin && finite(V(Lay::X + i));
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T xk[NX], uk[NU], dxk[NX], duk[NU];
      get_x(k, xk);
      get_u(k, uk);
      get_dx(k, dxk);
      get_du(k, duk);
      stage_cands(k, xk, uk, dxk, duk, false);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        fin = fin && finite(V(Lay::X + (k + 1) * NX + i) +
                            alpha * V(Lay::DX + k * NX + i));
#pragma unroll
      for (int j = 0; j < NU; ++j) fin = fin && finite(uk[j] + alpha * duk[j]);
    }
    term_cands(false);

    // ---- pass 5: take the step unless converged or non-finite: the
    // candidate recomputed in place, the multipliers from the stash --------
    if (!(converged || !fin)) {
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        T xk[NX], uk[NU], dxk[NX], duk[NU], dxn[NX];
        get_x(k, xk);
        get_u(k, uk);
        get_dx(k, dxk);
        get_du(k, duk);
        get_dx(k + 1, dxn);
        stage_cands(k, xk, uk, dxk, duk, true);
#pragma unroll
        for (int j = 0; j < NU; ++j) V(Lay::U + k * NU + j) = uk[j] + alpha * duk[j];
        if (k >= 1) {
#pragma unroll
          for (int i = 0; i < NX; ++i) V(Lay::X + k * NX + i) = xk[i] + alpha * dxk[i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j)
            a = a + V(Lay::PU + k * Lay::NTRI + (i <= j ? Lay::tri(i, j) : Lay::tri(j, i))) *
                        dxn[j];
          V(Lay::LAM + k * NX + i) = a + V(Lay::PV + k * NX + i);
        }
      }
      term_cands(true);
#pragma unroll
      for (int i = 0; i < NX; ++i) V(Lay::X + N * NX + i) = xN[i] + alpha * dx[i];
    }
    mu = mu_new;
    kkt = err0;
    it += 1;
    conv = converged;
    div = div || !fin;
  }

  // ---- the objective at the final point and the scalar outputs -------------
  T obj = T(0);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    T thk[NT], xk[NX], uk[NU];
    get_th(k, thk);
    get_x(k, xk);
    get_u(k, uk);
    obj = obj + P::stage_cost(xk, uk, thk, prm);
  }
  {
    T thN[NT], xN[NX];
    get_th(N, thN);
    get_x(N, xN);
    obj = obj + P::term_cost(xN, thN, prm);
  }
  out.mu[b] = mu;
  out.kkt[b] = kkt;
  out.obj[b] = obj;
  out.it[b] = it;
  out.conv[b] = conv ? 1 : 0;
  out.status[b] = conv ? 0 : (div ? 2 : 1);
}

// One block: the tile's inputs into the region, every scenario's solve, the
// outputs back.
template <typename T, typename P>
HM_HDN void wip_block(const WipIn<T>& in, const WipOut<T>& out, T* region, int blk,
                      int B) {
  using Lay = WipLay<P>;
  constexpr int NX = P::NX, NU = P::NU, N = P::N, NT = P::NT, TB = P::TB;
  const int b0 = blk * TB;
  const int nb = B - b0 < TB ? B - b0 : TB;
  each_thread<TB>([&](int t) {
    load_runs<T, TB>(region + Lay::TH * TB, in.th, (N + 1) * NT, b0, nb, t);
    load_runs<T, TB>(region + Lay::X * TB, in.X, (N + 1) * NX, b0, nb, t);
    load_runs<T, TB>(region + Lay::U * TB, in.U, N * NU, b0, nb, t);
  });
  block_sync();
  each_thread<TB>([&](int t) {
    if (t < nb) solve_lane<T, P, TB>(in, out, region + t, static_cast<size_t>(b0 + t));
  });
  block_sync();
  each_thread<TB>([&](int t) {
    constexpr int M = 2 * NU + 2 * NX;
    auto same = [](int w) { return w; };
    store_runs<T, TB>(out.X, region + Lay::X * TB, (N + 1) * NX, b0, nb, t, same);
    store_runs<T, TB>(out.U, region + Lay::U * TB, N * NU, b0, nb, t, same);
    store_runs<T, TB>(out.lam, region + Lay::LAM * TB, N * NX, b0, nb, t, same);
    store_runs<T, TB>(out.s, region + Lay::S * TB, N * M, b0, nb, t, stage_slot<P>);
    store_runs<T, TB>(out.z, region + Lay::Z * TB, N * M, b0, nb, t, stage_slot<P>);
    store_runs<T, TB>(out.sN, region + Lay::SN * TB, 2 * NX, b0, nb, t, term_slot<P>);
    store_runs<T, TB>(out.zN, region + Lay::ZN * TB, 2 * NX, b0, nb, t, term_slot<P>);
  });
}

// The stage cost's gradient g = (gx, gu) and Hessian H over (x, u), D x D
// with D = NX + NU, as the kernel takes them (the Hux block where P::CROSS,
// its transpose beside it; zero otherwise), and the terminal cost's (for the
// host-side tests)
template <typename T, typename P>
void stage_derivs(const T* xs, const T* us, const T* th, const T* prm, T* g, T* H) {
  constexpr int NX = P::NX, NU = P::NU, D = NX + NU;
  T Hxx[NX * NX], Huu[NU * NU], Hux[NU * NX];
  for (int e = 0; e < NU * NX; ++e) Hux[e] = T(0);
  P::stage_grad(xs, us, th, prm, g, g + NX);
  if constexpr (P::CROSS)
    P::stage_hess(xs, us, th, prm, Hxx, Huu, Hux);
  else
    P::stage_hess(xs, us, th, prm, Hxx, Huu);
  for (int a = 0; a < D; ++a)
    for (int b = 0; b < D; ++b)
      H[a * D + b] = a < NX && b < NX     ? Hxx[a * NX + b]
                     : a >= NX && b >= NX ? Huu[(a - NX) * NU + b - NX]
                     : a >= NX            ? Hux[(a - NX) * NX + b]
                                          : Hux[(b - NX) * NX + a];
}
template <typename T, typename P>
void term_derivs(const T* xs, const T* th, const T* prm, T* g, T* H) {
  P::term_grad(xs, th, prm, g);
  P::term_hess(xs, th, prm, H);
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
                  void* conv, void* status) {
  return WipOut<T>{static_cast<T*>(X), static_cast<T*>(U), static_cast<T*>(lam),
                   static_cast<T*>(s), static_cast<T*>(z), static_cast<T*>(sN),
                   static_cast<T*>(zN), static_cast<T*>(mu), static_cast<T*>(kkt),
                   static_cast<T*>(obj), static_cast<int*>(it),
                   static_cast<unsigned char*>(conv), static_cast<int*>(status)};
}

#ifdef __CUDACC__
template <typename T, typename P>
__global__ void __launch_bounds__(P::TB, sizeof(T) == 4 ? P::MINB_F32 : P::MINB_F64)
whole_ip_kernel(WipIn<T> in, WipOut<T> out, T* scratch, int B) {
  static_assert(WipLay<P>::E == P::E, "region size: ops/codegen_cuda.py vs WipLay");
  T* region = scratch + static_cast<size_t>(blockIdx.x) * WipLay<P>::E * P::TB;
  wip_block<T, P>(in, out, region, static_cast<int>(blockIdx.x), B);
}

template <typename T, typename P>
int whole_ip_launch(const WipIn<T>& in, const WipOut<T>& out, void* scratch, int B,
                    void* stream) {
  static_assert(P::TB % 32 == 0 && P::TB <= 1024, "TB: a multiple of 32");
  if (B <= 0 || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  whole_ip_kernel<T, P><<<(B + P::TB - 1) / P::TB, P::TB, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<T*>(scratch), B);
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename T, typename P>
int whole_ip_run_host(const WipIn<T>& in, const WipOut<T>& out, void* scratch, int B) {
  static_assert(WipLay<P>::E == P::E, "region size: ops/codegen_cuda.py vs WipLay");
  if (B <= 0 || scratch == nullptr) return 1;
  for (int blk = 0; static_cast<long long>(blk) * P::TB < B; ++blk)
    wip_block<T, P>(in, out,
                    static_cast<T*>(scratch) + static_cast<size_t>(blk) * P::E * P::TB,
                    blk, B);
  return 0;
}
#endif

}  // namespace hm

// The C entry points of one generated problem (bound with ctypes). On the
// card whole_ip_f32 / whole_ip_f64 enqueue the kernel on `stream` and return
// its cudaError_t; on the host whole_ip_host_f32 / _f64 run the same block
// schedule in loops, dyn_lin_host_f64 the dual pass, cost_derivs_host_f64
// the costs' gradients and Hessians. `scratch` holds
// ceil(B/TB)·TB·E elements of the kernel's type.
#define HM_WIP_ARGS                                                          \
  const void *th, const void *x0, const void *X, const void *U,              \
      const void *prm, double mu0, void *Xo, void *Uo, void *lamo, void *so, \
      void *zo, void *sNo, void *zNo, void *mu, void *kkt, void *obj,        \
      void *it, void *conv, void *status, void *scratch, int B
#define HM_WIP_IN(T) hm::wip_in<T>(th, x0, X, U, prm, mu0)
#define HM_WIP_OUT(T) \
  hm::wip_out<T>(Xo, Uo, lamo, so, zo, sNo, zNo, mu, kkt, obj, it, conv, status)

#ifdef __CUDACC__
#define HM_WHOLE_IP_EXPORTS(P)                                               \
  extern "C" int whole_ip_f32(HM_WIP_ARGS, void* stream) {                   \
    return hm::whole_ip_launch<float, P>(HM_WIP_IN(float), HM_WIP_OUT(float), \
                                         scratch, B, stream);                \
  }                                                                          \
  extern "C" int whole_ip_f64(HM_WIP_ARGS, void* stream) {                   \
    return hm::whole_ip_launch<double, P>(HM_WIP_IN(double),                 \
                                          HM_WIP_OUT(double), scratch, B,    \
                                          stream);                           \
  }
#else
#define HM_WHOLE_IP_EXPORTS(P)                                               \
  extern "C" int whole_ip_host_f32(HM_WIP_ARGS) {                            \
    return hm::whole_ip_run_host<float, P>(HM_WIP_IN(float), HM_WIP_OUT(float), \
                                           scratch, B);                      \
  }                                                                          \
  extern "C" int whole_ip_host_f64(HM_WIP_ARGS) {                            \
    return hm::whole_ip_run_host<double, P>(HM_WIP_IN(double),               \
                                            HM_WIP_OUT(double), scratch, B); \
  }                                                                          \
  extern "C" int dyn_lin_host_f64(const double* xs, const double* us,        \
                                  const double* th, const double* prm,       \
                                  double* F, double* AB, int B) {            \
    for (int b = 0; b < B; ++b)                                              \
      hm::dyn_lin<double, P>(xs + b * P::NX, us + b * P::NU, th + b * P::NT, \
                             prm, F + b * P::NX,                             \
                             AB + b * P::NX * (P::NX + P::NU));              \
    return 0;                                                                \
  }                                                                          \
  extern "C" int cost_derivs_host_f64(const double* xs, const double* us,    \
                                      const double* th, const double* prm,   \
                                      double* g, double* H, double* gN,      \
                                      double* HN, int B) {                   \
    constexpr int NX = P::NX, D = P::NX + P::NU;                             \
    for (int b = 0; b < B; ++b) {                                            \
      hm::stage_derivs<double, P>(xs + b * NX, us + b * P::NU, th + b * P::NT, \
                                  prm, g + b * D, H + b * D * D);            \
      hm::term_derivs<double, P>(xs + b * NX, th + b * P::NT, prm,           \
                                 gN + b * NX, HN + b * NX * NX);             \
    }                                                                        \
    return 0;                                                                \
  }
#endif
