// Batched stagewise LQ KKT solve (backward Riccati recursion + forward
// rollout + dynamics multipliers), one CUDA thread per scenario, with each
// block's tile of scenarios staged through shared memory.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:169
// riccati_lq_pallas (pallas_call at line 431). Same math as its kernel body
// (lines 293-400): for k = N-1..0
//   Pc_p = P c + p,  PA = P A,  PB = P B
//   G    = sym(R + Bᵀ PB) + reg·I            (nu x nu Schur complement)
//   H_ux = S + Bᵀ PA,  g_u = r + Bᵀ Pc_p
//   [K | kff] = -G⁻¹ [H_ux | g_u]           (unrolled Cholesky + substitution)
//   P <- sym(Q + Aᵀ PA + H_uxᵀ K),  p <- q + Aᵀ Pc_p + H_uxᵀ kff
//   cost_red -= ½ kffᵀ g_u
// with (P, p, K, kff) stashed per stage, then the forward pass
//   du = K dx + kff,  dx' = A dx + B du + c,  lam = P_{k+1} dx' + p_{k+1}.
//
// Bound. A scenario's work is a few hundred FLOPs per stage against ~26
// values per stage that must cross HBM (the eight inputs once, the five
// outputs once): far below the H100's ~20 FLOP/byte ridge, so the kernel is
// bound by bytes. What it moves per scenario and stage, for (nx, nu) = (2, 1):
// the backward pass reads the 18 input values and writes K, kff (3) and the
// stash (9); the forward pass reads A, B, c (8; not for the first chunk,
// whose inputs are still in shared memory) and the stash (9) and writes dX,
// dU, lam (5). The stash is written and read back by the same block within
// a few microseconds, so it may stay in the 50 MB L2 (how much does is not
// measured). At (2, 1) this is 52 values against the bound's ~26.5, so the
// design can reach at most ~51% of the bytes bound.
//
// Design. nx, nu, the tile TB (scenarios per block, a multiple of 32) and the
// chunk KC (stages per copy) are template parameters; ops/cuda_kernels.py:
// riccati_lq_tiling chooses (TB, KC) per (nx, nu, dtype) and writes them into
// the instantiation text (RICCATI_LQ_TILES_F32 / _F64 before
// RICCATI_LQ_EXPORTS). N is a runtime value; the chunk count is computed at
// run time and the last chunk may be ragged. Per chunk:
//  - copy: all TB threads copy the tile's inputs of KC stages into shared
//    memory. In the batch-first layout one scenario's KC stages of a field
//    are KC·e contiguous words, so neighbouring threads take neighbouring
//    words and every load coalesces. Each word lands scenario-minor, at
//    [field][stage][element][scenario] with a row stride of TB+1, so the
//    compute threads read it without bank conflicts. The copies are
//    element-sized cp.async (4 bytes in float32, 8 in float64): they do the
//    transposition in flight, take any start address (a view such as A[1:]
//    starts anywhere) and any N, and need no alignment check. A 16-byte copy
//    would land four words of one scenario side by side, and TMA would need
//    16-byte global strides, which N·e breaks for most N. The next chunk is
//    copied into the second buffer while this one is computed (the
//    backward pass walks the chunks down from stage N-1, the forward pass
//    up).
//  - compute: each thread runs its scenario's stages of the chunk from
//    shared memory; its P, p, cost_red and dx live in registers across
//    chunks. The stash (P, p, K, kff) goes to a global scratch laid out
//    [block][stage][element][scenario of the tile], so a warp's stash
//    accesses at one stage are contiguous.
//  - store: K, kff (backward) and dX, dU, lam (forward) are collected per
//    chunk in shared memory and written batch-first with the copy's
//    coalesced pattern; rows past Bt of the last tile are never written.
// Free initial state (the run-time flag free_x0 of the C entry, dx0 then
// null): the function is the JAX composite of a free-x0 Newton step
// (hilo_mpc_tpu/ops/ip_solver.py:633-642: a backward sweep, dx0 =
// −(P0 + reg·I)⁻¹ p0 by linalg.solve, then the LQ solve). When the backward
// pass ends, each thread holds its scenario's P0 and p0 in registers (S.P,
// S.p); it factors P0 + reg·I by the same unrolled Cholesky as the gain
// (chol_solve, on NX here), solves for dx0, writes it to dX[:, 0] and starts
// the forward pass from it: no second sweep and no dx0 read. Cholesky, not
// LU: in the interior point's free-x0 solves (MHE windows) P0 ⪰ the arrival
// weight ≻ 0. A non-positive pivot makes dx0 NaN, and the interior point
// marks that scenario diverged (the JAX LU solve would return a step).
// The chunk functions are __host__ __device__: compiled with the host C++
// compiler (ops/_build.py:host_library_path) the same block schedule runs
// in loops over blocks and threads, plain assignments standing in for the
// asynchronous copies, so the CPU tests reach the tile and chunk
// arithmetic, the ragged edges and the stash. The launcher takes PyTorch's
// current stream, allocates nothing and never synchronizes.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RLQ_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define RLQ_HD inline
#endif

namespace rlq {

RLQ_HD float dsqrt(float v) { return sqrtf(v); }
RLQ_HD double dsqrt(double v) { return sqrt(v); }

// Sizes of one (NX, NU). Per-stage inputs in buffer order: the forward pass
// copies the first three (A, B, c) only. Offsets count rows of one stage.
template <int NX, int NU>
struct Lay {
  static constexpr int EA = NX * NX, EB = NX * NU, EC = NX, EQ = NX * NX;
  static constexpr int ES = NU * NX, ER = NU * NU, EQV = NX, ERV = NU;
  static constexpr int OA = 0, OB = OA + EA, OC = OB + EB, OQ = OC + EC;
  static constexpr int OS = OQ + EQ, OR = OS + ES, OQV = OR + ER, ORV = OQV + EQV;
  static constexpr int F_IN = ORV + ERV;
  static constexpr int N_FIELDS = 8, N_FWD = 3;
  // outputs collected per chunk: K, kff (backward); dX, dU, lam (forward)
  static constexpr int E_BWD = NU * NX + NU, E_FWD = 2 * NX + NU;
  static constexpr int F_OUT = E_BWD > E_FWD ? E_BWD : E_FWD;
  // stash per stage: P, p, K, kff
  static constexpr int SP = 0, Sp = NX * NX, SK = Sp + NX, Sk = SK + NU * NX;
  static constexpr int SW = Sk + NU;
};

// Shared memory of one block: two input buffers and one output buffer, each
// KC stages of rows of TB+1 elements.
template <typename T, int NX, int NU, int TB, int KC>
constexpr size_t smem_elems() {
  return static_cast<size_t>(2 * Lay<NX, NU>::F_IN + Lay<NX, NU>::F_OUT) * KC *
         (TB + 1);
}

template <typename T>
struct LqPtrs {
  const T* in[8];  // A, B, c, Q, S, R, q, r: (Bt, N, ...) batch-first
  const T* P_term;
  const T* p_term;
  const T* dx0;
  T* dX;
  T* dU;
  T* lam;
  T* K;
  T* kff;
  T* cost_red;
  T* stash;  // (ceil(Bt/TB), N, SW, TB)
  int free_x0;  // dx0 = −(P0 + reg·I)⁻¹ p0, dx0 unread (null)
};

template <typename T, int NX, int NU>
struct State {
  T P[NX][NX], p[NX], dx[NX], dec;
};

// ---- what differs between the card and the host ----
template <typename T>
RLQ_HD void copy_elem(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

RLQ_HD void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most NPEND of this thread's copy groups are in flight
template <int NPEND>
RLQ_HD void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NPEND) : "memory");
#endif
}

RLQ_HD void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// f(t) for this thread on the card; for every thread of the block, in
// order, on the host
template <int TB, typename F>
RLQ_HD void each_thread(const F& f) {
#ifdef __CUDA_ARCH__
  f(static_cast<int>(threadIdx.x));
#else
  for (int t = 0; t < TB; ++t) f(t);
#endif
}

// the State slot of thread t: its own registers on the card
RLQ_HD int slot(int t) {
#ifdef __CUDA_ARCH__
  return 0;
#else
  return t;
#endif
}

// ---- the copy and store patterns ----
// Thread t's share of copying one field of the tile's stages [k0, k0+kc)
// into rows (stage j, element i) -> j·e + i of `rows` (stride TB+1):
// scenario s's run of L = kc·e words starts at g + ((b0+s)·N + k0)·e. Thread
// t takes words t, t+TB, ... of the tile's nb·L; the position (s, w) and
// both addresses step by TB words with adds alone (TB = q·L + r).
template <typename T, int TB>
RLQ_HD void copy_field(T* rows, const T* g, int e, int b0, int nb, int N,
                       int k0, int kc, int t) {
  const int L = kc * e, q = TB / L, r = TB - q * L;
  const size_t stride = static_cast<size_t>(N) * e;
  int s = t / L, w = t - s * L;
  const T* src = g + static_cast<size_t>(b0 + s) * stride +
                 static_cast<size_t>(k0) * e + w;
  T* dst = rows + w * (TB + 1) + s;
  while (s < nb) {
    copy_elem(dst, src);
    s += q;
    w += r;
    src += q * stride + r;
    dst += r * (TB + 1) + q;
    if (w >= L) {
      w -= L;
      ++s;
      src += stride - L;
      dst += 1 - L * (TB + 1);
    }
  }
}

// The reverse: rows -> scenario s's run of L words at g + (b0+s)·stride + base.
template <typename T, int TB>
RLQ_HD void store_field(const T* rows, T* g, int L, size_t stride, size_t base,
                        int b0, int nb, int t) {
  const int q = TB / L, r = TB - q * L;
  int s = t / L, w = t - s * L;
  T* dst = g + static_cast<size_t>(b0 + s) * stride + base + w;
  const T* src = rows + w * (TB + 1) + s;
  while (s < nb) {
    *dst = *src;
    s += q;
    w += r;
    dst += q * stride + r;
    src += r * (TB + 1) + q;
    if (w >= L) {
      w -= L;
      ++s;
      dst += stride - L;
      src += 1 - L * (TB + 1);
    }
  }
}

// the first NF fields of the tile's stages [k0, k0+kc)
template <typename T, int NX, int NU, int TB, int KC, int NF>
RLQ_HD void copy_chunk(T* buf, const LqPtrs<T>& a, int b0, int nb, int N, int k0,
                       int kc, int t) {
  using L = Lay<NX, NU>;
  const int e[8] = {L::EA, L::EB, L::EC, L::EQ, L::ES, L::ER, L::EQV, L::ERV};
  const int o[8] = {L::OA, L::OB, L::OC, L::OQ, L::OS, L::OR, L::OQV, L::ORV};
#pragma unroll
  for (int f = 0; f < NF; ++f)
    copy_field<T, TB>(buf + static_cast<size_t>(o[f]) * KC * (TB + 1), a.in[f],
                      e[f], b0, nb, N, k0, kc, t);
}

// X = M⁻¹ Rhs for a symmetric positive definite M (M x M; NR right-hand
// sides): the unrolled Cholesky factor M = L Lᵀ, then L Y = Rhs and Lᵀ X = Y.
// Every index is a compile-time constant, so the factor stays in registers.
// A non-positive pivot makes the factor, and so X, NaN.
template <typename T, int M, int NR>
RLQ_HD void chol_solve(const T (&G)[M][M], const T (&Rhs)[M][NR], T (&X)[M][NR]) {
  T Lc[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m > i) continue;
      T v = G[i][m];
#pragma unroll
      for (int l = 0; l < M; ++l)
        if (l < m) v -= Lc[i][l] * Lc[m][l];
      Lc[i][m] = (i == m) ? dsqrt(v > T(0) ? v : T(-1)) : v / Lc[m][m];
    }
  }
#pragma unroll
  for (int m = 0; m < NR; ++m) {
    T Y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = Rhs[i][m];
#pragma unroll
      for (int l = 0; l < M; ++l)
        if (l < i) acc -= Lc[i][l] * Y[l];
      Y[i] = acc / Lc[i][i];
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      T acc = Y[i];
#pragma unroll
      for (int l = 0; l < M; ++l)
        if (l > i) acc -= Lc[l][i] * X[l][m];
      X[i][m] = acc / Lc[i][i];
    }
  }
}

// dx0 = −(P0 + reg·I)⁻¹ p0 from the State the backward pass leaves
template <typename T, int NX, int NU>
RLQ_HD void free_dx0(State<T, NX, NU>& S, T reg) {
  T M[NX][NX], rhs[NX][1], x[NX][1];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int m = 0; m < NX; ++m) M[i][m] = S.P[i][m] + (i == m ? reg : T(0));
    rhs[i][0] = S.p[i];
  }
  chol_solve<T, NX, 1>(M, rhs, x);
#pragma unroll
  for (int i = 0; i < NX; ++i) S.dx[i] = -x[i][0];
}

// ---- the arithmetic of one chunk, for the thread of tile row s ----
template <typename T, int NX, int NU, int TB, int KC>
RLQ_HD void bwd_chunk(State<T, NX, NU>& st, const T* in, T* out, T* stash, int k0,
                      int kc, int s, T reg) {
  using L = Lay<NX, NU>;
  constexpr int LD = TB + 1;
  // element i of field (row offset O, size E) at local stage j
  auto rd = [&](int O, int E, int j, int i) { return in[(O * KC + j * E + i) * LD + s]; };
  T(&P)[NX][NX] = st.P;
  T(&p)[NX] = st.p;
  for (int j = kc - 1; j >= 0; --j) {
    T* sk = stash + static_cast<size_t>(k0 + j) * L::SW * TB + s;
    T Ak[NX][NX], Bk[NX][NU], ck[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ck[i] = rd(L::OC, L::EC, j, i);
#pragma unroll
      for (int l = 0; l < NX; ++l) Ak[i][l] = rd(L::OA, L::EA, j, i * NX + l);
#pragma unroll
      for (int l = 0; l < NU; ++l) Bk[i][l] = rd(L::OB, L::EB, j, i * NU + l);
    }
    // stash (P_{k+1}, p_{k+1}) for the forward pass
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sk[(L::Sp + i) * TB] = p[i];
#pragma unroll
      for (int l = 0; l < NX; ++l) sk[(L::SP + i * NX + l) * TB] = P[i][l];
    }
    T Pc_p[NX], PA[NX][NX], PB[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += P[i][l] * ck[l];
      Pc_p[i] = acc + p[i];
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v += P[i][l] * Ak[l][m];
        PA[i][m] = v;
      }
#pragma unroll
      for (int m = 0; m < NU; ++m) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v += P[i][l] * Bk[l][m];
        PB[i][m] = v;
      }
    }
    T G[NU][NU], Gs[NU][NU], Hux[NU][NX], gu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int m = 0; m < NU; ++m) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v += Bk[l][i] * PB[l][m];
        G[i][m] = rd(L::OR, L::ER, j, i * NU + m) + v;
      }
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v += Bk[l][i] * PA[l][m];
        Hux[i][m] = rd(L::OS, L::ES, j, i * NX + m) + v;
      }
      T v = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) v += Bk[l][i] * Pc_p[l];
      gu[i] = rd(L::ORV, L::ERV, j, i) + v;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int m = 0; m < NU; ++m)
        Gs[i][m] = T(0.5) * (G[i][m] + G[m][i]) + (i == m ? reg : T(0));

    T rhs[NU][NX + 1], Xc[NU][NX + 1];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int m = 0; m < NX; ++m) rhs[i][m] = Hux[i][m];
      rhs[i][NX] = gu[i];
    }
    chol_solve<T, NU, NX + 1>(Gs, rhs, Xc);
    T K[NU][NX], kff[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        K[i][m] = -Xc[i][m];
        out[((j * NU + i) * NX + m) * LD + s] = K[i][m];
        sk[(L::SK + i * NX + m) * TB] = K[i][m];
      }
      kff[i] = -Xc[i][NX];
      out[(NU * NX * KC + j * NU + i) * LD + s] = kff[i];
      sk[(L::Sk + i) * TB] = kff[i];
    }
    // value-function update
    T Pnew[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        T v = rd(L::OQ, L::EQ, j, i * NX + m);
#pragma unroll
        for (int l = 0; l < NX; ++l) v += Ak[l][i] * PA[l][m];
#pragma unroll
        for (int l = 0; l < NU; ++l) v += Hux[l][i] * K[l][m];
        Pnew[i][m] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int m = 0; m < NX; ++m) P[i][m] = T(0.5) * (Pnew[i][m] + Pnew[m][i]);
      T v = rd(L::OQV, L::EQV, j, i);
#pragma unroll
      for (int l = 0; l < NX; ++l) v += Ak[l][i] * Pc_p[l];
#pragma unroll
      for (int l = 0; l < NU; ++l) v += Hux[l][i] * kff[l];
      p[i] = v;
    }
    T d = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) d += kff[i] * gu[i];
    st.dec -= T(0.5) * d;
  }
}

template <typename T, int NX, int NU, int TB, int KC>
RLQ_HD void fwd_chunk(State<T, NX, NU>& st, const T* in, T* out, const T* stash,
                      int k0, int kc, int s) {
  using L = Lay<NX, NU>;
  constexpr int LD = TB + 1;
  auto rd = [&](int O, int E, int j, int i) { return in[(O * KC + j * E + i) * LD + s]; };
  T(&dx)[NX] = st.dx;
  // the stash of stage j+1 is loaded while stage j is computed, so its L2
  // round trip is not on the dx chain
  auto load = [&](T(&v)[L::SW], int j) {
    const T* sk = stash + static_cast<size_t>(k0 + j) * L::SW * TB + s;
#pragma unroll
    for (int e = 0; e < L::SW; ++e) v[e] = sk[e * TB];
  };
  T next[L::SW];
  load(next, 0);
  for (int j = 0; j < kc; ++j) {
    T sk[L::SW];
#pragma unroll
    for (int e = 0; e < L::SW; ++e) sk[e] = next[e];
    if (j + 1 < kc) load(next, j + 1);
    T du[NU], dxn[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T v = sk[L::Sk + i];
#pragma unroll
      for (int m = 0; m < NX; ++m) v += sk[L::SK + i * NX + m] * dx[m];
      du[i] = v;
      out[(NX * KC + j * NU + i) * LD + s] = v;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T v = rd(L::OC, L::EC, j, i);
#pragma unroll
      for (int m = 0; m < NX; ++m) v += rd(L::OA, L::EA, j, i * NX + m) * dx[m];
#pragma unroll
      for (int m = 0; m < NU; ++m) v += rd(L::OB, L::EB, j, i * NU + m) * du[m];
      dxn[i] = v;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T v = sk[L::Sp + i];
#pragma unroll
      for (int m = 0; m < NX; ++m) v += sk[L::SP + i * NX + m] * dxn[m];
      out[((NX + NU) * KC + j * NX + i) * LD + s] = v;
      out[(j * NX + i) * LD + s] = dxn[i];
      dx[i] = dxn[i];
    }
  }
}

// ---- one block: the whole schedule ----
// st: the thread's own State on the card, TB of them on the host.
template <typename T, int NX, int NU, int TB, int KC>
RLQ_HD void lq_block(const LqPtrs<T>& a, T* smem, State<T, NX, NU>* st, int blk,
                     int Bt, int N, T reg) {
  using L = Lay<NX, NU>;
  constexpr int LD = TB + 1;
  // the two input buffers, picked by a select (an array indexed at run time
  // would live on the stack)
  T* const buf0 = smem;
  T* const buf1 = smem + static_cast<size_t>(L::F_IN) * KC * LD;
  auto buf = [&](int i) { return i ? buf1 : buf0; };
  T* out = smem + static_cast<size_t>(2 * L::F_IN) * KC * LD;
  const int b0 = blk * TB;
  const int nb = Bt - b0 < TB ? Bt - b0 : TB;
  T* stash = a.stash + static_cast<size_t>(blk) * N * L::SW * TB;
  const int nch = (N + KC - 1) / KC;
  const size_t n = static_cast<size_t>(N);

  each_thread<TB>([&](int t) {
    if (t >= nb) return;
    State<T, NX, NU>& S = st[slot(t)];
    const size_t b = static_cast<size_t>(b0 + t);
    for (int i = 0; i < NX; ++i) {
      S.p[i] = a.p_term[b * NX + i];
      for (int m = 0; m < NX; ++m) S.P[i][m] = a.P_term[(b * NX + i) * NX + m];
    }
    S.dec = T(0);
  });

  // backward sweep: chunks nch-1 .. 0, the next one copied during each
  int cur = 0;
  each_thread<TB>([&](int t) {
    copy_chunk<T, NX, NU, TB, KC, L::N_FIELDS>(buf(0), a, b0, nb, N,
                                  (nch - 1) * KC, N - (nch - 1) * KC, t);
  });
  cp_commit();
  for (int j = nch - 1; j >= 0; --j) {
    if (j > 0) {
      each_thread<TB>([&](int t) {
        copy_chunk<T, NX, NU, TB, KC, L::N_FIELDS>(buf(cur ^ 1), a, b0, nb, N,
                                      (j - 1) * KC, KC, t);
      });
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    block_sync();
    const int k0 = j * KC, kc = N - k0 < KC ? N - k0 : KC;
    each_thread<TB>([&](int t) {
      if (t < nb)
        bwd_chunk<T, NX, NU, TB, KC>(st[slot(t)], buf(cur), out, stash, k0, kc, t,
                                     reg);
    });
    block_sync();
    each_thread<TB>([&](int t) {
      store_field<T, TB>(out, a.K, kc * NU * NX, n * NU * NX,
                         static_cast<size_t>(k0) * NU * NX, b0, nb, t);
      store_field<T, TB>(out + static_cast<size_t>(NU * NX) * KC * LD, a.kff,
                         kc * NU, n * NU, static_cast<size_t>(k0) * NU, b0, nb, t);
    });
    cur ^= 1;
  }

  each_thread<TB>([&](int t) {
    if (t >= nb) return;
    State<T, NX, NU>& S = st[slot(t)];
    const size_t b = static_cast<size_t>(b0 + t);
    a.cost_red[b] = S.dec;
    if (a.free_x0)
      free_dx0<T, NX, NU>(S, reg);
    else
      for (int i = 0; i < NX; ++i) S.dx[i] = a.dx0[b * NX + i];
    for (int i = 0; i < NX; ++i) a.dX[b * (n + 1) * NX + i] = S.dx[i];
  });

  // forward pass: chunk 0's inputs are still in buf(cur ^ 1)
  cur ^= 1;
  for (int j = 0; j < nch; ++j) {
    if (j + 1 < nch) {
      const int k1 = (j + 1) * KC;
      each_thread<TB>([&](int t) {
        copy_chunk<T, NX, NU, TB, KC, L::N_FWD>(buf(cur ^ 1), a, b0, nb, N, k1,
                                      N - k1 < KC ? N - k1 : KC, t);
      });
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    block_sync();
    const int k0 = j * KC, kc = N - k0 < KC ? N - k0 : KC;
    each_thread<TB>([&](int t) {
      if (t < nb)
        fwd_chunk<T, NX, NU, TB, KC>(st[slot(t)], buf(cur), out, stash, k0, kc, t);
    });
    block_sync();
    each_thread<TB>([&](int t) {
      const size_t K0 = static_cast<size_t>(k0);
      store_field<T, TB>(out, a.dX, kc * NX, (n + 1) * NX, (K0 + 1) * NX, b0, nb, t);
      store_field<T, TB>(out + static_cast<size_t>(NX) * KC * LD, a.dU, kc * NU,
                         n * NU, K0 * NU, b0, nb, t);
      store_field<T, TB>(out + static_cast<size_t>(NX + NU) * KC * LD, a.lam,
                         kc * NX, n * NX, K0 * NX, b0, nb, t);
    });
    cur ^= 1;
  }
}

template <typename T>
LqPtrs<T> ptrs(const void* A, const void* B, const void* Q, const void* S,
               const void* R, const void* q, const void* r, const void* c,
               const void* P_term, const void* p_term, const void* dx0, void* dX,
               void* dU, void* lam, void* K, void* kff, void* cost_red,
               void* stash, int free_x0) {
  LqPtrs<T> a;
  const void* in[8] = {A, B, c, Q, S, R, q, r};
  for (int f = 0; f < 8; ++f) a.in[f] = static_cast<const T*>(in[f]);
  a.P_term = static_cast<const T*>(P_term);
  a.p_term = static_cast<const T*>(p_term);
  a.dx0 = static_cast<const T*>(dx0);
  a.dX = static_cast<T*>(dX);
  a.dU = static_cast<T*>(dU);
  a.lam = static_cast<T*>(lam);
  a.K = static_cast<T*>(K);
  a.kff = static_cast<T*>(kff);
  a.cost_red = static_cast<T*>(cost_red);
  a.stash = static_cast<T*>(stash);
  a.free_x0 = free_x0;
  return a;
}

// (TB, KC, dynamic shared memory bytes) of one instance
template <typename T, int NX, int NU, int TB, int KC>
int layout(int* out) {
  out[0] = TB;
  out[1] = KC;
  out[2] = static_cast<int>(smem_elems<T, NX, NU, TB, KC>() * sizeof(T));
  return 0;
}

#ifdef __CUDACC__
template <typename T, int NX, int NU, int TB, int KC>
__global__ void __launch_bounds__(TB)
riccati_lq_kernel(LqPtrs<T> a, int Bt, int N, T reg) {
  extern __shared__ __align__(16) unsigned char rlq_smem[];
  State<T, NX, NU> st[1];
  lq_block<T, NX, NU, TB, KC>(a, reinterpret_cast<T*>(rlq_smem), st,
                              static_cast<int>(blockIdx.x), Bt, N, reg);
}

// Dynamic shared memory above 48 KB, and the SM's L1/shared split at its
// most shared memory, so that as many blocks stay resident as it allows. Set
// once per device and instance: each call costs host time on every launch.
constexpr int RLQ_MAX_DEVICES = 64;

template <typename T, int NX, int NU, int TB, int KC>
cudaError_t set_attributes() {
  static bool done[RLQ_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < RLQ_MAX_DEVICES;
  if (known && done[dev]) return cudaSuccess;
  const int bytes = static_cast<int>(smem_elems<T, NX, NU, TB, KC>() * sizeof(T));
  e = cudaFuncSetAttribute(riccati_lq_kernel<T, NX, NU, TB, KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(riccati_lq_kernel<T, NX, NU, TB, KC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}

template <typename T, int NX, int NU, int TB, int KC>
int launch(const LqPtrs<T>& a, int Bt, int N, double reg, void* stream) {
  static_assert(TB % 32 == 0 && TB <= 1024 && KC >= 1, "TB: a multiple of 32");
  if (Bt <= 0 || N <= 0 || (!a.free_x0 && a.dx0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_elems<T, NX, NU, TB, KC>() * sizeof(T);
  cudaError_t e = set_attributes<T, NX, NU, TB, KC>();
  if (e != cudaSuccess) return static_cast<int>(e);
  riccati_lq_kernel<T, NX, NU, TB, KC>
      <<<(Bt + TB - 1) / TB, TB, bytes, static_cast<cudaStream_t>(stream)>>>(
          a, Bt, N, static_cast<T>(reg));
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename T, int NX, int NU, int TB, int KC>
int run_host(const LqPtrs<T>& a, int Bt, int N, double reg) {
  if (Bt <= 0 || N <= 0 || (!a.free_x0 && a.dx0 == nullptr)) return 1;
  std::vector<T> smem(smem_elems<T, NX, NU, TB, KC>());
  std::vector<State<T, NX, NU>> st(TB);
  for (int blk = 0; blk * static_cast<long long>(TB) < Bt; ++blk)
    lq_block<T, NX, NU, TB, KC>(a, smem.data(), st.data(), blk, Bt, N,
                                static_cast<T>(reg));
  return 0;
}
#endif

}  // namespace rlq

// The C entry points of one (NX, NU) instantiation (bound with ctypes), with
// the tiles (TB, KC) of each dtype given by the generated text as
// RICCATI_LQ_TILES_F32 and RICCATI_LQ_TILES_F64. On the card riccati_lq_f32
// / _f64 enqueue the kernel on `stream` and return its cudaError_t (0: the
// kernel was enqueued); on the host riccati_lq_host_f32 / _f64 run the same
// block schedule in loops. riccati_lq_layout_f32 / _f64 write (TB, KC,
// dynamic shared memory bytes) in both builds. free_x0 != 0 solves for dx0
// (dx0 may then be null).
#define RLQ_ARGS                                                              \
  const void *A, const void *B, const void *Q, const void *S, const void *R,  \
      const void *q, const void *r, const void *c, const void *P_term,        \
      const void *p_term, const void *dx0, void *dX, void *dU, void *lam,     \
      void *K, void *kff, void *cost_red, void *stash, int Bt, int N,         \
      double reg, int free_x0
#define RLQ_PTRS(T)                                                           \
  rlq::ptrs<T>(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, dX, dU, lam, K,   \
               kff, cost_red, stash, free_x0)
#define RLQ_LAYOUTS(NX, NU)                                                   \
  extern "C" int riccati_lq_layout_f32(int* out) {                            \
    return rlq::layout<float, NX, NU, RICCATI_LQ_TILES_F32>(out);             \
  }                                                                           \
  extern "C" int riccati_lq_layout_f64(int* out) {                            \
    return rlq::layout<double, NX, NU, RICCATI_LQ_TILES_F64>(out);            \
  }
#ifdef __CUDACC__
#define RICCATI_LQ_EXPORTS(NX, NU)                                            \
  RLQ_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_f32(RLQ_ARGS, void* stream) {                     \
    return rlq::launch<float, NX, NU, RICCATI_LQ_TILES_F32>(                  \
        RLQ_PTRS(float), Bt, N, reg, stream);                                 \
  }                                                                           \
  extern "C" int riccati_lq_f64(RLQ_ARGS, void* stream) {                     \
    return rlq::launch<double, NX, NU, RICCATI_LQ_TILES_F64>(                 \
        RLQ_PTRS(double), Bt, N, reg, stream);                                \
  }
#else
#define RICCATI_LQ_EXPORTS(NX, NU)                                            \
  RLQ_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_host_f32(RLQ_ARGS) {                              \
    return rlq::run_host<float, NX, NU, RICCATI_LQ_TILES_F32>(                \
        RLQ_PTRS(float), Bt, N, reg);                                         \
  }                                                                           \
  extern "C" int riccati_lq_host_f64(RLQ_ARGS) {                              \
    return rlq::run_host<double, NX, NU, RICCATI_LQ_TILES_F64>(               \
        RLQ_PTRS(double), Bt, N, reg);                                        \
  }
#endif
