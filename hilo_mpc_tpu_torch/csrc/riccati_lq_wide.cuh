// Batched stagewise LQ KKT solve for the sizes above the tiled kernel's cap
// (riccati_lq.cuh takes nx <= 8 and nu <= 4): a group of G warps per
// scenario, up to nx = 32 and nu = 16.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:169
// riccati_lq_pallas (pallas_call at line 431) for those sizes; the JAX
// dispatcher (hilo_mpc_tpu/ops/riccati.py:279-311) tiles its kernel to fit
// VMEM at any size. Same recursion as riccati_lq.cuh (see its head): for
// k = N-1..0 the stash of (P, p)_{k+1}, Pc_p = P c + p, PA = P A, PB = P B,
// G = sym(R + Bᵀ PB) + reg·I, H_ux = S + Bᵀ PA, g_u = r + Bᵀ Pc_p,
// [K | kff] = -G⁻¹ [H_ux | g_u] by Cholesky, P <- sym(Q + Aᵀ PA + H_uxᵀ K),
// p <- q + Aᵀ Pc_p + H_uxᵀ kff, cost_red -= ½ kffᵀ g_u; then du = K dx + kff,
// dx' = A dx + B du + c, lam = P_{k+1} dx' + p_{k+1}.
//
// Bound. Per stage a scenario does ~4·nx³ + 6·nx²·nu FLOPs (4.5·10⁴ at
// (16, 8), 2.5·10⁵ at (32, 16)) on the eight stage inputs and five outputs
// (~1,050 values at (16, 8), ~4,000 at (32, 16)): 5–8 FLOPs per byte in
// float64, below the H100's ~10 (float64) and ~20 (float32) FLOPs per byte
// of HBM, so the bytes (each input read once, each output written once)
// bound it. At the batch sizes of an interior point (a few thousand
// scenarios, ~8 per SM) what limits a design is the latency of one
// scenario's dependent phases, so the design spreads each scenario's
// products over many threads and keeps its serial part short.
//
// Design. One block of NT = 32·G threads owns one scenario; G is a template
// parameter that ops/cuda_kernels.py:riccati_lq_wide_group chooses per
// (nx, nu, dtype) and writes into the instantiation text.
//  - Layout (GLay below). The stage's inputs sit in one column space: X =
//    [B | A | c] (nx rows) and C0 = [[R | S | r]; [· | Q | q]] (the u rows,
//    then the x rows), each block of columns starting at an even column, so
//    that [PB | PA | Pc_p] = P X (+ p on the c column) is ONE product and
//    [[G | H_ux | g_u]; [· | Aᵀ PA + Q | Aᵀ Pc_p + q]] = C0 + Xᵀ (P X) is
//    another, written in place over C0. P is kept transposed (PT), so every
//    product reads both operands as pairs of neighbouring words.
//  - Products as register tiles. Each product's outputs are dealt to the
//    threads in 2 x 2 tiles (two output rows by two columns); per step of
//    the contraction a thread loads one pair of each operand (two 8- or
//    16-byte shared loads) for four FMAs, and every thread of the group has
//    a tile while there are tiles (G is the fewest warps that deal the
//    largest product in at most 4 tiles per thread in float64 and 2 in
//    float32, at most 4 and 2 warps: fewer warps per scenario put more
//    scenarios on an SM, which at the batch sizes of an interior point
//    matters more than a shorter phase, as timed in every G). The
//    update of P computes a tile and its mirror and writes sym(·) into both
//    places, so no extra phase symmetrizes it.
//  - The gain. The nu x nu Cholesky factor and the two triangular solves of
//    [K | kff] run in warp 0's registers: lane i holds row i of the factor,
//    the diagonal and each column's entries reach the other lanes by
//    __shfl_sync, and lane m solves right-hand side m (and m + 32). No
//    barrier inside; the other warps wait at the next phase's barrier. The
//    gain is the one serial part of a stage, and float64 division and
//    square root are long instruction sequences on the card: per column one
//    reciprocal square root gives 1 / L_jj, and every division of the
//    factorization and the solves is a multiplication by it.
//  - Stage inputs prefetched. The eight fields of stage k-1 (backward) or
//    k+1 (forward: A, B, c and the stash of that stage) are copied into the
//    second of two stage buffers by element-sized cp.async while stage k
//    computes (each field is one contiguous run in the batch-first layout,
//    so a warp's copies coalesce; the element size lets the copy scatter
//    into the padded column space and take any start address). One
//    cp.async.wait_group and one barrier open each stage.
//  - Barriers: four per backward stage (open, after P X, after Xᵀ(P X),
//    after the gain), three per forward stage (open, after du, after dx').
//  - Free initial state (the C entry's run-time flag free_x0, as in
//    riccati_lq.cuh): when the backward pass ends, P0 and p0 are in the
//    group's shared memory (PT, p). Warp 0 gathers P0 + reg·I row by row,
//    one row per lane as for G, factors it by the same shuffle Cholesky
//    (nx <= 32 lanes: the variant's cap), solves for dx0 = −(P0 + reg·I)⁻¹ p0
//    with the right-hand side spread one entry per lane (a register each;
//    a column per lane, as the gain's solves hold, spilled at nx = 32 in
//    float64) and leaves it in the forward pass's dx, which one barrier
//    hands to the group. A non-positive pivot makes dx0 NaN.
//  - The (P, p, K, kff) stash of the forward pass stays in a global scratch
//    (Bt, N, SW) the wrapper allocates; a block writes its run per stage
//    with neighbouring threads on neighbouring words.
// The phase code is __host__ __device__: compiled by the host C++ compiler,
// every phase loops over the NT threads of the group and the gain over the
// 32 lanes of warp 0 (each register a 32-wide array, a shuffle a read of
// another lane's slot), plain copies standing in for cp.async, so the CPU
// tests run the same schedule and order of operations, ragged batches
// included. The rounding is not the card's bit for bit: nvcc fuses
// multiply-adds, and the gain's reciprocal square root is rsqrt on the card
// and 1 / sqrt on the host (they can differ by 1 ulp); the card's results
// are held against the plain sweeps on the card.
// The launcher takes PyTorch's current stream, allocates nothing and never
// synchronizes.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RLW_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define RLW_HD inline
#endif

// `for` headers that run the body once for this thread (lane) on the card
// and once for every thread (lane) in order on the host
#ifdef __CUDA_ARCH__
#define RLW_FOR_THREADS(t, NT) \
  for (int t = static_cast<int>(threadIdx.x), t##_once = 0; t##_once < 1; ++t##_once)
#define RLW_FOR_LANES(l) \
  for (int l = static_cast<int>(threadIdx.x & 31u), l##_once = 0; l##_once < 1; ++l##_once)
#else
#define RLW_FOR_THREADS(t, NT) for (int t = 0; t < (NT); ++t)
#define RLW_FOR_LANES(l) for (int l = 0; l < 32; ++l)
#endif

namespace rlw {

// 1/√v: the card's reciprocal square root (one MUFU approximation and its
// refinement, within 1 ulp, in place of a square root and a division); the
// host computes 1 / sqrt(v)
RLW_HD float wrsqrt(float v) {
#ifdef __CUDA_ARCH__
  return rsqrtf(v);
#else
  return 1.0f / sqrtf(v);
#endif
}
RLW_HD double wrsqrt(double v) {
#ifdef __CUDA_ARCH__
  return rsqrt(v);
#else
  return 1.0 / sqrt(v);
#endif
}

constexpr int even(int v) { return (v + 1) & ~1; }

// Offsets (in words) of one scenario's shared memory.
template <int NX, int NU>
struct GLay {
  static constexpr int NUP = even(NU), NXP = even(NX);
  // the column space of X and C0: u block, x block, the vector column
  static constexpr int CA = NUP, CC = NUP + NXP, XW = CC + 2;
  static constexpr int CROWS = NUP + NXP;
  // one stage buffer: X (NX x XW), then C0 (CROWS x XW) in the backward
  // pass or the stash of the stage in the forward pass
  static constexpr int OX = 0, OC0 = NX * XW, BUF = OC0 + CROWS * XW;
  // (the forward pass's K rows have an odd stride: a thread reads a row)
  static constexpr int FPT = OC0, Fp = FPT + NX * NXP, FK = Fp + NXP;
  static constexpr int FKW = NXP + 1, Fkf = FK + NU * FKW;
  // work arrays after the two buffers
  static constexpr int WPT = 2 * BUF;        // P transposed (NX x NXP)
  static constexpr int Wp = WPT + NX * NXP;  // p
  static constexpr int WY = Wp + NXP;        // P X (+p), NX x XW
  static constexpr int WK = WY + NX * XW;    // K (NU x NXP)
  static constexpr int Wkf = WK + NU * NXP;  // kff
  static constexpr int WDX = Wkf + NUP, WDXN = WDX + NXP, WDU = WDXN + NXP;
  static constexpr int WDEC = WDU + NUP;     // cost_red
  static constexpr int E = WDEC + 2;         // words per scenario
  // the stash per stage in global memory: PT, p, K, kff
  static constexpr int SP = 0, Sp = NX * NX, SK = Sp + NX, Sk = SK + NU * NX;
  static constexpr int SW = Sk + NU;
  // tiles of the three products: P X; Xᵀ(P X) over the u rows and the x
  // block of the x rows; the mirrored tiles of the P update and p's pairs
  static constexpr int T_PX = (NXP / 2) * (XW / 2);
  static constexpr int T_XU = (NUP / 2) * (XW / 2);
  static constexpr int H2 = NXP / 2;
  static constexpr int T_XX = H2 * (H2 + 1);
  static constexpr int T_P = H2 * (H2 + 1) / 2 + H2;
};

template <typename T>
struct WPtrs {
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
  T* stash;  // (Bt, N, SW)
  int free_x0;  // dx0 = −(P0 + reg·I)⁻¹ p0, dx0 unread (null)
};

// ---- what differs between the card and the host ----
template <typename T>
RLW_HD void copy_elem(T* dst, const T* src) {
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

RLW_HD void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

RLW_HD void cp_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

RLW_HD void group_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// one value per lane of warp 0: a register on the card, 32 slots on the host
template <typename T>
struct LaneVal {
#ifdef __CUDA_ARCH__
  T v;
  RLW_HD T& at(int) { return v; }
#else
  T v[32];
  RLW_HD T& at(int l) { return v[l]; }
#endif
};

// the value of x in lane src, for every lane
template <typename T>
RLW_HD T bcast(LaneVal<T>& x, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, x.v, src);
#else
  return x.v[src];
#endif
}

template <typename T>
RLW_HD void ld2(const T* s, T& a, T& b) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    a = v.x;
    b = v.y;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(s);
    a = v.x;
    b = v.y;
  }
#else
  a = s[0];
  b = s[1];
#endif
}

// The eight fields of backward stage k into buffer `buf`: X = [B | A | c],
// C0 = [[R | S | r]; [· | Q | q]]; each thread copies elements t, t+NT, ...
// of every field.
template <typename T, int NX, int NU, int NT>
RLW_HD void load_bwd(const WPtrs<T>& a, T* buf, size_t b, size_t n, int k, int t) {
  using L = GLay<NX, NU>;
  const size_t s = b * n + static_cast<size_t>(k);
  T* X = buf + L::OX;
  T* C0 = buf + L::OC0;
  const T* A = a.in[0] + s * NX * NX;
  const T* B = a.in[1] + s * NX * NU;
  const T* c = a.in[2] + s * NX;
  const T* Q = a.in[3] + s * NX * NX;
  const T* S = a.in[4] + s * NU * NX;
  const T* R = a.in[5] + s * NU * NU;
  const T* q = a.in[6] + s * NX;
  const T* r = a.in[7] + s * NU;
  for (int e = t; e < NX * NX; e += NT) {
    const int i = e / NX, m = e - i * NX;
    copy_elem(X + i * L::XW + L::CA + m, A + e);
    copy_elem(C0 + (L::CA + i) * L::XW + L::CA + m, Q + e);
  }
  for (int e = t; e < NX * NU; e += NT) {
    const int i = e / NU, m = e - i * NU;
    copy_elem(X + i * L::XW + m, B + e);
  }
  for (int e = t; e < NU * NX; e += NT) {
    const int i = e / NX, m = e - i * NX;
    copy_elem(C0 + i * L::XW + L::CA + m, S + e);
  }
  for (int e = t; e < NU * NU; e += NT) {
    const int i = e / NU, m = e - i * NU;
    copy_elem(C0 + i * L::XW + m, R + e);
  }
  for (int e = t; e < NX; e += NT) {
    copy_elem(X + e * L::XW + L::CC, c + e);
    copy_elem(C0 + (L::CA + e) * L::XW + L::CC, q + e);
  }
  for (int e = t; e < NU; e += NT) copy_elem(C0 + e * L::XW + L::CC, r + e);
}

// A, B, c of forward stage k and its stash (PT, p, K, kff) into `buf`
template <typename T, int NX, int NU, int NT>
RLW_HD void load_fwd(const WPtrs<T>& a, T* buf, size_t b, size_t n, int k, int t) {
  using L = GLay<NX, NU>;
  const size_t s = b * n + static_cast<size_t>(k);
  T* X = buf + L::OX;
  const T* A = a.in[0] + s * NX * NX;
  const T* B = a.in[1] + s * NX * NU;
  const T* c = a.in[2] + s * NX;
  const T* sk = a.stash + s * L::SW;
  for (int e = t; e < NX * NX; e += NT) {
    const int i = e / NX, m = e - i * NX;
    copy_elem(X + i * L::XW + L::CA + m, A + e);
    copy_elem(buf + L::FPT + i * L::NXP + m, sk + L::SP + e);
  }
  for (int e = t; e < NX * NU; e += NT) {
    const int i = e / NU, m = e - i * NU;
    copy_elem(X + i * L::XW + m, B + e);
  }
  for (int e = t; e < NU * NX; e += NT) {
    const int i = e / NX, m = e - i * NX;
    copy_elem(buf + L::FK + i * L::FKW + m, sk + L::SK + e);
  }
  for (int e = t; e < NX; e += NT) {
    copy_elem(X + e * L::XW + L::CC, c + e);
    copy_elem(buf + L::Fp + e, sk + L::Sp + e);
  }
  for (int e = t; e < NU; e += NT) copy_elem(buf + L::Fkf + e, sk + L::Sk + e);
}

// Y = P X (+ p on the c column), 2 x 2 tiles; the stash of (P, p)_{k+1}
template <typename T, int NX, int NU, int NT>
RLW_HD void phase_px(T* w, const T* buf, T* sk, int t) {
  using L = GLay<NX, NU>;
  const T* PT = w + L::WPT;
  const T* X = buf + L::OX;
  T* Y = w + L::WY;
  for (int e = t; e < NX * NX; e += NT) {
    const int l = e / NX, i = e - l * NX;
    sk[L::SP + e] = PT[l * L::NXP + i];
  }
  for (int e = t; e < NX; e += NT) sk[L::Sp + e] = w[L::Wp + e];
  for (int tau = t; tau < L::T_PX; tau += NT) {
    const int ip = tau / (L::XW / 2), jp = tau - ip * (L::XW / 2);
    const int i0 = 2 * ip, m0 = 2 * jp;
    T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
#pragma unroll 4
    for (int l = 0; l < NX; ++l) {
      T p0, p1, x0, x1;
      ld2(PT + l * L::NXP + i0, p0, p1);
      ld2(X + l * L::XW + m0, x0, x1);
      c00 += p0 * x0;
      c01 += p0 * x1;
      c10 += p1 * x0;
      c11 += p1 * x1;
    }
    if (m0 == L::CC) {
      c00 += w[L::Wp + i0];
      if (i0 + 1 < NX) c10 += w[L::Wp + i0 + 1];
    }
    Y[i0 * L::XW + m0] = c00;
    Y[i0 * L::XW + m0 + 1] = c01;
    if (i0 + 1 < NX) {
      Y[(i0 + 1) * L::XW + m0] = c10;
      Y[(i0 + 1) * L::XW + m0 + 1] = c11;
    }
  }
}

template <int NX, int NU>
RLW_HD bool c0_stored(int i, int m) {
  using L = GLay<NX, NU>;
  const bool col = m < NU || (m >= L::CA && m < L::CA + NX) || m == L::CC;
  if (i < NU) return col;
  return i >= L::CA && i < L::CA + NX && m >= L::CA && col;
}

// C0 += Xᵀ Y over the u rows (G, H_ux, g_u) and the x block of the x rows
// (Q + Aᵀ PA, q + Aᵀ Pc_p), in place, 2 x 2 tiles
template <typename T, int NX, int NU, int NT>
RLW_HD void phase_xpx(T* w, T* buf, int t) {
  using L = GLay<NX, NU>;
  const T* X = buf + L::OX;
  const T* Y = w + L::WY;
  T* C0 = buf + L::OC0;
  for (int tau = t; tau < L::T_XU + L::T_XX; tau += NT) {
    int i0, m0;
    if (tau < L::T_XU) {
      const int ip = tau / (L::XW / 2);
      i0 = 2 * ip;
      m0 = 2 * (tau - ip * (L::XW / 2));
    } else {
      const int u = tau - L::T_XU, ip = u / (L::H2 + 1);
      i0 = L::CA + 2 * ip;
      m0 = L::CA + 2 * (u - ip * (L::H2 + 1));
    }
    T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
#pragma unroll 4
    for (int l = 0; l < NX; ++l) {
      T z0, z1, y0, y1;
      ld2(X + l * L::XW + i0, z0, z1);
      ld2(Y + l * L::XW + m0, y0, y1);
      c00 += z0 * y0;
      c01 += z0 * y1;
      c10 += z1 * y0;
      c11 += z1 * y1;
    }
    const T cs[2][2] = {{c00, c01}, {c10, c11}};
    for (int di = 0; di < 2; ++di)
      for (int dm = 0; dm < 2; ++dm)
        if (c0_stored<NX, NU>(i0 + di, m0 + dm)) {
          T* o = C0 + (i0 + di) * L::XW + m0 + dm;
          *o = *o + cs[di][dm];
        }
  }
}

// The Cholesky factor of the M x M matrix whose row l lane l holds in f
// (entries j <= l), in place: below the diagonal the factor, and 1 / L_ii
// in dinv (the diagonal itself is never needed: every step that divides by
// it multiplies by its reciprocal). Per column one reciprocal square root;
// a non-positive pivot makes it NaN.
template <typename T, int M>
RLW_HD void lanes_cholesky(LaneVal<T> (&f)[M], LaneVal<T>& dinv) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const T piv = bcast(f[j], j);
    const T di = wrsqrt(piv > T(0) ? piv : T(-1));
    RLW_FOR_LANES(l) {
      if (l == j)
        dinv.at(l) = di;
      else if (l > j)
        f[j].at(l) = f[j].at(l) * di;
    }
#pragma unroll
    for (int m = j + 1; m < M; ++m) {
      const T lmj = bcast(f[j], m);
      RLW_FOR_LANES(l) {
        if (l >= m) f[m].at(l) -= f[j].at(l) * lmj;
      }
    }
  }
}

// L Lᵀ x = y with the factor of lanes_cholesky, lane l solving its own
// right-hand side y[·].at(l), in place
template <typename T, int M>
RLW_HD void lanes_solve(LaneVal<T> (&f)[M], LaneVal<T>& dinv, LaneVal<T> (&y)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const T lij = bcast(f[j], i);
      RLW_FOR_LANES(l) { y[i].at(l) -= lij * y[j].at(l); }
    }
    const T dii = bcast(dinv, i);
    RLW_FOR_LANES(l) { y[i].at(l) = y[i].at(l) * dii; }
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < M; ++j) {
      const T lji = bcast(f[i], j);
      RLW_FOR_LANES(l) { y[i].at(l) -= lji * y[j].at(l); }
    }
    const T dii = bcast(dinv, i);
    RLW_FOR_LANES(l) { y[i].at(l) = y[i].at(l) * dii; }
  }
}

// L Lᵀ x = y for one right-hand side spread over the lanes (lane i holds y_i,
// then x_i), with the factor of lanes_cholesky: one register per lane where
// lanes_solve takes M
template <typename T, int M>
RLW_HD void lanes_solve_spread(LaneVal<T> (&f)[M], LaneVal<T>& dinv, LaneVal<T>& y) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const T yj = bcast(y, j) * bcast(dinv, j);
    RLW_FOR_LANES(l) {
      if (l == j)
        y.at(l) = yj;
      else if (l > j)
        y.at(l) -= f[j].at(l) * yj;
    }
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    const T xi = bcast(y, i) * bcast(dinv, i);
    RLW_FOR_LANES(l) {
      if (l == i) y.at(l) = xi;
    }
#pragma unroll
    for (int k = 0; k < i; ++k) {
      const T lik = bcast(f[k], i);
      RLW_FOR_LANES(l) {
        if (l == k) y.at(l) -= lik * xi;
      }
    }
  }
}

// [K | kff] = -G⁻¹ [H_ux | g_u] in warp 0 (G = sym(C0's u block) + reg·I);
// K and kff into shared memory, the outputs and the stash; cost_red
template <typename T, int NX, int NU>
RLW_HD void phase_gain(const WPtrs<T>& a, T* w, const T* buf, T* sk, size_t s, T reg) {
  using L = GLay<NX, NU>;
  const T* C0 = buf + L::OC0;
  T* K = w + L::WK;
  T* kf = w + L::Wkf;
  // lane i holds row i of G, then of its Cholesky factor
  LaneVal<T> f[NU], dinv;
  RLW_FOR_LANES(l) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T v = T(0);
      if (l < NU && j <= l)
        v = T(0.5) * (C0[l * L::XW + j] + C0[j * L::XW + l]) + (j == l ? reg : T(0));
      f[j].at(l) = v;
    }
  }
  lanes_cholesky<T, NU>(f, dinv);
  // lane l solves right-hand side base + l: column m of H_ux (m < NX) or g_u
  for (int base = 0; base <= NX; base += 32) {
    LaneVal<T> y[NU];
    RLW_FOR_LANES(l) {
      const int m = base + l;
#pragma unroll
      for (int i = 0; i < NU; ++i)
        y[i].at(l) = m < NX ? C0[i * L::XW + L::CA + m]
                            : (m == NX ? C0[i * L::XW + L::CC] : T(0));
    }
    lanes_solve<T, NU>(f, dinv, y);
    RLW_FOR_LANES(l) {
      const int m = base + l;
      if (m < NX) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const T v = -y[i].at(l);
          K[i * L::NXP + m] = v;
          a.K[s * NU * NX + i * NX + m] = v;
          sk[L::SK + i * NX + m] = v;
        }
      } else if (m == NX) {
        T dec = T(0);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const T v = -y[i].at(l);
          kf[i] = v;
          a.kff[s * NU + i] = v;
          sk[L::Sk + i] = v;
          dec += v * C0[i * L::XW + L::CC];
        }
        w[L::WDEC] -= T(0.5) * dec;
      }
    }
  }
}

// dx0 = −(P0 + reg·I)⁻¹ p0 in warp 0, from P0 (PT, symmetric) and p0 as the
// backward pass leaves them; lane i solves for and writes dx0_i into the
// forward pass's dx
template <typename T, int NX, int NU>
RLW_HD void phase_free_dx0(T* w, T reg) {
  using L = GLay<NX, NU>;
  const T* PT = w + L::WPT;
  LaneVal<T> f[NX], dinv, y;
  RLW_FOR_LANES(l) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      f[j].at(l) = (l < NX && j <= l) ? PT[l * L::NXP + j] + (j == l ? reg : T(0))
                                      : T(0);
    y.at(l) = l < NX ? w[L::Wp + l] : T(0);
  }
  lanes_cholesky<T, NX>(f, dinv);
  lanes_solve_spread<T, NX>(f, dinv, y);
  RLW_FOR_LANES(l) {
    if (l < NX) w[L::WDX + l] = -y.at(l);
  }
}

// P <- sym(Q + Aᵀ PA + H_uxᵀ K) (mirrored 2 x 2 tiles), p <- q + Aᵀ Pc_p +
// H_uxᵀ kff (pairs)
template <typename T, int NX, int NU, int NT>
RLW_HD void phase_update(T* w, const T* buf, int t) {
  using L = GLay<NX, NU>;
  const T* C0 = buf + L::OC0;
  const T* K = w + L::WK;
  const T* kf = w + L::Wkf;
  T* PT = w + L::WPT;
  constexpr int TRI = L::H2 * (L::H2 + 1) / 2;
  for (int tau = t; tau < L::T_P; tau += NT) {
    if (tau >= TRI) {
      const int i0 = 2 * (tau - TRI);
      for (int di = 0; di < 2; ++di) {
        const int i = i0 + di;
        if (i >= NX) break;
        T v = C0[(L::CA + i) * L::XW + L::CC];
        for (int j = 0; j < NU; ++j) v += C0[j * L::XW + L::CA + i] * kf[j];
        w[L::Wp + i] = v;
      }
      continue;
    }
    int ip = 0, rem = tau;
    while (rem >= L::H2 - ip) {
      rem -= L::H2 - ip;
      ++ip;
    }
    const int i0 = 2 * ip, m0 = 2 * (ip + rem);
    // V = W + H_uxᵀ K at (i, m) and at the mirror (m, i)
    T v[2][2], u[2][2];
    for (int di = 0; di < 2; ++di)
      for (int dm = 0; dm < 2; ++dm) {
        v[di][dm] = C0[(L::CA + i0 + di) * L::XW + L::CA + m0 + dm];
        u[dm][di] = C0[(L::CA + m0 + dm) * L::XW + L::CA + i0 + di];
      }
#pragma unroll 4
    for (int j = 0; j < NU; ++j) {
      T hi0, hi1, km0, km1, hm0, hm1, ki0, ki1;
      ld2(C0 + j * L::XW + L::CA + i0, hi0, hi1);
      ld2(K + j * L::NXP + m0, km0, km1);
      ld2(C0 + j * L::XW + L::CA + m0, hm0, hm1);
      ld2(K + j * L::NXP + i0, ki0, ki1);
      v[0][0] += hi0 * km0;
      v[0][1] += hi0 * km1;
      v[1][0] += hi1 * km0;
      v[1][1] += hi1 * km1;
      u[0][0] += hm0 * ki0;
      u[0][1] += hm0 * ki1;
      u[1][0] += hm1 * ki0;
      u[1][1] += hm1 * ki1;
    }
    for (int di = 0; di < 2; ++di)
      for (int dm = 0; dm < 2; ++dm) {
        const int i = i0 + di, m = m0 + dm;
        if (i < NX && m < NX) {
          const T sym = T(0.5) * (v[di][dm] + u[dm][di]);
          PT[m * L::NXP + i] = sym;
          PT[i * L::NXP + m] = sym;
        }
      }
  }
}

// The whole solve of scenario b by one group of NT threads, w its shared
// memory (E words).
template <typename T, int NX, int NU, int NT>
RLW_HD void lq_group(const WPtrs<T>& a, T* w, size_t b, int N, T reg) {
  using L = GLay<NX, NU>;
  const size_t n = static_cast<size_t>(N);
  RLW_FOR_THREADS(t, NT) {
    for (int e = t; e < L::E; e += NT) w[e] = T(0);
  }
  group_sync();
  RLW_FOR_THREADS(t, NT) {
    for (int e = t; e < NX * NX; e += NT) {
      const int i = e / NX, l = e - i * NX;
      w[L::WPT + l * L::NXP + i] = a.P_term[b * NX * NX + e];
    }
    for (int e = t; e < NX; e += NT) w[L::Wp + e] = a.p_term[b * NX + e];
    load_bwd<T, NX, NU, NT>(a, w + ((N - 1) & 1) * L::BUF, b, n, N - 1, t);
    cp_commit();
  }

  for (int k = N - 1; k >= 0; --k) {
    T* const buf = w + (k & 1) * L::BUF;
    T* const sk = a.stash + (b * n + k) * L::SW;
    cp_wait_all();
    group_sync();
    RLW_FOR_THREADS(t, NT) {
      if (k > 0) {
        load_bwd<T, NX, NU, NT>(a, w + ((k - 1) & 1) * L::BUF, b, n, k - 1, t);
        cp_commit();
      }
      phase_px<T, NX, NU, NT>(w, buf, sk, t);
    }
    group_sync();
    RLW_FOR_THREADS(t, NT) { phase_xpx<T, NX, NU, NT>(w, buf, t); }
    group_sync();
#ifdef __CUDA_ARCH__
    if (threadIdx.x < 32)
#endif
      phase_gain<T, NX, NU>(a, w, buf, sk, b * n + k, reg);
    group_sync();
    RLW_FOR_THREADS(t, NT) { phase_update<T, NX, NU, NT>(w, buf, t); }
  }
  group_sync();
  if (a.free_x0) {
#ifdef __CUDA_ARCH__
    if (threadIdx.x < 32)
#endif
      phase_free_dx0<T, NX, NU>(w, reg);
    group_sync();
  }

  T* const dx = w + L::WDX;
  T* const dxn = w + L::WDXN;
  T* const du = w + L::WDU;
  RLW_FOR_THREADS(t, NT) {
    if (t == 0) a.cost_red[b] = w[L::WDEC];
    for (int e = t; e < NX; e += NT) {
      if (!a.free_x0) dx[e] = a.dx0[b * NX + e];
      a.dX[b * (n + 1) * NX + e] = dx[e];
    }
    load_fwd<T, NX, NU, NT>(a, w, b, n, 0, t);
    cp_commit();
  }
  for (int k = 0; k < N; ++k) {
    const T* const buf = w + (k & 1) * L::BUF;
    const T* const X = buf + L::OX;
    const size_t s = b * n + k;
    cp_wait_all();
    group_sync();
    RLW_FOR_THREADS(t, NT) {
      if (k + 1 < N) {
        load_fwd<T, NX, NU, NT>(a, w + ((k + 1) & 1) * L::BUF, b, n, k + 1, t);
        cp_commit();
      }
      for (int i = t; i < NU; i += NT) {
        T v = buf[L::Fkf + i];
        for (int m = 0; m < NX; ++m) v += buf[L::FK + i * L::FKW + m] * dx[m];
        du[i] = v;
        a.dU[s * NU + i] = v;
      }
    }
    group_sync();
    RLW_FOR_THREADS(t, NT) {
      for (int i = t; i < NX; i += NT) {
        T v = X[i * L::XW + L::CC];
        for (int m = 0; m < NX; ++m) v += X[i * L::XW + L::CA + m] * dx[m];
        for (int m = 0; m < NU; ++m) v += X[i * L::XW + m] * du[m];
        dxn[i] = v;
        a.dX[(s + b + 1) * NX + i] = v;
      }
    }
    group_sync();
    RLW_FOR_THREADS(t, NT) {
      for (int i = t; i < NX; i += NT) {
        T v = buf[L::Fp + i];
        for (int m = 0; m < NX; ++m) v += buf[L::FPT + m * L::NXP + i] * dxn[m];
        a.lam[s * NX + i] = v;
        dx[i] = dxn[i];
      }
    }
  }
}

template <typename T>
WPtrs<T> wptrs(const void* A, const void* B, const void* Q, const void* S,
               const void* R, const void* q, const void* r, const void* c,
               const void* P_term, const void* p_term, const void* dx0, void* dX,
               void* dU, void* lam, void* K, void* kff, void* cost_red,
               void* stash, int free_x0) {
  WPtrs<T> a;
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

// (warps per scenario, dynamic shared memory bytes, stash words per stage)
template <typename T, int NX, int NU, int G>
int wide_layout(int* out) {
  out[0] = G;
  out[1] = static_cast<int>(sizeof(T) * GLay<NX, NU>::E);
  out[2] = GLay<NX, NU>::SW;
  return 0;
}

#ifdef __CUDACC__
// at least one block per SM, nothing more: with the thread count alone
// ptxas held (16, 8) to 128 registers and spilled 12 bytes
template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(32 * G, 1)
riccati_lq_wide_kernel(WPtrs<T> a, int N, T reg) {
  extern __shared__ __align__(16) unsigned char rlw_smem[];
  lq_group<T, NX, NU, 32 * G>(a, reinterpret_cast<T*>(rlw_smem),
                              static_cast<size_t>(blockIdx.x), N, reg);
}

constexpr int RLW_MAX_DEVICES = 64;

// dynamic shared memory above 48 KB, set once per device and instance (in
// an anonymous namespace, so that its static is this library's own and not
// one STB_GNU_UNIQUE symbol shared with another library of the same name)
namespace {
template <typename T, int NX, int NU, int G>
cudaError_t set_wide_attributes() {
  static bool done[RLW_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < RLW_MAX_DEVICES;
  if (known && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(riccati_lq_wide_kernel<T, NX, NU, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(T) * GLay<NX, NU>::E));
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}
}  // namespace

template <typename T, int NX, int NU, int G>
int wide_launch(const WPtrs<T>& a, int Bt, int N, double reg, void* stream) {
  static_assert(NX >= 1 && NX <= 32 && NU >= 1 && NU <= 16 && G >= 1 && G <= 32,
                "sizes");
  if (Bt <= 0 || N <= 0 || (!a.free_x0 && a.dx0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_wide_attributes<T, NX, NU, G>();
  if (e != cudaSuccess) return static_cast<int>(e);
  riccati_lq_wide_kernel<T, NX, NU, G>
      <<<Bt, 32 * G, sizeof(T) * GLay<NX, NU>::E, static_cast<cudaStream_t>(stream)>>>(
          a, N, static_cast<T>(reg));
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename T, int NX, int NU, int G>
int wide_run_host(const WPtrs<T>& a, int Bt, int N, double reg) {
  if (Bt <= 0 || N <= 0 || (!a.free_x0 && a.dx0 == nullptr)) return 1;
  std::vector<T> smem(GLay<NX, NU>::E);
  for (long long b = 0; b < Bt; ++b)
    lq_group<T, NX, NU, 32 * G>(a, smem.data(), static_cast<size_t>(b), N,
                                static_cast<T>(reg));
  return 0;
}
#endif

}  // namespace rlw

// The C entry points of one (NX, NU) instantiation (bound with ctypes), with
// the warps per scenario of each dtype given by the generated text as
// RICCATI_LQ_WIDE_GROUP_F32 and RICCATI_LQ_WIDE_GROUP_F64. On the card
// riccati_lq_wide_f32 / _f64 enqueue the kernel on `stream` and return its
// cudaError_t; on the host riccati_lq_wide_host_f32 / _f64 run the same
// group schedule in loops. riccati_lq_wide_layout_f32 / _f64 write (warps
// per scenario, dynamic shared memory bytes, stash words per stage) in both
// builds. The arguments are those of riccati_lq.cuh's entry points.
#define RLW_ARGS                                                              \
  const void *A, const void *B, const void *Q, const void *S, const void *R,  \
      const void *q, const void *r, const void *c, const void *P_term,        \
      const void *p_term, const void *dx0, void *dX, void *dU, void *lam,     \
      void *K, void *kff, void *cost_red, void *stash, int Bt, int N,         \
      double reg, int free_x0
#define RLW_PTRS(T)                                                           \
  rlw::wptrs<T>(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, dX, dU, lam, K,  \
                kff, cost_red, stash, free_x0)
#define RLW_LAYOUTS(NX, NU)                                                   \
  extern "C" int riccati_lq_wide_layout_f32(int* out) {                       \
    return rlw::wide_layout<float, NX, NU, RICCATI_LQ_WIDE_GROUP_F32>(out);   \
  }                                                                           \
  extern "C" int riccati_lq_wide_layout_f64(int* out) {                       \
    return rlw::wide_layout<double, NX, NU, RICCATI_LQ_WIDE_GROUP_F64>(out);  \
  }
#ifdef __CUDACC__
#define RICCATI_LQ_WIDE_EXPORTS(NX, NU)                                       \
  RLW_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_wide_f32(RLW_ARGS, void* stream) {                \
    return rlw::wide_launch<float, NX, NU, RICCATI_LQ_WIDE_GROUP_F32>(        \
        RLW_PTRS(float), Bt, N, reg, stream);                                 \
  }                                                                           \
  extern "C" int riccati_lq_wide_f64(RLW_ARGS, void* stream) {                \
    return rlw::wide_launch<double, NX, NU, RICCATI_LQ_WIDE_GROUP_F64>(       \
        RLW_PTRS(double), Bt, N, reg, stream);                                \
  }
#else
#define RICCATI_LQ_WIDE_EXPORTS(NX, NU)                                       \
  RLW_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_wide_host_f32(RLW_ARGS) {                         \
    return rlw::wide_run_host<float, NX, NU, RICCATI_LQ_WIDE_GROUP_F32>(      \
        RLW_PTRS(float), Bt, N, reg);                                         \
  }                                                                           \
  extern "C" int riccati_lq_wide_host_f64(RLW_ARGS) {                         \
    return rlw::wide_run_host<double, NX, NU, RICCATI_LQ_WIDE_GROUP_F64>(     \
        RLW_PTRS(double), Bt, N, reg);                                        \
  }
#endif
