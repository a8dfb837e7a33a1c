// Batched stagewise LQ KKT solve (backward Riccati recursion + forward
// rollout + dynamics multipliers), one CUDA thread per scenario.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:
// riccati_lq_pallas (pallas_call at line 431). Same math as its kernel body
// (lines 293-400): for k = N-1..0
//   Pc_p = P c + p,  PA = P A,  PB = P B
//   G    = sym(R + Bᵀ PB) + reg·I            (nu x nu Schur complement)
//   H_ux = S + Bᵀ PA,  g_u = r + Bᵀ Pc_p
//   [K | kff] = -G⁻¹ [H_ux | g_u]           (unrolled Cholesky + substitution)
//   P <- sym(Q + Aᵀ PA + H_uxᵀ K),  p <- q + Aᵀ Pc_p + H_uxᵀ kff
//   cost_red -= ½ kffᵀ g_u
// with (P_{k+1}, p_{k+1}) stashed per stage, then the forward pass
//   du = K dx + kff,  dx' = A dx + B du + c,  lam = P_{k+1} dx' + p_{k+1}.
//
// Design. The TPU kernel puts the batch in vector lanes and unrolls stages
// and indices at trace time. Here each thread owns one scenario: nx and nu
// are template parameters, so every small matrix lives in registers and all
// index loops unroll; the horizon N is a runtime loop bound. This header
// holds the template; ops/cuda_kernels.py:riccati_lq_source writes the
// instantiation for one (nx, nu) (RICCATI_LQ_EXPORTS below), built at first
// use. Threads with b >= Bt return, which replaces the padded-lane R = I
// trick of the TPU kernel. The (P, p) stash for the forward pass goes to a
// scratch buffer the caller allocates.
//
// Bound. At the flagship shape (nx=2, nu=1) a scenario moves about
// 4·(N·(2nx²+2nx·nu+nu²+3nx+nu) + outputs + stash) bytes in float32 and does a
// few hundred FLOPs per stage, far below the H100's ~20 FLOP/byte ridge:
// the kernel is memory-bound. This first version reads the batch-first layout
// directly, so neighbouring threads load addresses one scenario (N·nx² values)
// apart and loads do not coalesce; a scenario-minor layout or shared-memory
// staging is the next step. The launcher takes PyTorch's current stream,
// allocates nothing and never synchronizes.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace rlq {

template <typename T> __device__ __forceinline__ T dsqrt(T v);
template <> __device__ __forceinline__ float dsqrt<float>(float v) { return sqrtf(v); }
template <> __device__ __forceinline__ double dsqrt<double>(double v) { return sqrt(v); }

template <typename T, int NX, int NU>
__global__ void riccati_lq_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Q,
    const T* __restrict__ S, const T* __restrict__ R, const T* __restrict__ q,
    const T* __restrict__ r, const T* __restrict__ c,
    const T* __restrict__ P_term, const T* __restrict__ p_term,
    const T* __restrict__ dx0,
    T* __restrict__ dX, T* __restrict__ dU, T* __restrict__ lam,
    T* __restrict__ Kout, T* __restrict__ kffout, T* __restrict__ cost_red,
    T* __restrict__ Pn, T* __restrict__ pn,
    int Bt, int N, T reg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bt) return;
  const size_t sb = static_cast<size_t>(b);
  const size_t n = static_cast<size_t>(N);
  const T* Ab = A + sb * n * NX * NX;
  const T* Bb = Bm + sb * n * NX * NU;
  const T* Qb = Q + sb * n * NX * NX;
  const T* Sb = S + sb * n * NU * NX;
  const T* Rb = R + sb * n * NU * NU;
  const T* qb = q + sb * n * NX;
  const T* rb = r + sb * n * NU;
  const T* cb = c + sb * n * NX;
  T* Kb = Kout + sb * n * NU * NX;
  T* kffb = kffout + sb * n * NU;
  T* Pnb = Pn + sb * n * NX * NX;
  T* pnb = pn + sb * n * NX;

  T P[NX][NX], p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    p[i] = p_term[sb * NX + i];
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = P_term[sb * NX * NX + i * NX + j];
  }
  T dec = T(0);

  // ---- backward sweep ----
  for (int k = N - 1; k >= 0; --k) {
    const size_t kk = static_cast<size_t>(k);
    T Ak[NX][NX], Bk[NX][NU], ck[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ck[i] = cb[kk * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Ak[i][j] = Ab[kk * NX * NX + i * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Bk[i][j] = Bb[kk * NX * NU + i * NU + j];
    }
    // stash (P_{k+1}, p_{k+1}) for the forward pass
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      pnb[kk * NX + i] = p[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Pnb[kk * NX * NX + i * NX + j] = P[i][j];
    }
    T Pc_p[NX], PA[NX][NX], PB[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += P[i][l] * ck[l];
      Pc_p[i] = acc + p[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a += P[i][l] * Ak[l][j];
        PA[i][j] = a;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a += P[i][l] * Bk[l][j];
        PB[i][j] = a;
      }
    }
    T G[NU][NU], Gs[NU][NU], Hux[NU][NX], gu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a += Bk[l][i] * PB[l][j];
        G[i][j] = Rb[kk * NU * NU + i * NU + j] + a;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a += Bk[l][i] * PA[l][j];
        Hux[i][j] = Sb[kk * NU * NX + i * NX + j] + a;
      }
      T a = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) a += Bk[l][i] * Pc_p[l];
      gu[i] = rb[kk * NU + i] + a;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Gs[i][j] = T(0.5) * (G[i][j] + G[j][i]) + (i == j ? reg : T(0));

    // G X = [H_ux | g_u] by Cholesky G = L Lᵀ, then L Y = rhs, Lᵀ X = Y
    T L[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (j > i) continue;
        T s = Gs[i][j];
#pragma unroll
        for (int l = 0; l < NU; ++l)
          if (l < j) s -= L[i][l] * L[j][l];
        L[i][j] = (i == j) ? dsqrt<T>(s) : s / L[j][j];
      }
    }
    T Xc[NU][NX + 1];
#pragma unroll
    for (int m = 0; m <= NX; ++m) {
      T Y[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T acc = (m < NX) ? Hux[i][m] : gu[i];
#pragma unroll
        for (int l = 0; l < NU; ++l)
          if (l < i) acc -= L[i][l] * Y[l];
        Y[i] = acc / L[i][i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        T acc = Y[i];
#pragma unroll
        for (int l = 0; l < NU; ++l)
          if (l > i) acc -= L[l][i] * Xc[l][m];
        Xc[i][m] = acc / L[i][i];
      }
    }
    T K[NU][NX], kff[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        K[i][j] = -Xc[i][j];
        Kb[kk * NU * NX + i * NX + j] = K[i][j];
      }
      kff[i] = -Xc[i][NX];
      kffb[kk * NU + i] = kff[i];
    }
    // value-function update
    T Pnew[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = Qb[kk * NX * NX + i * NX + j];
#pragma unroll
        for (int l = 0; l < NX; ++l) a += Ak[l][i] * PA[l][j];
#pragma unroll
        for (int l = 0; l < NU; ++l) a += Hux[l][i] * K[l][j];
        Pnew[i][j] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = T(0.5) * (Pnew[i][j] + Pnew[j][i]);
      T a = qb[kk * NX + i];
#pragma unroll
      for (int l = 0; l < NX; ++l) a += Ak[l][i] * Pc_p[l];
#pragma unroll
      for (int l = 0; l < NU; ++l) a += Hux[l][i] * kff[l];
      p[i] = a;
    }
    T d = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) d += kff[i] * gu[i];
    dec -= T(0.5) * d;
  }
  cost_red[sb] = dec;

  // ---- forward rollout ----
  T dx[NX];
  T* dXb = dX + sb * (n + 1) * NX;
  T* dUb = dU + sb * n * NU;
  T* lamb = lam + sb * n * NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    dx[i] = dx0[sb * NX + i];
    dXb[i] = dx[i];
  }
  for (int k = 0; k < N; ++k) {
    const size_t kk = static_cast<size_t>(k);
    T du[NU], dxn[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T a = kffb[kk * NU + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) a += Kb[kk * NU * NX + i * NX + j] * dx[j];
      du[i] = a;
      dUb[kk * NU + i] = a;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = cb[kk * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) a += Ab[kk * NX * NX + i * NX + j] * dx[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) a += Bb[kk * NX * NU + i * NU + j] * du[j];
      dxn[i] = a;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = pnb[kk * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) a += Pnb[kk * NX * NX + i * NX + j] * dxn[j];
      lamb[kk * NX + i] = a;
      dXb[(kk + 1) * NX + i] = dxn[i];
      dx[i] = dxn[i];
    }
  }
}

template <typename T, int NX, int NU>
cudaError_t launch(const void* A, const void* B, const void* Q, const void* S,
                   const void* R, const void* q, const void* r, const void* c,
                   const void* P_term, const void* p_term, const void* dx0,
                   void* dX, void* dU, void* lam, void* K, void* kff,
                   void* cost_red, void* Pn, void* pn, int Bt, int N,
                   double reg, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (Bt + threads - 1) / threads;
  riccati_lq_kernel<T, NX, NU><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(Q), static_cast<const T*>(S),
      static_cast<const T*>(R), static_cast<const T*>(q),
      static_cast<const T*>(r), static_cast<const T*>(c),
      static_cast<const T*>(P_term), static_cast<const T*>(p_term),
      static_cast<const T*>(dx0), static_cast<T*>(dX), static_cast<T*>(dU),
      static_cast<T*>(lam), static_cast<T*>(K), static_cast<T*>(kff),
      static_cast<T*>(cost_red), static_cast<T*>(Pn), static_cast<T*>(pn),
      Bt, N, static_cast<T>(reg));
  return cudaGetLastError();
}

}  // namespace rlq

// The C entry points of one (NX, NU) instantiation (bound with ctypes). Each
// returns the cudaError_t of the launch; 0 means the kernel was enqueued on
// `stream`.
#define RLQ_ARGS                                                              \
  const void *A, const void *B, const void *Q, const void *S, const void *R,  \
      const void *q, const void *r, const void *c, const void *P_term,        \
      const void *p_term, const void *dx0, void *dX, void *dU, void *lam,     \
      void *K, void *kff, void *cost_red, void *Pn, void *pn, int Bt, int N,  \
      double reg, void *stream
#define RLQ_CALL(T, NX, NU)                                                   \
  (Bt <= 0 || N <= 0)                                                         \
      ? static_cast<int>(cudaErrorInvalidValue)                               \
      : static_cast<int>(rlq::launch<T, NX, NU>(                              \
            A, B, Q, S, R, q, r, c, P_term, p_term, dx0, dX, dU, lam, K, kff, \
            cost_red, Pn, pn, Bt, N, reg, static_cast<cudaStream_t>(stream)))
#define RICCATI_LQ_EXPORTS(NX, NU)                                            \
  extern "C" int riccati_lq_f32(RLQ_ARGS) { return RLQ_CALL(float, NX, NU); } \
  extern "C" int riccati_lq_f64(RLQ_ARGS) { return RLQ_CALL(double, NX, NU); }
