// Batched stagewise LQ KKT solve for the sizes above the tiled kernel's cap
// (riccati_lq.cuh takes nx <= 8 and nu <= 4): one warp per scenario, up to
// nx = 32 and nu = 16.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:169
// riccati_lq_pallas (pallas_call at line 431) for those sizes; the JAX
// dispatcher (hilo_mpc_tpu/ops/riccati.py:279-311) tiles its kernel to fit
// VMEM at any size. Same recursion, and per output element the same order of
// operations, as riccati_lq.cuh (see its head): for k = N-1..0 the stash of
// (P, p)_{k+1}, Pc_p = P c + p, PA = P A, PB = P B, G = sym(R + Bᵀ PB) + reg·I,
// H_ux = S + Bᵀ PA, g_u = r + Bᵀ Pc_p, [K | kff] = -G⁻¹ [H_ux | g_u] by
// Cholesky, P <- sym(Q + Aᵀ PA + H_uxᵀ K), p <- q + Aᵀ Pc_p + H_uxᵀ kff,
// cost_red -= ½ kffᵀ g_u; then du = K dx + kff, dx' = A dx + B du + c,
// lam = P_{k+1} dx' + p_{k+1}.
//
// Bound. Per stage a scenario does ~4·nx³ + 6·nx²·nu FLOPs (4.5·10⁴ at
// (16, 8), 2.5·10⁵ at (32, 16)) on the eight stage inputs and five outputs
// (~1,050 values at (16, 8), ~4,000 at (32, 16)): 5–8 FLOPs per byte in
// float64, below the H100's ~10 (float64) and ~20 (float32) FLOPs per byte
// of HBM, so the bytes (each input read once, each output written once)
// bound it. What a thread per scenario cannot do at these sizes is hold P
// (up to 32 x 32) and the stage's blocks in registers: the tiled kernel's
// (8, 4) float64 instance already spills. This design's own limit is the
// latency of a warp's serial phases: each FMA of the row products reads two
// shared-memory words, and a stage runs ~10 + 2·nu warp barriers.
//
// Design. A warp owns a scenario; lane i owns row i of the nx-sized products
// (P A, P B, P c, the update of P and p, the forward rollout), the
// nu x (nu + nx + 1) products of G, H_ux and g_u are dealt to the lanes
// element by element, the Cholesky factor is built column by column (the
// diagonal by lane 0, the column below it by the lanes of its rows) and each
// lane solves its own right-hand sides of [H_ux | g_u]. P, p, the stage's
// inputs and the products live in the warp's slice of shared memory (WLay
// below), and __syncwarp separates the phases. A stage's inputs are a
// contiguous run per field, which the lanes copy word by word (coalesced).
// The (P, p, K, kff) stash of the forward pass goes to a global scratch
// (Bt, N, SW) the wrapper allocates, a warp's run per stage again
// contiguous. W warps (scenarios) share a block; ops/cuda_kernels.py:
// riccati_lq_wide_warps chooses W per (nx, nu, dtype) and writes it into the
// instantiation text. The phase functions are __host__ __device__: the host
// build runs the 32 lanes of each phase in a loop, so the CPU tests reach
// the same arithmetic, ragged batches included. The launcher takes PyTorch's
// current stream, allocates nothing and never synchronizes.
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

namespace rlw {

RLW_HD float wsqrt(float v) { return sqrtf(v); }
RLW_HD double wsqrt(double v) { return sqrt(v); }

// Offsets in one warp's shared slice: the stage's inputs in the order of
// riccati_lq.cuh (A, B, c, Q, S, R, q, r), then the work arrays. The stash
// per stage: P, p, K, kff.
template <int NX, int NU>
struct WLay {
  static constexpr int EA = NX * NX, EB = NX * NU, EC = NX, EQ = NX * NX;
  static constexpr int ES = NU * NX, ER = NU * NU, EQV = NX, ERV = NU;
  static constexpr int OA = 0, OB = OA + EA, OC = OB + EB, OQ = OC + EC;
  static constexpr int OS = OQ + EQ, OR = OS + ES, OQV = OR + ER, ORV = OQV + EQV;
  static constexpr int F_IN = ORV + ERV;
  static constexpr int WP = F_IN, Wp = WP + NX * NX, WPA = Wp + NX;
  static constexpr int WPB = WPA + NX * NX, WPC = WPB + NX * NU, WG = WPC + NX;
  static constexpr int WL = WG + NU * NU, WH = WL + NU * NU, WGU = WH + NU * NX;
  static constexpr int WK = WGU + NU, WKF = WK + NU * NX, WDX = WKF + NU;
  static constexpr int WDU = WDX + NX, WDEC = WDU + NU, E = WDEC + 1;
  static constexpr int SP = 0, Sp = NX * NX, SK = Sp + NX, Sk = SK + NU * NX;
  static constexpr int SW = Sk + NU;
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
};

// f(lane) for this thread's lane on the card; for the 32 lanes in order on
// the host
template <typename F>
RLW_HD void lanes(const F& f) {
#ifdef __CUDA_ARCH__
  f(static_cast<int>(threadIdx.x & 31u));
#else
  for (int l = 0; l < 32; ++l) f(l);
#endif
}

RLW_HD void wsync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// The whole solve of scenario b by one warp, w its shared slice.
template <typename T, int NX, int NU>
RLW_HD void lq_scenario(const WPtrs<T>& a, T* w, size_t b, int N, T reg) {
  using L = WLay<NX, NU>;
  const size_t n = static_cast<size_t>(N);
  T* const P = w + L::WP;
  T* const p = w + L::Wp;
  T* const PA = w + L::WPA;
  T* const PB = w + L::WPB;
  T* const Pcp = w + L::WPC;
  T* const G = w + L::WG;
  T* const Lc = w + L::WL;
  T* const Hux = w + L::WH;
  T* const gu = w + L::WGU;
  T* const K = w + L::WK;
  T* const kf = w + L::WKF;
  T* const dx = w + L::WDX;
  T* const du = w + L::WDU;
  const T* const A = w + L::OA;
  const T* const Bm = w + L::OB;
  const T* const c = w + L::OC;
  T* const Q = w + L::OQ;
  const T* const S = w + L::OS;
  const T* const R = w + L::OR;
  const T* const q = w + L::OQV;
  const T* const r = w + L::ORV;
  const int e_in[8] = {L::EA, L::EB, L::EC, L::EQ, L::ES, L::ER, L::EQV, L::ERV};
  const int o_in[8] = {L::OA, L::OB, L::OC, L::OQ, L::OS, L::OR, L::OQV, L::ORV};
  // the first nf fields of stage k into the slice
  auto load_stage = [&](int l, int k, int nf) {
    for (int f = 0; f < nf; ++f) {
      const T* g = a.in[f] + (b * n + k) * e_in[f];
      for (int e = l; e < e_in[f]; e += 32) w[o_in[f] + e] = g[e];
    }
  };

  lanes([&](int l) {
    for (int e = l; e < NX * NX; e += 32) P[e] = a.P_term[b * NX * NX + e];
    for (int e = l; e < NX; e += 32) p[e] = a.p_term[b * NX + e];
    if (l == 0) w[L::WDEC] = T(0);
  });
  wsync();

  for (int k = N - 1; k >= 0; --k) {
    T* const sk = a.stash + (b * n + k) * L::SW;
    // the stage's inputs; the stash of (P, p)_{k+1}
    lanes([&](int l) {
      load_stage(l, k, 8);
      for (int e = l; e < NX * NX; e += 32) sk[L::SP + e] = P[e];
      for (int e = l; e < NX; e += 32) sk[L::Sp + e] = p[e];
    });
    wsync();
    // Pc_p, PA, PB: row i by lane i
    lanes([&](int i) {
      if (i >= NX) return;
      T acc = T(0);
      for (int l = 0; l < NX; ++l) acc += P[i * NX + l] * c[l];
      Pcp[i] = acc + p[i];
      for (int m = 0; m < NX; ++m) {
        T v = T(0);
        for (int l = 0; l < NX; ++l) v += P[i * NX + l] * A[l * NX + m];
        PA[i * NX + m] = v;
      }
      for (int m = 0; m < NU; ++m) {
        T v = T(0);
        for (int l = 0; l < NX; ++l) v += P[i * NX + l] * Bm[l * NU + m];
        PB[i * NU + m] = v;
      }
    });
    wsync();
    // G, H_ux and g_u, element by element
    lanes([&](int l) {
      constexpr int W1 = NU + NX + 1;
      for (int e = l; e < NU * W1; e += 32) {
        const int i = e / W1, m = e - i * W1;
        T v = T(0);
        if (m < NU) {
          for (int j = 0; j < NX; ++j) v += Bm[j * NU + i] * PB[j * NU + m];
          G[i * NU + m] = R[i * NU + m] + v;
        } else if (m < NU + NX) {
          for (int j = 0; j < NX; ++j) v += Bm[j * NU + i] * PA[j * NX + m - NU];
          Hux[i * NX + m - NU] = S[i * NX + m - NU] + v;
        } else {
          for (int j = 0; j < NX; ++j) v += Bm[j * NU + i] * Pcp[j];
          gu[i] = r[i] + v;
        }
      }
    });
    wsync();
    lanes([&](int l) {
      for (int e = l; e < NU * NU; e += 32) {
        const int i = e / NU, m = e - i * NU;
        Lc[e] = T(0.5) * (G[i * NU + m] + G[m * NU + i]) + (i == m ? reg : T(0));
      }
    });
    wsync();
    // Cholesky G = L Lᵀ in place over the lower triangle, column by column
    for (int j = 0; j < NU; ++j) {
      lanes([&](int l) {
        if (l != 0) return;
        T v = Lc[j * NU + j];
        for (int t = 0; t < j; ++t) v -= Lc[j * NU + t] * Lc[j * NU + t];
        Lc[j * NU + j] = wsqrt(v);
      });
      wsync();
      lanes([&](int i) {
        if (i <= j || i >= NU) return;
        T v = Lc[i * NU + j];
        for (int t = 0; t < j; ++t) v -= Lc[i * NU + t] * Lc[j * NU + t];
        Lc[i * NU + j] = v / Lc[j * NU + j];
      });
      wsync();
    }
    // [K | kff] = -G⁻¹ [H_ux | g_u]: lane l solves columns l, l+32, ...
    lanes([&](int l) {
      for (int m = l; m <= NX; m += 32) {
        // Y and X stay in registers: every index is known at compile time
        T Y[NU], X[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T acc = (m < NX) ? Hux[i * NX + m] : gu[i];
#pragma unroll
          for (int t = 0; t < i; ++t) acc -= Lc[i * NU + t] * Y[t];
          Y[i] = acc / Lc[i * NU + i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          T acc = Y[i];
#pragma unroll
          for (int t = i + 1; t < NU; ++t) acc -= Lc[t * NU + i] * X[t];
          X[i] = acc / Lc[i * NU + i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          if (m < NX)
            K[i * NX + m] = -X[i];
          else
            kf[i] = -X[i];
        }
      }
    });
    wsync();
    // K and kff out and into the stash; the update of P (into Q's buffer)
    // and p, row i by lane i
    lanes([&](int l) {
      for (int e = l; e < NU * NX; e += 32) {
        a.K[(b * n + k) * NU * NX + e] = K[e];
        sk[L::SK + e] = K[e];
      }
      for (int e = l; e < NU; e += 32) {
        a.kff[(b * n + k) * NU + e] = kf[e];
        sk[L::Sk + e] = kf[e];
      }
      const int i = l;
      if (i >= NX) return;
      for (int m = 0; m < NX; ++m) {
        T v = Q[i * NX + m];
        for (int j = 0; j < NX; ++j) v += A[j * NX + i] * PA[j * NX + m];
        for (int j = 0; j < NU; ++j) v += Hux[j * NX + i] * K[j * NX + m];
        Q[i * NX + m] = v;
      }
      T v = q[i];
      for (int j = 0; j < NX; ++j) v += A[j * NX + i] * Pcp[j];
      for (int j = 0; j < NU; ++j) v += Hux[j * NX + i] * kf[j];
      p[i] = v;
    });
    wsync();
    lanes([&](int i) {
      if (i == 0) {
        T d = T(0);
        for (int j = 0; j < NU; ++j) d += kf[j] * gu[j];
        w[L::WDEC] -= T(0.5) * d;
      }
      if (i >= NX) return;
      for (int m = 0; m < NX; ++m) P[i * NX + m] = T(0.5) * (Q[i * NX + m] + Q[m * NX + i]);
    });
    wsync();
  }

  lanes([&](int l) {
    if (l == 0) a.cost_red[b] = w[L::WDEC];
    for (int e = l; e < NX; e += 32) {
      dx[e] = a.dx0[b * NX + e];
      a.dX[b * (n + 1) * NX + e] = dx[e];
    }
  });
  wsync();
  // forward rollout: A, B, c and the stash of stage k into the slice
  // (P_{k+1} into P, p_{k+1} into p, K, kff)
  T* const dxn = Pcp;
  for (int k = 0; k < N; ++k) {
    const T* sk = a.stash + (b * n + k) * L::SW;
    lanes([&](int l) {
      load_stage(l, k, 3);
      for (int e = l; e < NX * NX; e += 32) P[e] = sk[L::SP + e];
      for (int e = l; e < NX; e += 32) p[e] = sk[L::Sp + e];
      for (int e = l; e < NU * NX; e += 32) K[e] = sk[L::SK + e];
      for (int e = l; e < NU; e += 32) kf[e] = sk[L::Sk + e];
    });
    wsync();
    lanes([&](int i) {
      if (i >= NU) return;
      T v = kf[i];
      for (int m = 0; m < NX; ++m) v += K[i * NX + m] * dx[m];
      du[i] = v;
      a.dU[(b * n + k) * NU + i] = v;
    });
    wsync();
    lanes([&](int i) {
      if (i >= NX) return;
      T v = c[i];
      for (int m = 0; m < NX; ++m) v += A[i * NX + m] * dx[m];
      for (int m = 0; m < NU; ++m) v += Bm[i * NU + m] * du[m];
      dxn[i] = v;
    });
    wsync();
    lanes([&](int i) {
      if (i >= NX) return;
      T v = p[i];
      for (int m = 0; m < NX; ++m) v += P[i * NX + m] * dxn[m];
      a.lam[(b * n + k) * NX + i] = v;
      a.dX[(b * (n + 1) + k + 1) * NX + i] = dxn[i];
      dx[i] = dxn[i];
    });
    wsync();
  }
}

template <typename T>
WPtrs<T> wptrs(const void* A, const void* B, const void* Q, const void* S,
               const void* R, const void* q, const void* r, const void* c,
               const void* P_term, const void* p_term, const void* dx0, void* dX,
               void* dU, void* lam, void* K, void* kff, void* cost_red,
               void* stash) {
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
  return a;
}

// (warps per block, dynamic shared memory bytes, stash words per stage)
template <typename T, int NX, int NU, int W>
int wide_layout(int* out) {
  out[0] = W;
  out[1] = static_cast<int>(sizeof(T) * W * WLay<NX, NU>::E);
  out[2] = WLay<NX, NU>::SW;
  return 0;
}

#ifdef __CUDACC__
template <typename T, int NX, int NU, int W>
__global__ void __launch_bounds__(32 * W)
riccati_lq_wide_kernel(WPtrs<T> a, int Bt, int N, T reg) {
  extern __shared__ __align__(16) unsigned char rlw_smem[];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const long long b = static_cast<long long>(blockIdx.x) * W + warp;
  if (b >= Bt) return;  // whole warps only: no block-wide barrier follows
  T* w = reinterpret_cast<T*>(rlw_smem) + static_cast<size_t>(warp) * WLay<NX, NU>::E;
  lq_scenario<T, NX, NU>(a, w, static_cast<size_t>(b), N, reg);
}

constexpr int RLW_MAX_DEVICES = 64;

// dynamic shared memory above 48 KB, set once per device and instance (in
// an anonymous namespace, so that its static is this library's own and not
// one STB_GNU_UNIQUE symbol shared with another library of the same name)
namespace {
template <typename T, int NX, int NU, int W>
cudaError_t set_wide_attributes() {
  static bool done[RLW_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < RLW_MAX_DEVICES;
  if (known && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(riccati_lq_wide_kernel<T, NX, NU, W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(T) * W * WLay<NX, NU>::E));
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}
}  // namespace

template <typename T, int NX, int NU, int W>
int wide_launch(const WPtrs<T>& a, int Bt, int N, double reg, void* stream) {
  static_assert(NX >= 1 && NX <= 32 && NU >= 1 && NU <= 32 && W >= 1, "sizes");
  if (Bt <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_wide_attributes<T, NX, NU, W>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = sizeof(T) * W * WLay<NX, NU>::E;
  riccati_lq_wide_kernel<T, NX, NU, W>
      <<<(Bt + W - 1) / W, 32 * W, bytes, static_cast<cudaStream_t>(stream)>>>(
          a, Bt, N, static_cast<T>(reg));
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename T, int NX, int NU, int W>
int wide_run_host(const WPtrs<T>& a, int Bt, int N, double reg) {
  if (Bt <= 0 || N <= 0) return 1;
  std::vector<T> smem(static_cast<size_t>(W) * WLay<NX, NU>::E);
  for (long long blk = 0; blk * W < Bt; ++blk)
    for (int warp = 0; warp < W; ++warp) {
      const long long b = blk * W + warp;
      if (b < Bt)
        lq_scenario<T, NX, NU>(a, smem.data() + static_cast<size_t>(warp) * WLay<NX, NU>::E,
                               static_cast<size_t>(b), N, static_cast<T>(reg));
    }
  return 0;
}
#endif

}  // namespace rlw

// The C entry points of one (NX, NU) instantiation (bound with ctypes), with
// the warps per block of each dtype given by the generated text as
// RICCATI_LQ_WIDE_WARPS_F32 and RICCATI_LQ_WIDE_WARPS_F64. On the card
// riccati_lq_wide_f32 / _f64 enqueue the kernel on `stream` and return its
// cudaError_t; on the host riccati_lq_wide_host_f32 / _f64 run the same warp
// schedule in loops. riccati_lq_wide_layout_f32 / _f64 write (warps, dynamic
// shared memory bytes, stash words per stage) in both builds. The arguments
// are those of riccati_lq.cuh's entry points.
#define RLW_ARGS                                                              \
  const void *A, const void *B, const void *Q, const void *S, const void *R,  \
      const void *q, const void *r, const void *c, const void *P_term,        \
      const void *p_term, const void *dx0, void *dX, void *dU, void *lam,     \
      void *K, void *kff, void *cost_red, void *stash, int Bt, int N,         \
      double reg
#define RLW_PTRS(T)                                                           \
  rlw::wptrs<T>(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, dX, dU, lam, K,  \
                kff, cost_red, stash)
#define RLW_LAYOUTS(NX, NU)                                                   \
  extern "C" int riccati_lq_wide_layout_f32(int* out) {                       \
    return rlw::wide_layout<float, NX, NU, RICCATI_LQ_WIDE_WARPS_F32>(out);   \
  }                                                                           \
  extern "C" int riccati_lq_wide_layout_f64(int* out) {                       \
    return rlw::wide_layout<double, NX, NU, RICCATI_LQ_WIDE_WARPS_F64>(out);  \
  }
#ifdef __CUDACC__
#define RICCATI_LQ_WIDE_EXPORTS(NX, NU)                                       \
  RLW_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_wide_f32(RLW_ARGS, void* stream) {                \
    return rlw::wide_launch<float, NX, NU, RICCATI_LQ_WIDE_WARPS_F32>(        \
        RLW_PTRS(float), Bt, N, reg, stream);                                 \
  }                                                                           \
  extern "C" int riccati_lq_wide_f64(RLW_ARGS, void* stream) {                \
    return rlw::wide_launch<double, NX, NU, RICCATI_LQ_WIDE_WARPS_F64>(       \
        RLW_PTRS(double), Bt, N, reg, stream);                                \
  }
#else
#define RICCATI_LQ_WIDE_EXPORTS(NX, NU)                                       \
  RLW_LAYOUTS(NX, NU)                                                         \
  extern "C" int riccati_lq_wide_host_f32(RLW_ARGS) {                         \
    return rlw::wide_run_host<float, NX, NU, RICCATI_LQ_WIDE_WARPS_F32>(      \
        RLW_PTRS(float), Bt, N, reg);                                         \
  }                                                                           \
  extern "C" int riccati_lq_wide_host_f64(RLW_ARGS) {                         \
    return rlw::wide_run_host<double, NX, NU, RICCATI_LQ_WIDE_WARPS_F64>(     \
        RLW_PTRS(double), Bt, N, reg);                                        \
  }
#endif
