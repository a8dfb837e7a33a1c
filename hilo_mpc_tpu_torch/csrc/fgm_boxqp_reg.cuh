// Batched box-constrained QPs by the projected fast gradient method (FGM),
// one scenario per thread with its whole iterate in registers, for small n:
// B problems  min_u ½ uᵀHu + (G x0_b)ᵀu  s.t. lb <= u <= ub,  H and G shared.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:
// fgm_boxqp_batch (pallas_call at line 98) for n <= FGM_REG_MAX_N; the
// tensor-core design of csrc/fgm_boxqp_tc.cuh takes the n above, up to 128,
// and the cluster kernel of csrc/fgm_boxqp.cu the n above 128. Same
// iteration as the JAX kernel body
// (lines 78-95):
//   g  = G x0
//   repeat iters times:
//     u⁺ = clip(y − (1/L)(H y + g), lb, ub)
//     y⁺ = u⁺ + β (u⁺ − u)
// from u = y = u0 (or zero), float32, 1/L and β from the host. Non-finite
// bounds become ∓FGM_INF (1e30) as the kernel loads them, as the JAX
// kernel pads them (pallas_kernels.py:67-68).
//
// Bound. Per scenario and iteration 2n² FLOPs for H y and ~8n for the
// update, on one H shared by all scenarios: at the flagship (B=131072,
// n=20, nx=2, 100 iterations) 1.259e10 FLOPs against ~11 MB of compulsory
// traffic, so the bound is float32 issue: one FFMA per lane and clock.
//
// Design. FGM's scenarios are independent and H is the same for all of
// them. So a thread owns one scenario and keeps its u, y, g and the next y
// in register arrays: the row and column loops are fully unrolled over the
// compile-time N, so every index is a constant and no array goes to local
// memory; the iteration loop is not unrolled. y never touches shared
// memory, and the block never waits at a barrier inside the loop. H lives
// in a __constant__ array, and each H[i][j] is the constant-bank operand of
// its FFMA: every lane reads the same address, and the product issues no
// load instruction at all. The wrapper holds H on the card, so it is copied
// there on the stream before each launch (device to device; passing H by
// value in the parameters would need a copy back to the host and a wait).
// The array is one per library and device, so a launch waits for the
// previous launch of the same library (an event) before it overwrites it.
// What caps it is registers: ~4n per thread plus the product's
// temporaries. On an H100 ptxas took at most 168 up to n = 24 (6 blocks of
// 64 threads per SM); at 25, 27 and 28 it took 211-223 (4 blocks per SM),
// and at n = 32 (4 KB of H, the same 4 blocks) it took 4.8x its time at
// n = 28. Against the tensor-core design (csrc/fgm_boxqp_tc.cuh, whose time
// steps with n padded to 8) it is ahead up to n = 15 and at 17-19; from
// 20 on, and at 16 by a few percent, the tensor cores are faster:
// FGM_REG_MAX_N = 19 (PERF.md). A variant with H in shared memory, read as
// broadcast float4s, was 35% slower at n = 20; it is gone. The bounds,
// mapped to finite values, sit in shared memory as one float2 per row,
// read the same uniform way once per row and iteration. Each element sums
// acc from 0 over j = 0..n-1 by fmaf, then + g, then the clip and the
// momentum as fmaf.
//
// Blocks of FGMR_TPB threads; the grid covers B. The per-scenario code is
// __host__ __device__: compiled with the host C++ compiler
// (ops/_build.py:host_library_path) fgm_reg_host_f32 runs it in a loop over
// scenarios, H read from an array, so the CPU tests reach the arithmetic,
// the bounds and u0. The launcher takes PyTorch's current stream, allocates
// nothing and never synchronizes. Limits: 1 <= N <= FGM_REG_BUILD_MAX_N,
// nx >= 1, B >= 1.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <mutex>
#define FGMR_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define FGMR_HD inline
struct float2 { float x, y; };
using std::fmaf;
using std::fmaxf;
using std::fminf;
using std::isfinite;
#endif

// the largest n the router sends to this design (ops/cuda_kernels.py
// mirrors it): above it the tensor-core design measured faster on an H100;
// and the largest n it builds for (ptxas needs minutes beyond it: 577 s
// for n = 96 on the H100 host, with 50-140 KB of spills per thread)
#define FGM_REG_MAX_N 19
#define FGM_REG_BUILD_MAX_N 64
#define FGM_REG_INF 1e30f
// threads per block
#define FGMR_TPB 64

namespace fgmr {
// internal linkage throughout: each generated library keeps its own
// function-local statics (no STB_GNU_UNIQUE symbol shared across libraries)
namespace {

FGMR_HD float2 finite_bounds(float lo, float hi) {
  float2 b;
  b.x = isfinite(lo) ? lo : -FGM_REG_INF;
  b.y = isfinite(hi) ? hi : FGM_REG_INF;
  return b;
}

// One scenario's iterations. hm.h(i, j) = H[i][j], hm.bounds(i) =
// (lb_i, ub_i), finite. u holds u0 on entry and the result on return;
// g = G x0.
template <int N, class HM>
FGMR_HD void solve(const HM hm, float (&u)[N], const float (&g)[N], int iters,
                   float inv_L, float beta) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = u[i];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float yn[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc = fmaf(hm.h(i, j), y[j], acc);
      const float2 b = hm.bounds(i);
      const float grad = acc + g[i];
      const float un = fminf(fmaxf(fmaf(-inv_L, grad, y[i]), b.x), b.y);
      yn[i] = fmaf(beta, un - u[i], un);
      u[i] = un;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = yn[i];
  }
}

// g = G x0 and u = u0 (or zero) of scenario b
template <int N>
FGMR_HD void start(const float* G, const float* x0, const float* u0, long long b,
                   int nx, float (&g)[N], float (&u)[N], bool live) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float gv = 0.0f, uv = 0.0f;
    if (live) {
      for (int m = 0; m < nx; ++m)
        gv = fmaf(G[static_cast<size_t>(i) * nx + m],
                  x0[static_cast<size_t>(b) * nx + m], gv);
      if (u0 != nullptr) uv = u0[static_cast<size_t>(b) * N + i];
    }
    g[i] = gv;
    u[i] = uv;
  }
}

#ifdef __CUDACC__
// H, row-major (the generated text defines FGM_REG_N before it includes
// this header)
__constant__ float c_H[FGM_REG_N * FGM_REG_N];

template <int N>
struct ConstH {
  static_assert(N == FGM_REG_N, "one N per library");
  const float2* b;
  __device__ __forceinline__ float h(int i, int j) const { return c_H[i * N + j]; }
  __device__ __forceinline__ float2 bounds(int i) const { return b[i]; }
};

template <int N>
__global__ void __launch_bounds__(FGMR_TPB)
fgm_reg_kernel(const float* __restrict__ G, const float* __restrict__ x0,
               const float* __restrict__ lb, const float* __restrict__ ub,
               const float* __restrict__ u0, float* __restrict__ out, int B, int nx,
               int iters, float inv_L, float beta) {
  __shared__ float2 bs[N];
  for (int i = threadIdx.x; i < N; i += FGMR_TPB) bs[i] = finite_bounds(lb[i], ub[i]);
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * FGMR_TPB + threadIdx.x;
  float u[N], g[N];
  start<N>(G, x0, u0, b, nx, g, u, b < B);
  solve<N>(ConstH<N>{bs}, u, g, iters, inv_L, beta);
  if (b < B)
#pragma unroll
    for (int i = 0; i < N; ++i) out[static_cast<size_t>(b) * N + i] = u[i];
}

constexpr int MAX_DEVICES = 64;

// one event per device: the last launch, which the next one waits for
// before it overwrites c_H
struct ConstOrder {
  std::mutex lock;
  cudaEvent_t done[MAX_DEVICES] = {};
};

ConstOrder& const_order() {
  static ConstOrder order;
  return order;
}

template <int N>
cudaError_t launch(const float* H, const float* G, const float* x0, const float* lb,
                   const float* ub, const float* u0, float* out, int B, int nx,
                   int iters, float inv_L, float beta, cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  ConstOrder& order = const_order();
  std::lock_guard<std::mutex> guard(order.lock);
  cudaEvent_t& done = order.done[dev];
  e = done == nullptr ? cudaEventCreateWithFlags(&done, cudaEventDisableTiming)
                      : cudaStreamWaitEvent(st, done, 0);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyToSymbolAsync(c_H, H, sizeof(float) * N * N, 0,
                              cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(B) + FGMR_TPB - 1) / FGMR_TPB);
  fgm_reg_kernel<N><<<grid, FGMR_TPB, 0, st>>>(G, x0, lb, ub, u0, out, B, nx, iters,
                                               inv_L, beta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaEventRecord(done, st);
}

// resident blocks per SM on the current device
template <int N>
int blocks_per_sm() {
  int per_sm = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fgm_reg_kernel<N>,
                                                       FGMR_TPB, 0) == cudaSuccess
      ? per_sm : -1;
}
#else
// H read from an array, as the host build holds it
struct ArrayH {
  const float* H;
  const float2* b;
  int n;
  float h(int i, int j) const { return H[i * n + j]; }
  float2 bounds(int i) const { return b[i]; }
};

template <int N>
int run_host(const float* H, const float* G, const float* x0, const float* lb,
             const float* ub, const float* u0, float* out, int B, int nx,
             int iters, float inv_L, float beta) {
  if (B <= 0 || nx <= 0 || iters < 0) return 1;
  float2 bs[N];
  for (int i = 0; i < N; ++i) bs[i] = finite_bounds(lb[i], ub[i]);
  const ArrayH hm{H, bs, N};
  for (long long b = 0; b < B; ++b) {
    float u[N], g[N];
    start<N>(G, x0, u0, b, nx, g, u, true);
    solve<N>(hm, u, g, iters, inv_L, beta);
    for (int i = 0; i < N; ++i) out[static_cast<size_t>(b) * N + i] = u[i];
  }
  return 0;
}
#endif

}  // namespace
}  // namespace fgmr

// The C entry points of one N (bound with ctypes); the generated text
// defines FGM_REG_N and includes this header. On the card fgm_reg_f32
// enqueues the copy of H and the kernel on `stream` and returns the
// cudaError_t (0: enqueued); on the host fgm_reg_host_f32 runs the
// per-scenario code in a loop (0: done). fgm_reg_layout_f32 writes
// (threads per block, scenarios per block, resident blocks per SM (0 on
// the host, -1 if the query failed), FGM_REG_MAX_N).
#define FGMR_ARGS                                                             \
  const void *H, const void *G, const void *x0, const void *lb,               \
      const void *ub, const void *u0, void *out, int B, int nx, int iters,    \
      double inv_L, double beta
#define FGMR_PTRS                                                             \
  static_cast<const float*>(H), static_cast<const float*>(G),                 \
      static_cast<const float*>(x0), static_cast<const float*>(lb),           \
      static_cast<const float*>(ub), static_cast<const float*>(u0),           \
      static_cast<float*>(out), B, nx, iters, static_cast<float>(inv_L),      \
      static_cast<float>(beta)

static_assert(FGM_REG_N >= 1 && FGM_REG_N <= FGM_REG_BUILD_MAX_N,
              "FGM_REG_N: 1..FGM_REG_BUILD_MAX_N");

#ifdef __CUDACC__
extern "C" int fgm_reg_f32(FGMR_ARGS, void* stream) {
  if (B <= 0 || nx <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      fgmr::launch<FGM_REG_N>(FGMR_PTRS, static_cast<cudaStream_t>(stream)));
}
#else
extern "C" int fgm_reg_host_f32(FGMR_ARGS) {
  return fgmr::run_host<FGM_REG_N>(FGMR_PTRS);
}
#endif

extern "C" int fgm_reg_layout_f32(int* out) {
  out[0] = FGMR_TPB;
  out[1] = FGMR_TPB;
#ifdef __CUDACC__
  out[2] = fgmr::blocks_per_sm<FGM_REG_N>();
#else
  out[2] = 0;
#endif
  out[3] = FGM_REG_MAX_N;
  return 0;
}
