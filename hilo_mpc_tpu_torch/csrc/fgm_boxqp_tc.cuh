// Batched box-constrained QPs by the projected fast gradient method (FGM) on
// Hopper's tensor cores, for FGM_REG_MAX_N < n <= 128:
// B problems  min_u ½ uᵀHu + (G x0_b)ᵀu  s.t. lb <= u <= ub,  H and G shared.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:
// fgm_boxqp_batch (pallas_call at line 98) in that range; the register
// design (csrc/fgm_boxqp_reg.cuh) takes the n below, the cluster kernel of
// csrc/fgm_boxqp.cu the n above. Same iteration as the JAX kernel body
// (lines 78-95), which puts the product on the TPU's matrix unit too:
//   g  = G x0
//   repeat iters times:
//     u⁺ = clip(y − (1/L)(H y + g), lb, ub)
//     y⁺ = u⁺ + β (u⁺ − u)
// from u = y = u0 (or zero), float32, 1/L and β from the host. Non-finite
// bounds become ∓FGM_TC_INF (1e30) as the kernel loads them, as the JAX
// kernel pads them (pallas_kernels.py:67-68).
//
// Bound. An iteration of a tile of scenarios is a (B × n)·(n × n) product
// with H shared by the whole batch, plus ~8n operations per scenario for the
// update. On float32 FFMAs (67 TFLOP/s) the product alone bounds the solve
// (n = 64, B = 131072, 100 iterations: 1.70 ms); on the tensor cores' TF32
// path (495 TFLOP/s) three passes of it take 0.65 ms. A single TF32 pass
// keeps ~3 decimal digits, too few for the 1e-4 the kernel is held to after
// 200 iterations, so every product is split (3xTF32):
//   a = a_hi + a_lo,  a_hi = rna_tf32(a),  a_lo = rna_tf32(a − a_hi),
//   a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi   (a_lo·b_lo dropped),
// summed in float32: each operand to 2^-22, for three passes.
//
// Layout. n is padded to NPAD = 8·NT (one build per NPAD). It computes
// (H y)ᵀ = yᵀ Hᵀ, as the plain version does (y @ H.T), so no symmetry of H
// is assumed: M is scenarios, N is rows of u, K is n. A warp owns 16
// scenarios for the whole solve. In the accumulator of an m16n8 tile (rows
// 8t..8t+7 of u), thread (gr, q) = (lane / 4, lane % 4) holds scenarios
// {gr, gr + 8} × rows {8t + 2q, 8t + 2q + 1}; the A fragment of a k8 block
// wants columns {q, q + 4}. The k index inside each block of 8 is permuted:
// k-position p holds variable σ(p) = 2p (p < 4), 2(p − 4) + 1 (p >= 4).
// Then the clipped, momentum-updated accumulator of row tile t IS the A
// fragment of k-block t (a0, a1, a2, a3 = c0, c2, c1, c3), with no shuffle
// and no shared-memory round trip. H takes the same permutation on its
// columns.
//
// Instruction. wgmma.mma_async.m64n<NPAD>k8.f32.tf32.tf32, A from registers
// (RS). A warpgroup (4 warps, 64 scenarios) computes all NPAD rows of u per
// k-block in one instruction, its B tile (NPAD × 8 of H) read by the tensor
// cores straight from shared memory, once for 64 scenarios; its register
// fragments for A (per warp 16 × 8) and D (per warp 16 × NPAD, an m16n8
// tile per 8 columns) are those of mma.sync.m16n8k8, so the permutation
// above holds. mma.sync.m16n8k8 itself would bring every B fragment of H
// into registers with a 16-byte load per lane for each warp of 16
// scenarios, 512 bytes of shared memory for three products, so
// shared-memory bandwidth would pace it as it paced the SIMT kernel; wgmma
// reads each B tile once per warpgroup, straight into the tensor cores
// (PERF.md §6). Per k-block the
// warpgroup splits its A fragment, fences, issues lo·hi, hi·lo, hi·hi and
// commits them as one group; the A registers of k-block tk are rewritten
// at k-block tk + 2, after wgmma.wait_group 1 has seen group tk complete;
// one wait_group 0 before the update.
//
// Shared memory. H is loaded once per block and split: per k-block two
// B tiles (hi, lo) of NPAD rows × 8 k-positions, K-major without swizzle
// (CuTe's Layout_K_INTER canonical form: 8 × 16-byte core matrices, the
// two k-halves LBO = 128 bytes apart, row groups SBO = 256 bytes apart);
// 8·NPAD² bytes (32 KB at n = 64, 128 KB at 128). A fence.proxy.async
// makes the threads' stores visible to the tensor cores. Padded rows and
// columns of H are 0 and padded bounds 0, so the padding stays exactly 0
// (it is never stored). Per warp, u and g of its scenarios live in shared
// memory, one float4 per lane and row tile, which only that lane touches:
// registers hold y and the accumulator (NPAD/2 floats each). The iteration
// loop has no block barrier; the block waits once, after the load of H.
//
// Blocks of WARPS warps (whole warpgroups, as many as 227 KB of shared
// memory hold, at most 8); the grid covers B; scenarios past B compute on
// zeros and are never stored, nor are rows past n. The launcher takes
// PyTorch's current stream, allocates nothing and never synchronizes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FGM_TC_NPAD
#error "define FGM_TC_NPAD (n padded to a multiple of 8) before including fgm_boxqp_tc.cuh"
#endif

// what a non-finite bound becomes; the largest NPAD; shared memory a block
// may take on Hopper; the most warps per block (ops/cuda_kernels.py mirrors
// them: FGM_INF, FGM_NARROW_MAX_N, RICCATI_SMEM_MAX, FGM_TC_MAX_WARPS)
#define FGM_TC_INF 1e30f
#define FGM_TC_MAX_NPAD 128
#define FGM_TC_SMEM_MAX 232448
#define FGM_TC_MAX_WARPS 8

namespace fgmtc {
// internal linkage: each generated library keeps its own symbols
namespace {

constexpr int NPAD = FGM_TC_NPAD;
constexpr int NT = NPAD / 8;      // row tiles = k-blocks
static_assert(NPAD % 8 == 0 && NPAD >= 8 && NPAD <= FGM_TC_MAX_NPAD,
              "FGM_TC_NPAD: a multiple of 8 in 8..128");

constexpr int H_BYTES = NPAD * NPAD * 8;        // hi and lo
constexpr int BOUND_BYTES = NPAD * 8;           // lb and ub
constexpr int WARP_BYTES = NPAD * 128;          // u and g of 16 scenarios
constexpr int FIT_WARPS = (FGM_TC_SMEM_MAX - H_BYTES - BOUND_BYTES) / WARP_BYTES;
constexpr int MAX_WARPS = FIT_WARPS < FGM_TC_MAX_WARPS ? FIT_WARPS : FGM_TC_MAX_WARPS;
constexpr int WARPS = MAX_WARPS / 4 * 4;      // whole warpgroups
static_assert(WARPS >= 4, "no warpgroup fits beside H");
constexpr int SMEM_BYTES = H_BYTES + BOUND_BYTES + WARPS * WARP_BYTES;
constexpr int SCEN_PER_BLOCK = WARPS * 16;
constexpr int TILE_FLOATS = NPAD * 8;           // one B tile of wgmma

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float lower_bound(float v) { return isfinite(v) ? v : -FGM_TC_INF; }
__device__ __forceinline__ float upper_bound(float v) { return isfinite(v) ? v : FGM_TC_INF; }

// the smem descriptor of a B tile: start address, LBO 128, SBO 256, no swizzle
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins an accumulator register around the asynchronous products
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__global__ void __launch_bounds__(WARPS * 32)
fgm_tc_kernel(const float* __restrict__ H, const float* __restrict__ G,
              const float* __restrict__ x0, const float* __restrict__ lb,
              const float* __restrict__ ub, const float* __restrict__ u0,
              float* __restrict__ out, int B, int n, int nx, int iters, float inv_L,
              float beta) {
  extern __shared__ __align__(128) float4 smem4[];
  float4* Hs = smem4;
  float* lbs = reinterpret_cast<float*>(Hs + NPAD * NPAD / 2);
  float* ubs = lbs + NPAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, q = lane & 3;
  float4* us = reinterpret_cast<float4*>(ubs + NPAD) + warp * (2 * NT * 32);
  float4* gs = us + NT * 32;                              // [t][lane], both

  // element (i, j) of H: B tile 2·(j/8) (hi) and 2·(j/8) + 1 (lo), row i,
  // k-position σ⁻¹(j % 8)
  float* Hf = reinterpret_cast<float*>(Hs);
  for (int idx = threadIdx.x; idx < NPAD * NPAD; idx += WARPS * 32) {
    const int i = idx / NPAD, j = idx - i * NPAD;
    const float v = (i < n && j < n) ? H[static_cast<size_t>(i) * n + j] : 0.0f;
    const uint32_t h = tf32(v), l = tf32(v - __uint_as_float(h));
    const int jj = j & 7, kpos = (jj >> 1) + 4 * (jj & 1);
    const int off = (i & 7) * 4 + (i >> 3) * 64 + (kpos >> 2) * 32 + (kpos & 3);
    Hf[(2 * (j >> 3)) * TILE_FLOATS + off] = __uint_as_float(h);
    Hf[(2 * (j >> 3) + 1) * TILE_FLOATS + off] = __uint_as_float(l);
  }
  for (int i = threadIdx.x; i < NPAD; i += WARPS * 32) {
    lbs[i] = i < n ? lower_bound(lb[i]) : 0.0f;
    ubs[i] = i < n ? upper_bound(ub[i]) : 0.0f;
  }

  // g = G x0 and u = y = u0 (or zero); element c of row tile t is scenario
  // s0 + gr + 8(c / 2), row 8t + 2q + c % 2
  const long long s0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * 16;
  float y[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float gv[4], uv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long s = s0 + gr + 8 * (c >> 1);
      const int i = 8 * t + 2 * q + (c & 1);
      gv[c] = 0.0f;
      uv[c] = 0.0f;
      if (s < B && i < n) {
        for (int k = 0; k < nx; ++k)
          gv[c] = fmaf(G[static_cast<size_t>(i) * nx + k], x0[static_cast<size_t>(s) * nx + k],
                       gv[c]);
        if (u0 != nullptr) uv[c] = u0[static_cast<size_t>(s) * n + i];
      }
      y[t][c] = uv[c];
    }
    gs[t * 32 + lane] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    us[t * 32 + lane] = make_float4(uv[0], uv[1], uv[2], uv[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();   // H and the bounds; us and gs are each lane's own

  for (int it = 0; it < iters; ++it) {
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 gv = gs[t * 32 + lane];
      acc[t][0] = gv.x;
      acc[t][1] = gv.y;
      acc[t][2] = gv.z;
      acc[t][3] = gv.w;
    }

#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) keep(acc[t][c]);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int tk = 0; tk < NT; ++tk) {
      if (tk >= 2) wg_wait<1>();      // group tk − 2 has read ahi/alo[tk % 2]
      // the accumulator layout of row tile tk as the A fragment of k-block tk
      const float a[4] = {y[tk][0], y[tk][2], y[tk][1], y[tk][3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ahi[tk & 1][r] = tf32(a[r]);
        alo[tk & 1][r] = tf32(a[r] - __uint_as_float(ahi[tk & 1][r]));
      }
      wg_fence();
      const uint64_t dh = b_desc(Hf + (2 * tk) * TILE_FLOATS);
      const uint64_t dl = b_desc(Hf + (2 * tk + 1) * TILE_FLOATS);
      fgm_tc_wgmma(acc, alo[tk & 1], dh);
      fgm_tc_wgmma(acc, ahi[tk & 1], dl);
      fgm_tc_wgmma(acc, ahi[tk & 1], dh);
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) keep(acc[t][c]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 lo = *reinterpret_cast<const float2*>(lbs + 8 * t + 2 * q);
      const float2 hi = *reinterpret_cast<const float2*>(ubs + 8 * t + 2 * q);
      const float4 uv = us[t * 32 + lane];
      float uo[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float un = fminf(fmaxf(fmaf(-inv_L, acc[t][c], y[t][c]), (c & 1) ? lo.y : lo.x),
                               (c & 1) ? hi.y : hi.x);
        y[t][c] = fmaf(beta, un - uo[c], un);
        uo[c] = un;
      }
      us[t * 32 + lane] = make_float4(uo[0], uo[1], uo[2], uo[3]);
    }
  }

#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const float4 uv = us[t * 32 + lane];
    const float uo[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long s = s0 + gr + 8 * (c >> 1);
      const int i = 8 * t + 2 * q + (c & 1);
      if (s < B && i < n) out[static_cast<size_t>(s) * n + i] = uo[c];
    }
  }
}

}  // namespace
}  // namespace fgmtc

// The C entry points of one NPAD (bound with ctypes); the generated text
// defines FGM_TC_NPAD and fgm_tc_wgmma (ops/cuda_kernels.py:
// fgm_boxqp_tc_source) and includes this header. fgm_tc_f32 takes
// NPAD − 8 < n <= NPAD, enqueues the kernel on `stream` and returns the
// cudaError_t (0: enqueued); u0 may be null (zeros). fgm_tc_layout_f32
// writes (warps per block, scenarios per block, dynamic shared memory per
// block, resident blocks per SM (-1 if the query failed)).
extern "C" int fgm_tc_f32(const void* H, const void* G, const void* x0, const void* lb,
                          const void* ub, const void* u0, void* out, int B, int n, int nx,
                          int iters, double inv_L, double beta, void* stream) {
  using namespace fgmtc;
  if (B <= 0 || n <= NPAD - 8 || n > NPAD || nx <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      fgm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(B) + SCEN_PER_BLOCK - 1) / SCEN_PER_BLOCK);
  fgm_tc_kernel<<<grid, WARPS * 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(G),
      static_cast<const float*>(x0), static_cast<const float*>(lb),
      static_cast<const float*>(ub), static_cast<const float*>(u0),
      static_cast<float*>(out), B, n, nx, iters, static_cast<float>(inv_L),
      static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fgm_tc_layout_f32(int* out) {
  using namespace fgmtc;
  out[0] = WARPS;
  out[1] = SCEN_PER_BLOCK;
  out[2] = SMEM_BYTES;
  int per_sm = 0;
  if (cudaFuncSetAttribute(fgm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fgm_tc_kernel, WARPS * 32,
                                                    SMEM_BYTES) != cudaSuccess)
    per_sm = -1;
  out[3] = per_sm;
  return 0;
}
