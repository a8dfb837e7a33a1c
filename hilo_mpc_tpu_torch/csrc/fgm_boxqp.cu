// Batched box-constrained QPs by the projected fast gradient method (FGM):
// B problems  min_u ½ uᵀHu + (G x0_b)ᵀu  s.t. lb <= u <= ub,  H and G shared.
//
// Replaces the Pallas kernel hilo_mpc_tpu/ops/pallas_kernels.py:
// fgm_boxqp_batch (pallas_call at line 98). Same iteration as its kernel body
// (lines 78-95):
//   g  = x0 Gᵀ
//   repeat iters times:
//     u⁺ = clip(y − (1/L)(H y + g), lb, ub)
//     y⁺ = u⁺ + β (u⁺ − u)
// from u = y = u0 (or zero). 1/L and β are computed on the host from the
// spectrum of H and passed in, as the TPU kernel bakes them in.
//
// Design. The TPU kernel pads n and nx to 128 lanes and B to its tile and
// keeps H resident in VMEM while tiles of scenarios go through the MXU. Here
// one thread block owns a tile of TILE_B = 64 scenarios and keeps Hᵀ in shared
// memory for all iterations. Thread (tx, ty) of a (32, ceil(n/4)) block owns
// ROWS = 4 consecutive rows (4ty .. 4ty+3) of SCEN = 2 scenarios (2tx, 2tx+1):
// its u and g stay in registers for the whole solve. The tile's y is kept in
// shared memory, scenario-minor and double-buffered: iteration k reads buffer
// k%2 and writes k%2^1, so one barrier per iteration suffices. In the product
// H y, a thread reads per column j one float4 of Hᵀ (its four rows; every lane
// of a warp shares ty, so it is a broadcast) and one float2 of y (its two
// scenarios; neighbouring lanes, no bank conflict), then does 8 FMAs. Rows
// past n are zero in the shared Hᵀ and never stored; scenarios past B compute
// on zeros and are never stored: no padding reaches device memory.
//
// Bound. Per scenario and iteration the kernel does 2n² FLOPs for H y plus
// ~8n for the update, on one H and a few vectors per tile: at the flagship
// shape (B=131072, n=20, nx=2, 100 iterations) ~1.2e10 FLOPs against ~11 MB
// of compulsory traffic, so it is bound by fp32 operations, not bytes. The
// design's own limit is shared-memory bandwidth: 3 shared wavefronts per
// 8 FMA instructions of a warp. Tensor cores (with the TF32 precision
// question) and a larger register tile are later work.
//
// Limits: 1 <= n <= FGM_MAX_N (= 128, block (32, 32) = 1024 threads; Hᵀ and
// the two y buffers take 132 KB of dynamic shared memory at n=128), nx >= 1.
// The launcher takes PyTorch's current stream, allocates nothing and never
// synchronizes.
#include <cuda_runtime.h>
#include <cstddef>

#define FGM_MAX_N 128

namespace {

constexpr int TILE_B = 64;   // scenarios per block
constexpr int SCEN = 2;      // scenarios per thread
constexpr int ROWS = 4;      // rows of u per thread

__global__ void __launch_bounds__(1024)
fgm_boxqp_kernel(const float* __restrict__ H, const float* __restrict__ G,
                 const float* __restrict__ x0, const float* __restrict__ lb,
                 const float* __restrict__ ub, const float* __restrict__ u0,
                 float* __restrict__ out, int B, int n, int nx, int iters,
                 float inv_L, float beta) {
  extern __shared__ __align__(16) float smem[];
  const int ldh = ROWS * blockDim.y;            // padded row count of Hᵀ
  float* Ht = smem;                             // (n, ldh): Ht[j*ldh + i] = H[i][j]
  float* ys = Ht + static_cast<size_t>(n) * ldh;  // 2 x (n, TILE_B)
  float* lbs = ys + 2 * n * TILE_B;
  float* ubs = lbs + n;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int idx = tid; idx < n * ldh; idx += nthreads) {
    const int j = idx / ldh, i = idx - j * ldh;
    Ht[idx] = i < n ? H[static_cast<size_t>(i) * n + j] : 0.0f;
  }
  for (int i = tid; i < n; i += nthreads) {
    lbs[i] = lb[i];
    ubs[i] = ub[i];
  }

  const int row0 = ROWS * threadIdx.y;
  const int s0 = SCEN * threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * TILE_B + s0;
  float u[ROWS][SCEN], g[ROWS][SCEN];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = row0 + k;
#pragma unroll
    for (int c = 0; c < SCEN; ++c) {
      const long long b = b0 + c;
      float gv = 0.0f, uv = 0.0f;
      if (i < n && b < B) {
        for (int m = 0; m < nx; ++m)
          gv = fmaf(G[static_cast<size_t>(i) * nx + m],
                    x0[static_cast<size_t>(b) * nx + m], gv);
        if (u0 != nullptr) uv = u0[static_cast<size_t>(b) * n + i];
      }
      g[k][c] = gv;
      u[k][c] = uv;
      if (i < n) ys[i * TILE_B + s0 + c] = uv;
    }
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float* cur = ys + (it & 1) * n * TILE_B;
    float* nxt = ys + ((it & 1) ^ 1) * n * TILE_B;
    float acc[ROWS][SCEN];
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
#pragma unroll
      for (int c = 0; c < SCEN; ++c) acc[k][c] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float4 h = *reinterpret_cast<const float4*>(Ht + j * ldh + row0);
      const float2 y = *reinterpret_cast<const float2*>(cur + j * TILE_B + s0);
      const float hk[ROWS] = {h.x, h.y, h.z, h.w};
      const float yc[SCEN] = {y.x, y.y};
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int c = 0; c < SCEN; ++c) acc[k][c] = fmaf(hk[k], yc[c], acc[k][c]);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = row0 + k;
      if (i < n) {
#pragma unroll
        for (int c = 0; c < SCEN; ++c) {
          const float yv = cur[i * TILE_B + s0 + c];
          const float grad = acc[k][c] + g[k][c];
          const float un = fminf(fmaxf(yv - inv_L * grad, lbs[i]), ubs[i]);
          nxt[i * TILE_B + s0 + c] = un + beta * (un - u[k][c]);
          u[k][c] = un;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = row0 + k;
#pragma unroll
    for (int c = 0; c < SCEN; ++c) {
      const long long b = b0 + c;
      if (i < n && b < B) out[static_cast<size_t>(b) * n + i] = u[k][c];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means the kernel was enqueued on `stream`. u0 may be null (start
// from zero). FGM_MAX_N is mirrored by ops/cuda_kernels.py:FGM_MAX_N.
extern "C" int fgm_boxqp_f32(const void* H, const void* G, const void* x0,
                             const void* lb, const void* ub, const void* u0,
                             void* out, int B, int n, int nx, int iters,
                             double inv_L, double beta, void* stream) {
  if (B <= 0 || n <= 0 || n > FGM_MAX_N || nx <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_threads = (n + ROWS - 1) / ROWS;
  const dim3 block(TILE_B / SCEN, rows_threads);
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(B) + TILE_B - 1) / TILE_B));
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) * ROWS * rows_threads
                                       + 2 * static_cast<size_t>(n) * TILE_B + 2 * n);
  cudaError_t err = cudaFuncSetAttribute(
      fgm_boxqp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fgm_boxqp_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(G),
      static_cast<const float*>(x0), static_cast<const float*>(lb),
      static_cast<const float*>(ub), static_cast<const float*>(u0),
      static_cast<float*>(out), B, n, nx, iters, static_cast<float>(inv_L),
      static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}
