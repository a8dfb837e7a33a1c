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
// Bound. Per scenario and iteration the method does 2n² FLOPs for H y plus
// ~8n for the update, on one H and a few vectors per tile: at the flagship
// shape (B=131072, n=20, nx=2, 100 iterations) ~1.2e10 FLOPs against ~11 MB
// of compulsory traffic, so it is bound by fp32 operations, not bytes; the
// same holds at every n. Tensor cores (with the TF32 question) and a larger
// register tile are later work.
//
// Two designs, chosen by n (the TPU kernel pads n to 128 lanes and keeps H
// resident in VMEM whatever n; Hopper's 227 KB of shared memory per block
// hold Hᵀ only up to n = 128).
//
// n <= 128 (fgm_boxqp_kernel). One thread block owns a tile of TILE_B = 64
// scenarios and keeps Hᵀ in shared memory for all iterations. Thread (tx, ty)
// of a (32, ceil(n/4)) block owns ROWS = 4 consecutive rows (4ty .. 4ty+3) of
// SCEN = 2 scenarios (2tx, 2tx+1): its u and g stay in registers for the
// whole solve. The tile's y is kept in shared memory, scenario-minor and
// double-buffered: iteration k reads buffer k%2 and writes k%2^1, so one
// barrier per iteration suffices. In the product H y, a thread reads per
// column j one float4 of Hᵀ (its four rows; every lane of a warp shares ty, so
// it is a broadcast) and one float2 of y (its two scenarios; neighbouring
// lanes, no bank conflict), then does 8 FMAs. Its own limit is shared-memory
// bandwidth: 3 shared wavefronts per 8 FMA instructions of a warp.
//
// 128 < n <= FGM_MAX_N (fgm_boxqp_wide_kernel). Hᵀ no longer fits, so it is
// staged through shared memory in column blocks of WIDE_JB columns: per
// iteration the block walks the column blocks, all 512 threads copy one block
// of H (row-major rows of WIDE_JB words: coalesced; it stays in the 50 MB L2,
// being shared by every block) into a column-major buffer with an odd row
// stride (no bank conflicts), and every thread adds that block's share of
// H y to its rows. A block owns WIDE_TILE = 32 scenarios (lane = scenario) and
// WIDE_WARPS = 16 warps; warp w owns rows w, w + 16, ... (RB rows per thread,
// RB = 16 up to n = 256 and 32 up to 512, a template parameter so that u and
// the products stay in registers). y (single buffer: a barrier separates the
// last product from the update) and g live in shared memory scenario-minor
// with row stride WIDE_TILE + 1; u0 is loaded and u stored through the y
// buffer, so every global access of the batch coalesces. Its limits: two
// shared loads per FMA for a warp (the Hᵀ word is a broadcast, y one word per
// lane) and 2·ceil(n/WIDE_JB) + 1 barriers per iteration.
//
// Rows past n are never stored; scenarios past B compute on zeros and are
// never stored: no padding reaches device memory. Limits: 1 <= n <= FGM_MAX_N
// (= 512; the wide path's shared memory at n = 512 is 205 KB), nx >= 1. The
// launcher takes PyTorch's current stream, allocates nothing and never
// synchronizes.
#include <cuda_runtime.h>
#include <cstddef>

#define FGM_MAX_N 512
#define FGM_NARROW_MAX_N 128

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

constexpr int WIDE_TILE = 32;   // scenarios per block of the wide path
constexpr int WIDE_WARPS = 16;  // warps per block
constexpr int WIDE_JB = 32;     // columns of H per staged block
constexpr int WIDE_LDY = WIDE_TILE + 1;

template <int RB>
__global__ void __launch_bounds__(WIDE_TILE * WIDE_WARPS, 1)
fgm_boxqp_wide_kernel(const float* __restrict__ H, const float* __restrict__ G,
                      const float* __restrict__ x0, const float* __restrict__ lb,
                      const float* __restrict__ ub, const float* __restrict__ u0,
                      float* __restrict__ out, int B, int n, int nx, int iters,
                      float inv_L, float beta) {
  extern __shared__ __align__(16) float smem[];
  const int ldh = n | 1;                        // odd row stride of the Hᵀ block
  float* Ht = smem;                             // (WIDE_JB, ldh): Ht[jj*ldh + i] = H[i][j0+jj]
  float* ys = Ht + WIDE_JB * ldh;               // (n, WIDE_LDY)
  float* gs = ys + n * WIDE_LDY;                // (n, WIDE_LDY)
  float* lbs = gs + n * WIDE_LDY;
  float* ubs = lbs + n;

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * WIDE_TILE + lane;
  constexpr int NT = WIDE_TILE * WIDE_WARPS;
  const long long b0 = static_cast<long long>(blockIdx.x) * WIDE_TILE;
  const int nb = B - b0 < WIDE_TILE ? static_cast<int>(B - b0) : WIDE_TILE;

  // u0 (or zero) of the tile, coalesced, into ys; the bounds
  for (int idx = tid; idx < WIDE_TILE * n; idx += NT) {
    const int s = idx / n, i = idx - s * n;
    ys[i * WIDE_LDY + s] = (u0 != nullptr && s < nb)
        ? u0[static_cast<size_t>(b0 + s) * n + i] : 0.0f;
  }
  for (int i = tid; i < n; i += NT) {
    lbs[i] = lb[i];
    ubs[i] = ub[i];
  }
  __syncthreads();

  const long long b = b0 + lane;
  float u[RB], acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = w + WIDE_WARPS * r;
    u[r] = 0.0f;
    if (i < n) {
      float gv = 0.0f;
      if (b < B)
        for (int m = 0; m < nx; ++m)
          gv = fmaf(G[static_cast<size_t>(i) * nx + m],
                    x0[static_cast<size_t>(b) * nx + m], gv);
      gs[i * WIDE_LDY + lane] = gv;
      u[r] = ys[i * WIDE_LDY + lane];
    }
  }

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += WIDE_JB) {
      const int jb = n - j0 < WIDE_JB ? n - j0 : WIDE_JB;
      __syncthreads();                          // the previous block is consumed
      for (int idx = tid; idx < jb * n; idx += NT) {
        const int i = idx / jb, jj = idx - i * jb;
        Ht[jj * ldh + i] = H[static_cast<size_t>(i) * n + j0 + jj];
      }
      __syncthreads();
      for (int jj = 0; jj < jb; ++jj) {
        const float yv = ys[(j0 + jj) * WIDE_LDY + lane];
        const float* hcol = Ht + jj * ldh;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = w + WIDE_WARPS * r;
          if (i < n) acc[r] = fmaf(hcol[i], yv, acc[r]);
        }
      }
    }
    __syncthreads();                            // every product has read y
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = w + WIDE_WARPS * r;
      if (i < n) {
        const float yv = ys[i * WIDE_LDY + lane];
        const float grad = acc[r] + gs[i * WIDE_LDY + lane];
        const float un = fminf(fmaxf(yv - inv_L * grad, lbs[i]), ubs[i]);
        ys[i * WIDE_LDY + lane] = un + beta * (un - u[r]);
        u[r] = un;
      }
    }
  }

  // u of the tile through ys, stored coalesced
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = w + WIDE_WARPS * r;
    if (i < n) ys[i * WIDE_LDY + lane] = u[r];
  }
  __syncthreads();
  for (int idx = tid; idx < nb * n; idx += NT) {
    const int s = idx / n, i = idx - s * n;
    out[static_cast<size_t>(b0 + s) * n + i] = ys[i * WIDE_LDY + s];
  }
}

size_t wide_smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(WIDE_JB) * (n | 1) +
                          2 * static_cast<size_t>(n) * WIDE_LDY + 2 * n);
}

template <int RB>
cudaError_t launch_wide(const float* H, const float* G, const float* x0,
                        const float* lb, const float* ub, const float* u0,
                        float* out, int B, int n, int nx, int iters, float inv_L,
                        float beta, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      fgm_boxqp_wide_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 block(WIDE_TILE, WIDE_WARPS);
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(B) + WIDE_TILE - 1) /
                                        WIDE_TILE));
  fgm_boxqp_wide_kernel<RB><<<grid, block, smem, stream>>>(
      H, G, x0, lb, ub, u0, out, B, n, nx, iters, inv_L, beta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means the kernel was enqueued on `stream`. u0 may be null (start
// from zero). n <= FGM_NARROW_MAX_N takes fgm_boxqp_kernel, larger n the
// column-blocked fgm_boxqp_wide_kernel. FGM_MAX_N and FGM_NARROW_MAX_N are
// mirrored by ops/cuda_kernels.py.
extern "C" int fgm_boxqp_f32(const void* H, const void* G, const void* x0,
                             const void* lb, const void* ub, const void* u0,
                             void* out, int B, int n, int nx, int iters,
                             double inv_L, double beta, void* stream) {
  if (B <= 0 || n <= 0 || n > FGM_MAX_N || nx <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* Hf = static_cast<const float*>(H);
  const float* Gf = static_cast<const float*>(G);
  const float* xf = static_cast<const float*>(x0);
  const float* lbf = static_cast<const float*>(lb);
  const float* ubf = static_cast<const float*>(ub);
  const float* u0f = static_cast<const float*>(u0);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > FGM_NARROW_MAX_N) {
    const int rows = (n + WIDE_WARPS - 1) / WIDE_WARPS;
    return static_cast<int>(
        rows <= 16 ? launch_wide<16>(Hf, Gf, xf, lbf, ubf, u0f, of, B, n, nx, iters,
                                     static_cast<float>(inv_L),
                                     static_cast<float>(beta), st)
                   : launch_wide<32>(Hf, Gf, xf, lbf, ubf, u0f, of, B, n, nx, iters,
                                     static_cast<float>(inv_L),
                                     static_cast<float>(beta), st));
  }
  const int rows_threads = (n + ROWS - 1) / ROWS;
  const dim3 block(TILE_B / SCEN, rows_threads);
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(B) + TILE_B - 1) / TILE_B));
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) * ROWS * rows_threads
                                       + 2 * static_cast<size_t>(n) * TILE_B + 2 * n);
  cudaError_t err = cudaFuncSetAttribute(
      fgm_boxqp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fgm_boxqp_kernel<<<grid, block, smem, st>>>(
      Hf, Gf, xf, lbf, ubf, u0f, of, B, n, nx, iters, static_cast<float>(inv_L),
      static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}
