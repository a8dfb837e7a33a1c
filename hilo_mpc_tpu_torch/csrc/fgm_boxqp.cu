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
// ~8n for the update, on one H and a few vectors per tile: at n = 160,
// B = 1024, 100 iterations ~5.3e9 FLOPs against ~1 MB of compulsory
// traffic, so it is bound by operations, not bytes; the same holds at
// every n.
//
// Three designs, chosen by n in ops/cuda_kernels.py:fgm_boxqp_design (the
// TPU kernel pads n to 128 lanes and keeps H resident in VMEM whatever n):
// up to FGM_REG_MAX_N the register design (csrc/fgm_boxqp_reg.cuh), up to
// FGM_NARROW_MAX_N = 128 the tensor-core design (csrc/fgm_boxqp_tc.cuh:
// 3xTF32 wgmma, H in one block's shared memory), each built per n at
// first use; above 128 this file's cluster kernel, since Hopper's 227 KB
// of shared memory per block no longer hold H.
//
// 128 < n <= FGM_MAX_N (fgm_boxqp_cluster_kernel). H is split by rows over
// the C blocks (CTAs) of a thread-block cluster and stays resident for the
// whole solve: block q of a cluster keeps rows q·R .. q·R + R - 1
// (R = ceil(n / C) rounded up to 4) as a column-major slice Ht[j*R + i] in
// its shared memory, loaded once. A cluster owns a tile of TB scenarios (32,
// or 16 where the slice and y's two buffers would pass 227 KB); every block
// of it keeps the tile's whole y, double-buffered. Thread (tx, ty) owns 4
// rows (4ty..4ty+3 of the slice) of 2 scenarios (2tx, 2tx+1) and keeps their
// u, g and bounds in registers; its product reads per column j one float4
// of the slice (a broadcast: the lanes of a warp share few ty) and one
// float2 of y, for 8 FMAs. Each iteration a block updates its rows of u and
// writes its rows of the next y into the next buffer of EVERY block of the
// cluster through distributed shared memory (map_shared_rank), then one
// cluster barrier (barrier.cluster arrive/wait: it also makes those writes
// visible) ends the iteration. ops/cuda_kernels.py:fgm_boxqp_design picks
// (C, TB) per n, the first of (4, 32), (8, 32), (8, 16) whose block fits
// (portable cluster sizes; each puts at least 128 blocks on the card at
// B = 1024); the entry point builds those three. The products are plain
// float32 FMAs (no tensor cores here yet).
//
// Non-finite bounds become ∓FGM_INF (1e30) as a kernel loads them (the JAX
// kernel's padding, pallas_kernels.py:67-68). Rows past n are never
// stored; scenarios past B compute on zeros and are never stored: no
// padding reaches device memory. Limits: FGM_NARROW_MAX_N < n <= FGM_MAX_N
// (= 512; at n = 512 a cluster of 8 keeps 64 rows, 128 KB, and a tile of 16
// scenarios, 192 KB per block in all), nx >= 1. The
// launcher takes PyTorch's current stream, allocates nothing and never
// synchronizes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>

#define FGM_MAX_N 512
#define FGM_NARROW_MAX_N 128
// what a non-finite bound becomes (ops/cuda_kernels.py:FGM_INF)
#define FGM_INF 1e30f

namespace {

__device__ __forceinline__ float lower_bound(float v) { return isfinite(v) ? v : -FGM_INF; }
__device__ __forceinline__ float upper_bound(float v) { return isfinite(v) ? v : FGM_INF; }

constexpr int CL_ROWS = 4;   // rows per thread of the cluster design
constexpr int CL_SCEN = 2;   // scenarios per thread

template <int C, int TB>
__global__ void __launch_bounds__(1024)
fgm_boxqp_cluster_kernel(const float* __restrict__ H, const float* __restrict__ G,
                         const float* __restrict__ x0, const float* __restrict__ lb,
                         const float* __restrict__ ub, const float* __restrict__ u0,
                         float* __restrict__ out, int B, int n, int nx, int iters,
                         float inv_L, float beta, int R) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* Ht = smem;                                  // (n, R): Ht[j*R + i] = H[r0+i][j]
  float* ys = Ht + static_cast<size_t>(n) * R;       // 2 x (n, TB)
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * R;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long b0 = static_cast<long long>(blockIdx.x / C) * TB;

  // the block's rows of H (coalesced along each row), the tile's y0
  for (int idx = tid; idx < R * n; idx += nthreads) {
    const int i = idx / n, j = idx - i * n;
    Ht[static_cast<size_t>(j) * R + i] =
        r0 + i < n ? H[static_cast<size_t>(r0 + i) * n + j] : 0.0f;
  }
  for (int idx = tid; idx < TB * n; idx += nthreads) {
    const int s = idx / n, i = idx - s * n;
    ys[i * TB + s] = (u0 != nullptr && b0 + s < B)
        ? u0[static_cast<size_t>(b0 + s) * n + i] : 0.0f;
  }

  const int row0 = CL_ROWS * threadIdx.y;
  const int s0 = CL_SCEN * threadIdx.x;
  float u[CL_ROWS][CL_SCEN], g[CL_ROWS][CL_SCEN], lo[CL_ROWS], hi[CL_ROWS];
#pragma unroll
  for (int k = 0; k < CL_ROWS; ++k) {
    const int i = r0 + row0 + k;
    lo[k] = i < n ? lower_bound(lb[i]) : 0.0f;
    hi[k] = i < n ? upper_bound(ub[i]) : 0.0f;
#pragma unroll
    for (int c = 0; c < CL_SCEN; ++c) {
      const long long b = b0 + s0 + c;
      float gv = 0.0f;
      if (i < n && b < B)
        for (int m = 0; m < nx; ++m)
          gv = fmaf(G[static_cast<size_t>(i) * nx + m],
                    x0[static_cast<size_t>(b) * nx + m], gv);
      g[k][c] = gv;
    }
  }
  // every block of the cluster has started and holds its y0
  cluster.sync();
#pragma unroll
  for (int k = 0; k < CL_ROWS; ++k) {
    const int i = r0 + row0 + k;
#pragma unroll
    for (int c = 0; c < CL_SCEN; ++c) u[k][c] = i < n ? ys[i * TB + s0 + c] : 0.0f;
  }

  for (int it = 0; it < iters; ++it) {
    const float* cur = ys + (it & 1) * n * TB;
    float* nxt = ys + ((it & 1) ^ 1) * n * TB;
    float acc[CL_ROWS][CL_SCEN];
#pragma unroll
    for (int k = 0; k < CL_ROWS; ++k)
#pragma unroll
      for (int c = 0; c < CL_SCEN; ++c) acc[k][c] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float4 h = *reinterpret_cast<const float4*>(Ht + j * R + row0);
      const float2 y = *reinterpret_cast<const float2*>(cur + j * TB + s0);
      const float hk[CL_ROWS] = {h.x, h.y, h.z, h.w};
      const float yc[CL_SCEN] = {y.x, y.y};
#pragma unroll
      for (int k = 0; k < CL_ROWS; ++k)
#pragma unroll
        for (int c = 0; c < CL_SCEN; ++c) acc[k][c] = fmaf(hk[k], yc[c], acc[k][c]);
    }
#pragma unroll
    for (int k = 0; k < CL_ROWS; ++k) {
      const int i = r0 + row0 + k;
      if (i < n) {
        float yn[CL_SCEN];
#pragma unroll
        for (int c = 0; c < CL_SCEN; ++c) {
          const float yv = cur[i * TB + s0 + c];
          const float grad = acc[k][c] + g[k][c];
          const float un = fminf(fmaxf(yv - inv_L * grad, lo[k]), hi[k]);
          yn[c] = un + beta * (un - u[k][c]);
          u[k][c] = un;
        }
        const float2 v = make_float2(yn[0], yn[1]);
#pragma unroll
        for (int q = 0; q < C; ++q)
          *reinterpret_cast<float2*>(cluster.map_shared_rank(nxt, q) + i * TB + s0) = v;
      }
    }
    cluster.sync();
  }

  // u of the block's rows through ys (no peer writes after the last
  // barrier), stored as runs of R words per scenario
#pragma unroll
  for (int k = 0; k < CL_ROWS; ++k) {
    const int i = r0 + row0 + k;
#pragma unroll
    for (int c = 0; c < CL_SCEN; ++c)
      if (i < n) ys[i * TB + s0 + c] = u[k][c];
  }
  __syncthreads();
  for (int idx = tid; idx < TB * R; idx += nthreads) {
    const int s = idx / R, i = r0 + (idx - s * R);
    if (i < n && b0 + s < B) out[static_cast<size_t>(b0 + s) * n + i] = ys[i * TB + s];
  }
}

size_t cluster_smem_bytes(int n, int R, int TB) {
  return sizeof(float) * (static_cast<size_t>(n) * R + 2 * static_cast<size_t>(n) * TB);
}

template <int C, int TB>
cudaError_t launch_cluster(const float* H, const float* G, const float* x0,
                           const float* lb, const float* ub, const float* u0,
                           float* out, int B, int n, int nx, int iters,
                           float inv_L, float beta, cudaStream_t stream) {
  const int R = ((n + C - 1) / C + CL_ROWS - 1) / CL_ROWS * CL_ROWS;
  const size_t smem = cluster_smem_bytes(n, R, TB);
  cudaError_t err = cudaFuncSetAttribute(
      fgm_boxqp_cluster_kernel<C, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long clusters = (static_cast<long long>(B) + TB - 1) / TB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * C));
  cfg.blockDim = dim3(TB / CL_SCEN, R / CL_ROWS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fgm_boxqp_cluster_kernel<C, TB>, H, G, x0, lb, ub,
                           u0, out, B, n, nx, iters, inv_L, beta, R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means the kernel was enqueued on `stream`. u0 may be null (start
// from zero). It takes FGM_NARROW_MAX_N < n <= FGM_MAX_N, with `cluster`
// blocks per tile of `tile` scenarios, (4, 32), (8, 32) or (8, 16) as
// ops/cuda_kernels.py:fgm_boxqp_design chooses them (any other pair, and
// any smaller n, is refused: those go to the register and tensor-core
// designs). FGM_MAX_N and FGM_NARROW_MAX_N are mirrored there.
extern "C" int fgm_boxqp_f32(const void* H, const void* G, const void* x0,
                             const void* lb, const void* ub, const void* u0,
                             void* out, int B, int n, int nx, int iters,
                             double inv_L, double beta, int cluster, int tile,
                             void* stream) {
  if (B <= 0 || n <= FGM_NARROW_MAX_N || n > FGM_MAX_N || nx <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* Hf = static_cast<const float*>(H);
  const float* Gf = static_cast<const float*>(G);
  const float* xf = static_cast<const float*>(x0);
  const float* lbf = static_cast<const float*>(lb);
  const float* ubf = static_cast<const float*>(ub);
  const float* u0f = static_cast<const float*>(u0);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float il = static_cast<float>(inv_L), bt = static_cast<float>(beta);
  if (cluster == 4 && tile == 32)
    return static_cast<int>(launch_cluster<4, 32>(Hf, Gf, xf, lbf, ubf, u0f, of, B,
                                                  n, nx, iters, il, bt, st));
  if (cluster == 8 && tile == 32)
    return static_cast<int>(launch_cluster<8, 32>(Hf, Gf, xf, lbf, ubf, u0f, of, B,
                                                  n, nx, iters, il, bt, st));
  if (cluster == 8 && tile == 16)
    return static_cast<int>(launch_cluster<8, 16>(Hf, Gf, xf, lbf, ubf, u0f, of, B,
                                                  n, nx, iters, il, bt, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
