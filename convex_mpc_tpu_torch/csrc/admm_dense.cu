// Dense-A ADMM iterations for Hopper (sm_90a): `iters` over-relaxed ADMM
// steps per scenario against a dense constraint matrix A, one block per
// scenario looping over the iterations.
//
// Replaces the TPU kernel convex_mpc_tpu/mpc/kernels.py::admm_iterations
// (_kernel), the iteration engine of the legacy fixed-segment solver
// admm.solve (mpc_cycle_fixed; B = 512, A (448, 192), Minv (192, 192)). The
// plain PyTorch version is mpc/kernels.py::admm_iterations_plain.
//
// Per iteration: t = rho z - y; rhs = (sigma x - q) + A' t; xt = Minv rhs;
// x <- alpha xt + (1 - alpha) x; ax = alpha A xt + (1 - alpha) z;
// z <- clip(ax + y / rho, l, u) with true division, and y / rho = 0 on rows
// with rho = 0 (the TPU kernel's inert-padding rule); y <- y + rho (ax - z).
//
// Layout. Minv (147,456 B at n = 192) and every vector stay in shared memory
// for the whole chunk; A (344,064 B at 448 x 192) does not fit beside Minv in
// a block's 227 KB, so it is streamed from device memory (or L2) twice per
// iteration: A' t by one thread per column (a warp reads a row's adjacent
// columns), A xt and the Minv rows by one warp per row (lanes over the
// columns, reduced by __shfl_down_sync). Where Minv does not fit either, it
// is read from device memory too.
//
// What bounds it on this card. Per 25-iteration chunk at B = 512, m = 448,
// n = 192: 25 x (2 x 2mn + 2n^2) flops = 5.4 GFLOP, 0.081 ms at 67 TFLOP/s
// f32; reading A and Minv once is 252 MB, 0.075 ms at 3.35 TB/s. So the
// bound is ~0.08 ms, set by operations. This first version re-reads A every
// iteration: 25 x 2 x 176 MB = 8.8 GB per chunk, ~2.6 ms at 3.35 TB/s. With
// one 160 KB block per SM, too few loads are in flight to reach that rate:
// it is memory-latency-bound (PERF.md has its measured time). Keeping A on
// chip (split across a thread-block cluster's shared memory) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // 16 warps

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp / jnp.clip
  return (v > hi) ? hi : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
admm_dense_kernel(const float* __restrict__ A, const float* __restrict__ Minv,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ z0,
                  const float* __restrict__ y0, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo, int m, int n, int iters,
                  float sigma, float alpha, float oma, int minv_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  float* sq = smem;  // n
  float* sx = sq + n;
  float* srhs = sx + n;
  float* sxt = srhs + n;
  float* sl = sxt + n;  // m
  float* su = sl + m;
  float* srho = su + m;
  float* sz = srho + m;
  float* sy = sz + m;
  float* st = sy + m;
  float* sM = st + m;  // n * n when resident

  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const float* Ab = A + (size_t)b * m * n;
  for (int i = tid; i < n; i += kThreads) {
    sq[i] = q[bn + i];
    sx[i] = x0[bn + i];
  }
  for (int i = tid; i < m; i += kThreads) {
    sl[i] = l[bm + i];
    su[i] = u[bm + i];
    srho[i] = rho[bm + i];
    sz[i] = z0[bm + i];
    sy[i] = y0[bm + i];
  }
  const float* Mg = Minv + (size_t)b * n * n;
  const float* M = Mg;
  if (minv_in_smem) {
    for (int i = tid; i < n * n; i += kThreads) sM[i] = Mg[i];
    M = sM;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = tid; i < m; i += kThreads) st[i] = srho[i] * sz[i] - sy[i];
    __syncthreads();
    // rhs = (sigma x - q) + A' t: one thread per column
    for (int k = tid; k < n; k += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) acc += Ab[(size_t)i * n + k] * st[i];
      srhs[k] = (sigma * sx[k] - sq[k]) + acc;
    }
    __syncthreads();
    // xt = Minv rhs: one warp per row
    for (int r = warp; r < n; r += nwarps) {
      const float* Mr = M + (size_t)r * n;
      float acc = 0.0f;
      for (int k = lane; k < n; k += 32) acc += Mr[k] * srhs[k];
      acc = warp_sum(acc);
      if (lane == 0) sxt[r] = acc;
    }
    __syncthreads();
    // A xt (one warp per row), relaxation, projection and the dual step
    for (int r = warp; r < m; r += nwarps) {
      const float* Ar = Ab + (size_t)r * n;
      float acc = 0.0f;
      for (int k = lane; k < n; k += 32) acc += Ar[k] * sxt[k];
      acc = warp_sum(acc);
      if (lane == 0) {
        const float zi = sz[r], yi = sy[r], ri = srho[r];
        const float axr = alpha * acc + oma * zi;
        const float y_over_rho = (ri > 0.0f) ? yi / ri : 0.0f;
        const float zn = clip(axr + y_over_rho, sl[r], su[r]);
        sy[r] = yi + ri * (axr - zn);
        sz[r] = zn;
      }
    }
    for (int k = tid; k < n; k += kThreads) sx[k] = alpha * sxt[k] + oma * sx[k];
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) xo[bn + i] = sx[i];
  for (int i = tid; i < m; i += kThreads) {
    zo[bm + i] = sz[i];
    yo[bm + i] = sy[i];
  }
}

}  // namespace

// C entry point. A (batch, m, n); Minv (batch, n, n); q, x0, xo (batch, n);
// l, u, rho, z0, y0, zo, yo (batch, m); all contiguous f32 on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int admm_dense_f32(const float* A, const float* Minv, const float* q, const float* l,
                              const float* u, const float* rho, const float* x0, const float* z0,
                              const float* y0, float* xo, float* zo, float* yo, int batch, int m,
                              int n, int iters, float sigma, float alpha, float oma,
                              int minv_in_smem, cudaStream_t stream) {
  if (batch <= 0) return 0;
  size_t smem = (size_t)(4 * n + 6 * m) * sizeof(float);
  if (minv_in_smem) smem += (size_t)n * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(admm_dense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  admm_dense_kernel<<<batch, kThreads, smem, stream>>>(A, Minv, q, l, u, rho, x0, z0, y0, xo, zo,
                                                       yo, m, n, iters, sigma, alpha, oma,
                                                       minv_in_smem);
  return (int)cudaGetLastError();
}
