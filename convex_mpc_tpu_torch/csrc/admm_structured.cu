// Structured ADMM chunk for Hopper (sm_90a): `iters` over-relaxed ADMM steps
// per scenario on the condensed MPC QP's block form, one block per scenario.
//
// Replaces the TPU kernel convex_mpc_tpu/mpc/kernels.py::
// admm_iterations_structured (_structured_kernel), the iteration engine of
// admm.solve_adaptive (25 iterations per chunk on the main path, B = 512,
// nz = 192, m = 448).
//
// What bounds it on this card: per iteration each scenario streams its KKT
// inverse Minv (nz x nz f32, 147,456 B at nz = 192) once for the matvec;
// everything else is O(m). Re-read from device memory every iteration that is
// 75.5 MB per iteration at B = 512 (~23 us at 3.35 TB/s). The block loads
// Minv into shared memory once and keeps it there (with the block
// coefficients and all vectors) for the whole chunk, so a chunk reads Minv
// from device memory once instead of 25 times; the matvec then runs at
// shared-memory bandwidth. Where Minv does not fit (nz above ~230, horizons
// 24 and 32) the same kernel reads it from device memory (L2) instead.
//
// Arithmetic order is pinned to the plain PyTorch version (and to the JAX
// twin admm_iterations_structured_xla): the 4-term A'w and 3-term Av block
// sums in order with the box term last; rhs = (sigma x - q) + A'(rho z - y);
// the KKT matvec as the same halving tree over lanes zero-padded to a power
// of two (each lane holds lanes t, t+32, ...; the in-register stages halve
// them, then __shfl_down_sync 16, 8, 4, 2, 1; a warp folds four rows at once
// so their latency chains overlap); true division y / rho; every
// product and sum rounded on its own (__fmul_rn/__fadd_rn, and the file is
// compiled with -fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // 16 warps: the fastest of 256/512/1024 (PERF.md)
constexpr int ROWS = 4;  // KKT-matvec rows a warp folds at once

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp / jnp.clip
  return (v > hi) ? hi : v;
}

template <int VPL>
__global__ void __launch_bounds__(kThreads)
admm_structured_kernel(const float* __restrict__ C, const float* __restrict__ box,
                       const float* __restrict__ Minv, const float* __restrict__ q,
                       const float* __restrict__ l, const float* __restrict__ u,
                       const float* __restrict__ rho, const float* __restrict__ x0,
                       const float* __restrict__ z0, const float* __restrict__ y0,
                       float* __restrict__ xo, float* __restrict__ zo,
                       float* __restrict__ yo, int nb, int iters, float sigma,
                       float alpha, float oma, int minv_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int nz = 3 * nb, mfr = 4 * nb, m = mfr + nz;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  float* sC = smem;          // 12 nb: [blk][face][coord]
  float* sbox = sC + 12 * nb;  // nz
  float* sq = sbox + nz;
  float* sx = sq + nz;
  float* srhs = sx + nz;
  float* sxt = srhs + nz;
  float* sl = sxt + nz;  // m
  float* su = sl + m;
  float* srho = su + m;
  float* sz = srho + m;
  float* sy = sz + m;
  float* sw = sy + m;
  float* sM = sw + m;  // nz * nz when resident

  const size_t bv = (size_t)b * nz, bm = (size_t)b * m;
  for (int i = tid; i < 12 * nb; i += kThreads) sC[i] = C[(size_t)b * 12 * nb + i];
  for (int i = tid; i < nz; i += kThreads) {
    sbox[i] = box[bv + i];
    sq[i] = q[bv + i];
    sx[i] = x0[bv + i];
  }
  for (int i = tid; i < m; i += kThreads) {
    sl[i] = l[bm + i];
    su[i] = u[bm + i];
    srho[i] = rho[bm + i];
    sz[i] = z0[bm + i];
    sy[i] = y0[bm + i];
  }
  const float* Mg = Minv + (size_t)b * nz * nz;
  const float* M = Mg;
  if (minv_in_smem) {
    for (int i = tid; i < nz * nz; i += kThreads) sM[i] = Mg[i];
    M = sM;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // w = rho z - y
    for (int i = tid; i < m; i += kThreads) sw[i] = __fsub_rn(__fmul_rn(srho[i], sz[i]), sy[i]);
    __syncthreads();
    // rhs = (sigma x - q) + A'w: 4 friction faces in order, box term last
    for (int n = tid; n < nz; n += kThreads) {
      const int blk = n / 3, r = n - 3 * blk;
      const float* Cb = sC + 12 * blk;
      const float* wb = sw + 4 * blk;
      float acc = __fmul_rn(Cb[r], wb[0]);
      acc = __fadd_rn(acc, __fmul_rn(Cb[3 + r], wb[1]));
      acc = __fadd_rn(acc, __fmul_rn(Cb[6 + r], wb[2]));
      acc = __fadd_rn(acc, __fmul_rn(Cb[9 + r], wb[3]));
      acc = __fadd_rn(acc, __fmul_rn(sbox[n], sw[mfr + n]));
      srhs[n] = __fadd_rn(__fsub_rn(__fmul_rn(sigma, sx[n]), sq[n]), acc);
    }
    __syncthreads();
    // xt = Minv rhs: a warp folds ROWS rows at once (independent chains), each
    // by the same fixed halving tree over 32 * VPL lanes
    {
      float r[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = lane + 32 * k;
        r[k] = (j < nz) ? srhs[j] : 0.0f;
      }
      for (int n0 = ROWS * warp; n0 < nz; n0 += ROWS * nwarps) {
        float v[ROWS][VPL];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int n = n0 + rr;
          const float* Mr = M + (size_t)(n < nz ? n : 0) * nz;
#pragma unroll
          for (int k = 0; k < VPL; ++k) {
            const int j = lane + 32 * k;
            v[rr][k] = (j < nz) ? __fmul_rn(r[k], Mr[j]) : 0.0f;
          }
        }
#pragma unroll
        for (int h = VPL / 2; h >= 1; h >>= 1) {
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
            for (int k = 0; k < h; ++k) v[rr][k] = __fadd_rn(v[rr][k], v[rr][k + h]);
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            v[rr][0] = __fadd_rn(v[rr][0], __shfl_down_sync(0xffffffffu, v[rr][0], off));
        }
        if (lane == 0) {
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            if (n0 + rr < nz) sxt[n0 + rr] = v[rr][0];
        }
      }
    }
    __syncthreads();
    // A xt (3 coordinates in order, box rows), relaxation, projection, dual
    for (int i = tid; i < m; i += kThreads) {
      float axt;
      if (i < mfr) {
        const int blk = i >> 2, f = i & 3;
        const float* Cr = sC + 12 * blk + 3 * f;
        const float* xb = sxt + 3 * blk;
        axt = __fmul_rn(Cr[0], xb[0]);
        axt = __fadd_rn(axt, __fmul_rn(Cr[1], xb[1]));
        axt = __fadd_rn(axt, __fmul_rn(Cr[2], xb[2]));
      } else {
        const int n = i - mfr;
        axt = __fmul_rn(sbox[n], sxt[n]);
      }
      const float zi = sz[i], yi = sy[i], ri = srho[i];
      const float axr = __fadd_rn(__fmul_rn(alpha, axt), __fmul_rn(oma, zi));
      const float zn = clip(__fadd_rn(axr, __fdiv_rn(yi, ri)), sl[i], su[i]);
      sy[i] = __fadd_rn(yi, __fmul_rn(ri, __fsub_rn(axr, zn)));
      sz[i] = zn;
    }
    for (int n = tid; n < nz; n += kThreads)
      sx[n] = __fadd_rn(__fmul_rn(alpha, sxt[n]), __fmul_rn(oma, sx[n]));
    __syncthreads();
  }

  for (int i = tid; i < nz; i += kThreads) xo[bv + i] = sx[i];
  for (int i = tid; i < m; i += kThreads) {
    zo[bm + i] = sz[i];
    yo[bm + i] = sy[i];
  }
}

template <int VPL>
int launch(const float* C, const float* box, const float* Minv, const float* q,
           const float* l, const float* u, const float* rho, const float* x0,
           const float* z0, const float* y0, float* xo, float* zo, float* yo,
           int batch, int nb, int iters, float sigma, float alpha, float oma,
           int minv_in_smem, cudaStream_t stream) {
  const int nz = 3 * nb, m = 7 * nb;
  size_t smem = (size_t)(12 * nb + 5 * nz + 6 * m) * sizeof(float);
  if (minv_in_smem) smem += (size_t)nz * nz * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(admm_structured_kernel<VPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  admm_structured_kernel<VPL><<<batch, kThreads, smem, stream>>>(
      C, box, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, nb, iters, sigma, alpha,
      oma, minv_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. C (batch, nb, 4, 3); box, q, x0, xo (batch, 3 nb);
// Minv (batch, 3 nb, 3 nb); l, u, rho, z0, y0, zo, yo (batch, 7 nb); all
// contiguous f32 on the device. vpl = (lane width of the KKT fold) / 32,
// one of 4, 8, 16. Returns the cudaError_t of the launch (0 on success).
extern "C" int admm_structured_f32(const float* C, const float* box, const float* Minv,
                                   const float* q, const float* l, const float* u,
                                   const float* rho, const float* x0, const float* z0,
                                   const float* y0, float* xo, float* zo, float* yo,
                                   int batch, int nb, int iters, float sigma, float alpha,
                                   float oma, int vpl, int minv_in_smem,
                                   cudaStream_t stream) {
  switch (vpl) {
    case 4:
      return launch<4>(C, box, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, batch, nb,
                       iters, sigma, alpha, oma, minv_in_smem, stream);
    case 8:
      return launch<8>(C, box, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, batch, nb,
                       iters, sigma, alpha, oma, minv_in_smem, stream);
    case 16:
      return launch<16>(C, box, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, batch, nb,
                        iters, sigma, alpha, oma, minv_in_smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
