// Batched SPD inverse for Hopper (sm_90a): M^-1 = U^-1 U^-T with M = U'U,
// one block per matrix.
//
// Replaces the TPU kernel convex_mpc_tpu/ops/chol_kernel.py::spd_inverse
// (_spd_inverse_kernel, _chol_unrolled, _tri_inv_neumann): the KKT
// factorization of the structured ADMM solver and the polish's reduced solve
// (n = 12 x horizon: 192 on the main path at horizon 16, 288 and 384 at
// horizons 24 and 32; B = 512).
//
// What bounds it on this card: operations. The least work is n^3 f32 flops
// per matrix (LAPACK's count: Cholesky n^3/3, triangular inverse n^3/3,
// symmetric product n^3/3): 3.6 GFLOP at B = 512, n = 192, ~0.054 ms at the
// 67 TFLOP/s f32 rate of the CUDA cores, against 151 MB of input and output
// (~0.045 ms at 3.35 TB/s). What the design does about the operation bound:
// the algorithm is blocked in 16-wide panels so that almost all the work is
// register-tiled 4x4 updates fed by 16-byte loads, and the block
// synchronizes ~7 times per panel instead of at every column.
//
// Where the working set S (n x (n + 4) floats) lives:
//  - n <= 224 (150,528 B at n = 192): in shared memory, from load to store,
//    so device memory is touched once each way (spd_inverse_kernel<true>);
//  - larger n (331,776 B at n = 288, 595,968 B at n = 384, more than a
//    block's 227 KB): the same algorithm on a device-memory scratch buffer
//    that the wrapper allocates, (B, n, n + 4) f32 (spd_inverse_kernel<false>).
//    Only the 16 x 16 diagonal-block inverse W and the `bad` flag stay in
//    shared memory. At B = 512 that scratch is 170 MB (n = 288) or 305 MB
//    (n = 384); the ~132 matrices in flight touch ~44 MB or ~79 MB of it,
//    about or above the 50 MB L2, so these sizes run at L2/device-memory
//    latency. Keeping a large matrix on chip split over a thread-block
//    cluster is later work.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, B = 512):
// 0.9226 ms at n = 192, 2.6182 ms at n = 288 and 5.6415 ms at n = 384,
// against bounds of 0.0541, 0.1825 and 0.4327 ms (operations).
//
// Method (upper form, rows of S are rows of U and of V = U^-1):
//  1. blocked right-looking Cholesky M = U'U: per 16-row panel, warp 0
//     factors the 16 x 16 diagonal block; one thread per column solves the
//     panel's off-diagonal columns; 4 x 4 register tiles apply the trailing
//     update. A pivot that is not > 0 (including NaN) marks the matrix bad
//     and its whole output is NaN -- the non-SPD signal the polish
//     certificate relies on, as the TPU kernel's NaN pivot column;
//  2. V = U^-1 in place, one 16-column block at a time: the block above the
//     diagonal is -(V U[:, block]) U_block^-1 (a register-tiled product and
//     a 16 x 16 triangular inverse computed by warp 0), rows in groups of
//     256 in ascending order (a group reads only rows at or below its own);
//  3. out = V V' (rows of V dotted, 4 x 4 tiles, upper tiles mirrored),
//     written straight to device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int NB = 16;  // panel width
constexpr int RR = 2;   // phase-2 rows per thread per group (groups of 256 rows)
constexpr int kGroupRows = RR * kThreads / 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// linear index of an upper tile (ta <= tb < T) -> (ta, tb)
__device__ __forceinline__ void upper_tile(int t, int T, int& ta, int& tb) {
  int a = 0;
  while (t >= T - a) {
    t -= T - a;
    ++a;
  }
  ta = a;
  tb = a + t;
}

// kShared: S in dynamic shared memory (followed by W); otherwise S is this
// block's (n, n + 4) slice of `scratch` and W alone is in shared memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                   float* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = n + 4;  // row stride: 16-byte rows, rows spread over banks
  float* S = kShared ? smem : scratch + (size_t)blockIdx.x * n * ld;  // n x ld
  float* W = kShared ? smem + n * ld : smem;  // NB x NB diagonal-block inverse
  __shared__ int bad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;
  const float* Ab = A + base;
  float* Ob = out + base;
  const int n4 = n / 4;

  for (int e = tid; e < n * n4; e += kThreads) {
    const int i = e / n4, j4 = e - i * n4;
    st4(S + (size_t)i * ld + 4 * j4, ld4(Ab + (size_t)i * n + 4 * j4));
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  // ---- 1. blocked Cholesky, M = U'U, U in the upper triangle of S --------
  const int P = n / NB;
  for (int p = 0; p < P && !bad; ++p) {
    const int c0 = p * NB, c1 = c0 + NB;
    if (warp == 0) {
      for (int m = 0; m < NB; ++m) {
        float* rowm = S + (size_t)(c0 + m) * ld + c0;
        const float piv = rowm[m];
        const bool ok = piv > 0.0f;
        const float d = sqrtf(ok ? piv : 1.0f);
        if (!ok && lane == 0) bad = 1;
        __syncwarp();
        if (lane >= m && lane < NB) rowm[lane] = (lane == m) ? d : rowm[lane] / d;
        __syncwarp();
        for (int e = lane; e < NB * NB; e += 32) {
          const int r = e / NB, s = e - r * NB;
          if (r > m && s >= r) S[(size_t)(c0 + r) * ld + c0 + s] -= rowm[r] * rowm[s];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (bad) break;
    // panel: U[c0:c1, j] = U_pp^-T M[c0:c1, j], one column per thread
    for (int j = c1 + tid; j < n; j += kThreads) {
      float x[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        float v = S[(size_t)(c0 + m) * ld + j];
#pragma unroll
        for (int l = 0; l < m; ++l) v -= S[(size_t)(c0 + l) * ld + c0 + m] * x[l];
        x[m] = v / S[(size_t)(c0 + m) * ld + c0 + m];
        S[(size_t)(c0 + m) * ld + j] = x[m];
      }
    }
    __syncthreads();
    // trailing update of the upper triangle: M[a][b] -= sum_m U[m][a] U[m][b]
    const int T = (n - c1) / 4;
    const int ntiles = T * (T + 1) / 2;
    for (int t = tid; t < ntiles; t += kThreads) {
      int ta, tb;
      upper_tile(t, T, ta, tb);
      const int a0 = c1 + 4 * ta, b0 = c1 + 4 * tb;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        const float4 ua = ld4(S + (size_t)(c0 + m) * ld + a0);
        const float4 ub = ld4(S + (size_t)(c0 + m) * ld + b0);
        const float va[4] = {ua.x, ua.y, ua.z, ua.w};
        const float vb[4] = {ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += va[r] * vb[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* rp = S + (size_t)(a0 + r) * ld + b0;
        float4 v = ld4(rp);
        v.x -= acc[r][0];
        v.y -= acc[r][1];
        v.z -= acc[r][2];
        v.w -= acc[r][3];
        st4(rp, v);
      }
    }
    __syncthreads();
  }

  if (bad) {
    const float qnan = __int_as_float(0x7fc00000);
    const float4 q4 = make_float4(qnan, qnan, qnan, qnan);
    for (int e = tid; e < n * n4; e += kThreads) st4(Ob + 4 * (size_t)e, q4);
    return;
  }

  // ---- 2. V = U^-1 in place, 16-column blocks left to right ---------------
  const int jg = tid & 3;      // 4 columns of the block per thread
  const int ibase = tid >> 2;  // rows i0 + ibase + 128 rr of each row group
  for (int q = 0; q < P; ++q) {
    const int c0 = q * NB;
    if (warp == 0 && lane < NB) {  // W = U_qq^-1, column `lane`
      const int jj = lane;
      W[jj * NB + jj] = 1.0f / S[(size_t)(c0 + jj) * ld + c0 + jj];
      for (int i = jj - 1; i >= 0; --i) {
        float s = 0.0f;
        for (int k = i + 1; k <= jj; ++k) s += S[(size_t)(c0 + i) * ld + c0 + k] * W[k * NB + jj];
        W[i * NB + jj] = -s / S[(size_t)(c0 + i) * ld + c0 + i];
      }
      for (int i = jj + 1; i < NB; ++i) W[i * NB + jj] = 0.0f;
    }
    // row groups in ascending order: G for row i reads U rows k >= i, which
    // the groups before it have not overwritten. At least one pass (q = 0
    // has no rows above the block): its barriers publish W.
    for (int i0 = 0; i0 < c0 || i0 == 0; i0 += kGroupRows) {
      // G = V[0:c0, 0:c0] U[0:c0, c0:c0+16] (V upper: k from i)
      float4 g[RR];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        g[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int i = i0 + ibase + 128 * rr;
        if (i < c0) {
          const float* vrow = S + (size_t)i * ld;
          for (int k = i; k < c0; ++k) {
            const float v = vrow[k];
            const float4 u = ld4(S + (size_t)k * ld + c0 + 4 * jg);
            g[rr].x += v * u.x;
            g[rr].y += v * u.y;
            g[rr].z += v * u.z;
            g[rr].w += v * u.w;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        const int i = i0 + ibase + 128 * rr;
        if (i < c0) st4(S + (size_t)i * ld + c0 + 4 * jg, g[rr]);
      }
      __syncthreads();
      // V[0:c0, block] = -G W
      float4 o[RR];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        o[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int i = i0 + ibase + 128 * rr;
        if (i < c0) {
          const float* grow = S + (size_t)i * ld + c0;
#pragma unroll
          for (int l = 0; l < NB; ++l) {
            const float gl = grow[l];
            const float4 w = ld4(W + l * NB + 4 * jg);
            o[rr].x -= gl * w.x;
            o[rr].y -= gl * w.y;
            o[rr].z -= gl * w.z;
            o[rr].w -= gl * w.w;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        const int i = i0 + ibase + 128 * rr;
        if (i < c0) st4(S + (size_t)i * ld + c0 + 4 * jg, o[rr]);
      }
    }
    for (int e = tid; e < NB * NB; e += kThreads) {
      const int r = e / NB, s = e - r * NB;
      S[(size_t)(c0 + r) * ld + c0 + s] = W[e];
    }
    __syncthreads();
  }

  // ---- 3. out = V V': out[a][b] = sum_{k >= max(a, b)} V[a][k] V[b][k] -----
  const int T = n / 4;
  const int ntiles = T * (T + 1) / 2;
  for (int t = tid; t < ntiles; t += kThreads) {
    int ta, tb;
    upper_tile(t, T, ta, tb);
    const int a0 = 4 * ta, b0 = 4 * tb;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int k = b0; k < n; k += 4) {
      float va[4][4], vb[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = ld4(S + (size_t)(a0 + r) * ld + k);
        va[r][0] = x.x; va[r][1] = x.y; va[r][2] = x.z; va[r][3] = x.w;
        const float4 y = ld4(S + (size_t)(b0 + r) * ld + k);
        vb[r][0] = y.x; vb[r][1] = y.y; vb[r][2] = y.z; vb[r][3] = y.w;
      }
      if (k == b0) {  // entries left of the diagonal are not part of V
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (k + kk < a0 + r) va[r][kk] = 0.0f;
            if (k + kk < b0 + r) vb[r][kk] = 0.0f;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[r][c] += va[r][kk] * vb[c][kk];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st4(Ob + (size_t)(a0 + r) * n + b0, make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      st4(Ob + (size_t)(b0 + r) * n + a0, make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]));
    }
  }
}

template <bool kShared>
int launch(const float* A, float* out, float* scratch, int batch, int n, cudaStream_t stream) {
  const size_t smem = (size_t)((kShared ? n * (n + 4) : 0) + NB * NB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spd_inverse_kernel<kShared><<<batch, kThreads, smem, stream>>>(A, out, scratch, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: A and out are (batch, n, n) contiguous f32 device arrays,
// n % 16 == 0. With scratch == NULL the working set is held in shared memory
// (n <= 224); otherwise scratch is a (batch, n, n + 4) f32 device buffer that
// holds it. Returns the cudaError_t of the launch (0 on success).
extern "C" int spd_inverse_f32(const float* A, float* out, float* scratch, int batch, int n,
                               cudaStream_t stream) {
  if (n % NB != 0) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr) return launch<true>(A, out, nullptr, batch, n, stream);
  return launch<false>(A, out, scratch, batch, n, stream);
}
