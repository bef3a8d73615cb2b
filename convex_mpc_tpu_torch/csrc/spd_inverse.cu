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
// every phase is a register-tiled product of 4 x 4 tiles fed by 16-byte
// loads over all threads; the one serial stretch, a warp factoring and
// inverting a 16 x 16 diagonal block in registers, takes one rsqrtf per
// pivot and no division; three matrices share an SM at n = 192.
//
// Working set: the upper triangle of S, packed by rows. Row i keeps columns
// 4 floor(i/4) .. n-1, so every row starts on a 16-byte boundary and element
// (i, j) is S[rowoff(i, n) + j]: n (n + 4) / 2 floats, 75,264 B at n = 192
// (three 256-thread CTAs per SM), 168,192 B at n = 288, 207,360 B at
// n = 320. Where that fits one block's shared memory beside the static
// `bad` flag, S lives there from load to store (spd_inverse_kernel<true>);
// above (n >= 352: 297,984 B at n = 384) the same code runs on a
// device-memory scratch of that size per matrix (spd_inverse_kernel<false>).
// The up to 3 entries left of the diagonal that a packed row keeps are set to
// 0 when its diagonal block is inverted, so no later phase masks them.
// shape_for() alone decides the layout and the CTAs per SM;
// spd_inverse_shape() reports it to the wrapper.
//
// Method (upper form, rows of S are rows of U and of V = U^-1):
//  1. blocked right-looking Cholesky M = U'U, per 16-row panel p: warp 0
//     factors the diagonal block in registers (lane s holds column s, rows
//     broadcast by shuffles) and replaces it by W = U_pp^-1; the panel is the
//     product U[p, j] = W' M[p, j]; 4 x 4 tiles apply the trailing update.
//     A pivot that is not > 0 (including NaN) marks the matrix bad and its
//     whole output is NaN -- the non-SPD signal the polish certificate relies
//     on, as the TPU kernel's NaN pivot column;
//  2. V = U^-1 in place, one 16-column block q at a time, using the W that
//     phase 1 left on the diagonal: U[0:c0, q] <- U[0:c0, q] W_q, then
//     V[0:c0, q] = -V[0:c0, 0:c0] U[0:c0, q], each a 4 x 4-tiled product
//     (tiles in ascending rounds of rows: a tile reads only rows at or below
//     its own);
//  3. out = V V' (rows of V dotted, 4 x 4 tiles, upper tiles mirrored),
//     written straight to device memory.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // registers capped so that three CTAs fit an SM
constexpr int NB = 16;         // panel width
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__host__ __device__ __forceinline__ long long packed_floats(int n) {
  return (long long)n * (n + 4) / 2;
}

// S[rowoff(i, n) + j] is element (i, j), j >= 4 floor(i/4), of the packed rows.
__device__ __forceinline__ int rowoff(int i, int n) {
  const int g = i >> 2;
  return 4 * g * n - 8 * g * (g - 1) + (i & 3) * (n - 4 * g) - 4 * g;
}

// upper tile t = tb (tb + 1) / 2 + ta -> (ta <= tb): tiles of one tb are
// neighbours, so the lanes of a warp share tb and with it their trip count
__device__ __forceinline__ void upper_tile(int t, int& ta, int& tb) {
  int b = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  if ((b + 1) * (b + 2) / 2 <= t) ++b;  // the float root may be off by one
  else if (b * (b + 1) / 2 > t) --b;
  tb = b;
  ta = t - b * (b + 1) / 2;
}

__device__ __forceinline__ void zero4x4(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

__device__ __forceinline__ void unpack(const float4 v, float (&x)[4]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// acc[r][c] += sum_kk a[r][kk] b[kk][c], a and b each 4 rows of 4 columns
__device__ __forceinline__ void mac4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
  float x[4][4], y[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    unpack(a[r], x[r]);
    unpack(b[r], y[r]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc[r][c] += x[r][kk] * y[kk][c];
}

// Warp 0: the 16 x 16 diagonal block at (c0, c0). Lane s holds column s of
// it in registers; Cholesky U_pp, then W = U_pp^-1 from W U_pp = I column by
// column, left to right (lane k finishes column k of W and broadcasts it by
// shuffles to the lanes right of it; each step needs the one before, which
// keeps the shuffled values from piling up in registers); W's upper triangle
// replaces the block, with 0 where a packed row keeps entries left of the
// diagonal. Sets *bad on a pivot that is not > 0.
__device__ __forceinline__ void invert_diag_block(float* S, int n, int c0, int lane, int* bad) {
  float col[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    col[r] = 0.0f;
    if (lane < NB && r <= lane) col[r] = S[rowoff(c0 + r, n) + c0 + lane];
  }
  bool ok_all = true;
  float dinv[NB];  // 1 / U(m, m)
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const float piv = __shfl_sync(kFull, col[m], m);
    const bool ok = piv > 0.0f;
    ok_all = ok_all && ok;
    const float x = ok ? piv : 1.0f;
    const float y = rsqrtf(x);
    dinv[m] = y * (1.5f - 0.5f * x * y * y);  // one Newton step on rsqrtf
    if (lane >= m) col[m] *= dinv[m];         // U(m, m) = piv / sqrt(piv)
#pragma unroll
    for (int r = m + 1; r < NB; ++r) {
      const float umr = __shfl_sync(kFull, col[m], r);  // U(m, r)
      if (lane >= r) col[r] -= umr * col[m];
    }
  }
  if (!ok_all && lane == 0) *bad = 1;
  // lane j: w[i] = W(i, j) = (delta(i, j) - sum_{k < j} W(i, k) U(k, j)) / U(j, j)
  float w[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) w[i] = (i == lane) ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
#pragma unroll
    for (int i = 0; i <= k; ++i) {
      if (lane == k) w[i] *= dinv[k];
      const float wik = __shfl_sync(kFull, w[i], k);  // W(i, k), final
      if (lane > k) w[i] -= wik * col[k];
    }
  }
  if (lane < NB) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if ((i & ~3) <= lane) S[rowoff(c0 + i, n) + c0 + lane] = w[i];
  }
}

// Trailing update of upper tile t (upper_tile order) right of panel c0:
// M[a][b] -= sum_m U[c0 + m][a] U[c0 + m][b], a, b >= c1 = c0 + 16.
__device__ __forceinline__ void trailing_tile(float* S, int n, int c0, int t) {
  int ta, tb;
  upper_tile(t, ta, tb);
  const int a0 = c0 + NB + 4 * ta, b0 = c0 + NB + 4 * tb;
  float acc[4][4];
  zero4x4(acc);
  // fully unrolled, the hoisted loads would spill at 80 registers
#pragma unroll 4
  for (int m = 0; m < NB; ++m) {
    const float* row = S + rowoff(c0 + m, n);
    float va[4], vb[4];
    unpack(ld4(row + a0), va);
    unpack(ld4(row + b0), vb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += va[r] * vb[c];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* rp = S + rowoff(a0 + r, n) + b0;
    float4 v = ld4(rp);
    v.x -= acc[r][0];
    v.y -= acc[r][1];
    v.z -= acc[r][2];
    v.w -= acc[r][3];
    st4(rp, v);
  }
}

// kShared: S in dynamic shared memory; otherwise S is this block's
// packed_floats(n) slice of `scratch`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                   float* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) float smem[];
  float* S = kShared ? smem : scratch + (size_t)blockIdx.x * packed_floats(n);
  __shared__ int bad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;
  const float* Ab = A + base;
  float* Ob = out + base;
  const int n4 = n / 4;

  // the packed upper triangle of A; unrolled so that several loads are in flight
#pragma unroll 4
  for (int e = tid; e < n * n4; e += kThreads) {
    const int i = e / n4, j4 = e - i * n4;
    if (j4 >= (i >> 2)) st4(S + rowoff(i, n) + 4 * j4, ld4(Ab + 4 * (size_t)e));
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  // ---- 1. blocked Cholesky, M = U'U, W = U_pp^-1 on each diagonal block ----
  const int P = n / NB;
  if (warp == 0) invert_diag_block(S, n, 0, lane, &bad);
  __syncthreads();
  for (int p = 0; p < P && !bad; ++p) {
    const int c0 = p * NB, c1 = c0 + NB;
    // panel: U[c0 + r][j] = sum_{m <= r} W[m][r] M[c0 + m][j], j >= c1; tile
    // t = rows 4 (t & 3).., columns c1 + 4 (t >> 2).., so that a round of
    // tiles holds whole column strips and rounds touch disjoint columns
    const int ntp = n - c1;
    for (int t0 = 0; t0 < ntp; t0 += kThreads) {
      const int t = t0 + tid;
      const int r0 = 4 * (t & 3), j0 = c1 + 4 * (t >> 2);
      float acc[4][4];
      zero4x4(acc);
      if (t < ntp) {
#pragma unroll 1
        for (int m = 0; m < r0 + 4; ++m) {  // W[m][r0 + r] = 0 for m > r0 + r
          const float* row = S + rowoff(c0 + m, n);
          float w[4], x[4];
          unpack(ld4(row + c0 + r0), w);
          unpack(ld4(row + j0), x);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += w[r] * x[c];
        }
      }
      __syncthreads();  // every tile of the round has read its column strip
      if (t < ntp) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st4(S + rowoff(c0 + r0 + r, n) + j0,
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
    __syncthreads();
    // trailing update, looking ahead: warp 0 updates the next diagonal block
    // (tiles t < 10, those with tb < 4) and inverts it while the other warps
    // update the rest of the trailing triangle
    const int T = (n - c1) / 4;
    const int ntiles = T * (T + 1) / 2;
    if (warp == 0) {
      if (c1 < n) {
        if (lane < 10) trailing_tile(S, n, c0, lane);
        __syncwarp();
        invert_diag_block(S, n, c1, lane, &bad);
      }
    } else {
      for (int t = 10 + tid - 32; t < ntiles; t += kThreads - 32) trailing_tile(S, n, c0, t);
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
  // Tile t covers rows 4 (t >> 2).. and block columns 4 (t & 3)..; a round
  // of kThreads tiles holds whole rows, rounds go down the rows.
  for (int q = 1; q < P; ++q) {
    const int c0 = q * NB;
    const int nt = c0;  // c0 / 4 row groups x 4 column groups
    // U[0:c0, block] <- U[0:c0, block] W, W = V's diagonal block (upper)
    for (int t0 = 0; t0 < nt; t0 += kThreads) {
      const int t = t0 + tid;
      const int k0 = 4 * (t >> 2), cc = 4 * (t & 3);
      float acc[4][4];
      zero4x4(acc);
      if (t < nt) {
#pragma unroll 1
        for (int l0 = 0; l0 <= cc; l0 += 4) {
          float4 a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = ld4(S + rowoff(k0 + r, n) + c0 + l0);
            b[r] = ld4(S + rowoff(c0 + l0 + r, n) + c0 + cc);
          }
          mac4x4(acc, a, b);
        }
      }
      __syncthreads();  // every tile of the round has read its rows
      if (t < nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st4(S + rowoff(k0 + r, n) + c0 + cc,
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
    __syncthreads();
    // V[i][block] = -sum_{i <= k < c0} V[i][k] (U W)[k][block]: a tile reads
    // rows k >= its own, which no earlier round has overwritten. Two
    // neighbouring lanes share a tile, each taking every other k step, which
    // halves the longest tile (rows 0..3) that the round waits for.
    const int ni = 2 * nt;
    for (int t0 = 0; t0 < ni; t0 += kThreads) {
      const int it = t0 + tid, t = it >> 1, half = it & 1;
      const int i0 = 4 * (t >> 2), cc = 4 * (t & 3);
      float acc[4][4];
      zero4x4(acc);
      if (it < ni) {
#pragma unroll 1
        for (int k = i0 + 4 * half; k < c0; k += 8) {
          float4 a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = ld4(S + rowoff(i0 + r, n) + k);
            b[r] = ld4(S + rowoff(k + r, n) + c0 + cc);
          }
          mac4x4(acc, a, b);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], 1);
      __syncthreads();  // every tile of the round has read its rows
      if (it < ni && half == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st4(S + rowoff(i0 + r, n) + c0 + cc,
              make_float4(-acc[r][0], -acc[r][1], -acc[r][2], -acc[r][3]));
      }
    }
    __syncthreads();
  }

  // ---- 3. out = V V': out[a][b] = sum_{k >= max(a, b)} V[a][k] V[b][k] -----
  const int T = n / 4;
  const int ntiles = T * (T + 1) / 2;
  for (int t = tid; t < ntiles; t += kThreads) {
    int ta, tb;
    upper_tile(t, ta, tb);
    const int a0 = 4 * ta, b0 = 4 * tb;
    float acc[4][4];
    zero4x4(acc);
#pragma unroll 1
    for (int k = b0; k < n; k += 4) {
      float va[4][4], vb[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unpack(ld4(S + rowoff(a0 + r, n) + k), va[r]);
        unpack(ld4(S + rowoff(b0 + r, n) + k), vb[r]);
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

// The launch for n on the current device: smem dynamic shared bytes (0 when
// S lives in the scratch), scratch floats per matrix (0 when S is on chip),
// CTAs resident per SM (0: the launch does not fit).
struct Shape {
  int dev, n;
  size_t smem;
  long long scratch;
  int ctas;
};

// The one place that decides the layout: S on chip where n (n + 4) / 2
// floats fit one block's opt-in shared memory beside the kernel's static
// shared memory, else in a scratch buffer. Kept per (device, n), so a
// repeated launch makes none of these host calls again; on a device's first
// query the on-chip instance is allowed all the dynamic shared memory a
// block may opt in to (the occupancy follows the bytes each launch asks).
cudaError_t shape_for(int n, Shape* out) {
  static std::mutex mu;
  static std::vector<Shape> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool dev_known = false;
  for (const Shape& s : known) {
    if (s.dev == dev && s.n == n) {
      *out = s;
      return cudaSuccess;
    }
    dev_known = dev_known || s.dev == dev;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, spd_inverse_kernel<true>)) != cudaSuccess) return err;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  if (!dev_known) {
    err = cudaFuncSetAttribute(spd_inverse_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)room);
    if (err != cudaSuccess) return err;
  }
  Shape s = {dev, n, 0, 0, 0};
  const size_t bytes = (size_t)packed_floats(n) * sizeof(float);
  if (bytes <= room) {
    s.smem = bytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.ctas, spd_inverse_kernel<true>,
                                                        kThreads, bytes);
  } else {
    s.scratch = packed_floats(n);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.ctas, spd_inverse_kernel<false>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  known.push_back(s);
  *out = s;
  return cudaSuccess;
}

}  // namespace

// The launch spd_inverse_f32 makes for n on the current device: its dynamic
// shared memory in bytes, the scratch floats it needs per matrix (0: the
// working set is on chip, pass scratch = NULL) and the CTAs resident per SM.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue unless
// n % 16 == 0.
extern "C" int spd_inverse_shape(int n, int* smem_bytes, long long* scratch_floats,
                                 int* ctas_per_sm) {
  if (n <= 0 || n % NB != 0) return (int)cudaErrorInvalidValue;
  Shape s;
  const cudaError_t err = shape_for(n, &s);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)s.smem;
  *scratch_floats = s.scratch;
  *ctas_per_sm = s.ctas;
  return 0;
}

// C entry point: A and out are (batch, n, n) contiguous f32 device arrays,
// n % 16 == 0; scratch is NULL or a (batch, scratch_floats) f32 device buffer
// as spd_inverse_shape says. Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue if scratch does not match the shape,
// cudaErrorInvalidConfiguration if no CTA fits.
extern "C" int spd_inverse_f32(const float* A, float* out, float* scratch, int batch, int n,
                               cudaStream_t stream) {
  if (n <= 0 || n % NB != 0) return (int)cudaErrorInvalidValue;
  Shape s;
  cudaError_t err = shape_for(n, &s);
  if (err != cudaSuccess) return (int)err;
  if (s.ctas < 1) return (int)cudaErrorInvalidConfiguration;
  if ((s.scratch > 0) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  if (s.scratch == 0)
    spd_inverse_kernel<true><<<batch, kThreads, s.smem, stream>>>(A, out, nullptr, n);
  else
    spd_inverse_kernel<false><<<batch, kThreads, 0, stream>>>(A, out, scratch, n);
  return (int)cudaGetLastError();
}
