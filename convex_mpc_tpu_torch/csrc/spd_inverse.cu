// Batched SPD inverse for Hopper (sm_90a): M^-1 = U^-1 U^-T with M = U'U,
// one block per matrix.
//
// Replaces the TPU kernel convex_mpc_tpu/ops/chol_kernel.py::spd_inverse
// (_spd_inverse_kernel, _chol_unrolled, _tri_inv_neumann): the KKT
// factorization of the structured ADMM solver and the polish's reduced solve
// (n = 12 x horizon: 192 on the main path at horizon 16, 288 and 384 at
// horizons 24 and 32, 120 at horizon 10; B = 512 to 10,240).
//
// Any order: a matrix of order na runs on the 16-row panel grid
// n = 16 ceil(na / 16) (n = 128 at na = 120). The load fills the packed
// triangle with A where i, j < na and with the identity in the pad rows and
// columns; the phases below run unchanged at n; the store writes the
// na x na block alone. diag(A, I)^-1 = diag(A^-1, I), and every product
// that couples A's rows with the pad's is of exact zeros, so the block is
// what an order-na schedule would give; the pad's pivots are 1, so a
// matrix that is not SPD still turns wholly NaN. The pad costs n^3 - na^3
// operations a matrix (17.6% of the work at na = 120); phase 3 skips the
// tiles of the pad and the pad's columns of V (exact zeros in A's rows).
// An order that is no multiple of 4 (rows off the 16-byte grid, never a
// port's n = 12 x horizon) runs the device-memory scratch instance.
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
// `bad` flag, S lives there from load to store (spd_inverse_kernel<true>).
// Above (n >= 352: 297,984 B at n = 384) S is split between the two CTAs of
// a thread-block cluster, one cluster per matrix (spd_inverse_cluster_kernel,
// below): rank r holds the 16-row panels p with p % 2 == r, in rowoff's
// order within each (half_rowoff), beside two staging slots of 16 n floats
// and a copy of the peer's 16 x 16 diagonal blocks. At n = 384 rank 0's
// half is 155,136 B (rank 1's 142,848 B), the slots 49,152 B and the blocks
// 12,288 B: 216,576 B a CTA, one 512-thread CTA per SM (on an H100, 256
// threads took 4.8% longer: tools/torch_spd_variants.py `t256`). Where that
// does not fit either (n >= 416) the one-CTA code runs on a device-memory
// scratch of n (n + 4) / 2 floats per matrix (spd_inverse_kernel<false>).
// The up to 3 entries left of the diagonal that a packed row keeps are set to
// 0 when its diagonal block is inverted, so no later phase masks them.
// shape_for() alone decides the instance and the launch, by these byte
// counts; spd_inverse_shape() reports it to the wrapper.
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
//
// The cluster instance runs the same tiles, each by the CTA that holds its
// output rows, with the same sums in the same order; values cross between
// the two CTAs only where a phase needs the peer's rows:
//  1. the holder of panel q updates its rows from panel q - 1 (staged, see
//     below; warp 0 first the diagonal block, which it then inverts, while
//     the other warps also update its later panels from panel q - 1), forms
//     the panel product and pushes the finished rows (columns c1..n-1) into
//     a staging slot of the peer with st.async, counted on the slot's
//     mbarrier; then it updates its later panels from panel q. The peer
//     meanwhile updates its own rows; the chain of diagonal block, panel
//     product and push runs on one CTA at a time. Received panels alternate
//     between the two slots: the peer sends into a slot again only after
//     it has received a panel that this CTA sent after its last read of it.
//     A non-SPD pivot runs phase 1 to its end; then each CTA stores its
//     `bad` flag into the peer and, after one cluster barrier, both write
//     NaN over their rows of the output;
//  2. per block column q each CTA forms the strip (U W_q) for its own rows
//     (W_q from its panel, or from the copy of the peer's diagonal blocks
//     taken after phase 1), stores it into slot q % 2 and pushes it into the
//     peer's; both then hold the whole strip, a snapshot, so -V (U W_q) is
//     written in place without rounds;
//  3. after a cluster barrier (the peer's V is complete), tiles whose two
//     row groups are both local, then, panel by panel, the peer's rows
//     copied into a slot with distributed-shared-memory loads and the tiles
//     (local row group, peer row group); a last cluster barrier keeps each
//     CTA's shared memory alive while its peer copies from it.
// Four cluster barriers a matrix: after the load, on the `bad` flag, before
// phase 3 and before exit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

#include "cluster_push.cuh"

namespace cg = cooperative_groups;
using namespace cluster_push;

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

// elements (i, j..j+3), j % 4 == 0, of A (order na, row stride na) padded
// with the identity: A's where i, j < na. Where na % 4 == 0 (kAligned: the
// caller's promise) every row starts on a 16-byte boundary and a group of 4
// columns lies wholly inside A or wholly in the pad.
template <bool kAligned>
__device__ __forceinline__ float4 ld4_padded(const float* Ab, int na, int i, int j) {
  if (kAligned || (na & 3) == 0) {
    if (i < na && j < na) return ld4(Ab + (size_t)i * na + j);
    return make_float4(i == j, i == j + 1, i == j + 2, i == j + 3);
  }
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    x[c] = (i < na && j + c < na) ? Ab[(size_t)i * na + j + c] : (i == j + c ? 1.0f : 0.0f);
  return make_float4(x[0], x[1], x[2], x[3]);
}

// v into elements (i, j..j+3), j % 4 == 0, of out (order na), those with
// i, j + c < na (kAligned: na % 4 == 0)
template <bool kAligned>
__device__ __forceinline__ void st4_clipped(float* Ob, int na, int i, int j, float4 v) {
  if (i >= na || j >= na) return;
  float* p = Ob + (size_t)i * na + j;
  if (kAligned || (na & 3) == 0) {
    st4(p, v);
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (j + c < na) p[c] = x[c];
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

// Rank r of a cluster of 2 holds the 16-row panels p with p % 2 == r, each
// in rowoff's order: element (i, j) of a row it holds is
// S[half_rowoff(i, n, r) + j] of its half. Panel p is 16 n - 256 p - 96
// floats; k = p / 2 of the rank's panels come before it.
__host__ __device__ __forceinline__ int half_rowoff(int i, int n, int r) {
  const int p = i >> 4, k = p >> 1, g = i >> 2, gl = g & 3;
  return k * (16 * n - 96 - 256 * r) - 256 * k * (k - 1) + 4 * gl * (n - 16 * p) -
         8 * gl * (gl - 1) + (i & 3) * (n - 4 * g) - 4 * g;
}

// floats of rank r's half: its (n / 16 + 1 - r) / 2 panels
__host__ __device__ __forceinline__ int half_floats(int n, int r) {
  const int k = (n / NB + 1 - r) / 2;
  return k * (16 * n - 96 - 256 * r) - 256 * k * (k - 1);
}

// dynamic shared floats of a cluster CTA: rank 0's half (the larger), two
// staging slots of 16 n floats and the peer's diagonal blocks, 256 floats each
__host__ __device__ __forceinline__ int cluster_floats(int n) {
  return half_floats(n, 0) + 32 * n + 256 * ((n / NB + 1) / 2);
}

// Row accessors: rows(i) + j addresses element (i, j).
struct Packed {  // the whole triangle (rowoff)
  float* S;
  int n;
  __device__ __forceinline__ float* operator()(int i) const { return S + rowoff(i, n); }
};
struct Half {  // rank r's panels (half_rowoff), S[0] at float `off` of the half
  float* S;
  int n, r, off;
  __device__ __forceinline__ float* operator()(int i) const {
    return S + (half_rowoff(i, n, r) - off);
  }
};
struct Staged {  // the 16 rows of a panel from row c0 on, `stride` floats apart
  float* S;
  int c0, stride;
  __device__ __forceinline__ float* operator()(int i) const { return S + (i - c0) * stride; }
};

// Warp 0: the 16 x 16 diagonal block at (c0, c0). Lane s holds column s of
// it in registers; Cholesky U_pp, then W = U_pp^-1 from W U_pp = I column by
// column, left to right (lane k finishes column k of W and broadcasts it by
// shuffles to the lanes right of it; each step needs the one before, which
// keeps the shuffled values from piling up in registers); W's upper triangle
// replaces the block, with 0 where a packed row keeps entries left of the
// diagonal. Sets *bad on a pivot that is not > 0.
template <class Rows>
__device__ __forceinline__ void invert_diag_block(Rows rows, int c0, int lane, int* bad) {
  float col[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    col[r] = 0.0f;
    if (lane < NB && r <= lane) col[r] = rows(c0 + r)[c0 + lane];
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
      if ((i & ~3) <= lane) rows(c0 + i)[c0 + lane] = w[i];
  }
}

// Trailing update of the 4 x 4 tile at (a0, b0) from the 16 rows of the
// panel at c0 (read through `src`, written through `dst`):
// M[a][b] -= sum_m U[c0 + m][a] U[c0 + m][b].
template <class Src, class Dst>
__device__ __forceinline__ void update_tile(Src src, Dst dst, int c0, int a0, int b0) {
  float acc[4][4];
  zero4x4(acc);
  // fully unrolled, the hoisted loads would spill at 80 registers
#pragma unroll 4
  for (int m = 0; m < NB; ++m) {
    const float* row = src(c0 + m);
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
    float* rp = dst(a0 + r) + b0;
    float4 v = ld4(rp);
    v.x -= acc[r][0];
    v.y -= acc[r][1];
    v.z -= acc[r][2];
    v.w -= acc[r][3];
    st4(rp, v);
  }
}

// Trailing update of upper tile t (upper_tile order) right of panel c0.
__device__ __forceinline__ void trailing_tile(Packed S, int c0, int t) {
  int ta, tb;
  upper_tile(t, ta, tb);
  update_tile(S, S, c0, c0 + NB + 4 * ta, c0 + NB + 4 * tb);
}

// out[a][b] = sum_{b0 <= k < kend} V[a][k] V[b][k] for the tile at (a0, b0),
// a0 <= b0, stored with its mirror straight to device memory (order na);
// nothing for a tile of the pad (b0 >= na). V's columns from kend = 4
// ceil(na / 4) on are the pad's: zero in the rows that are stored.
template <bool kAligned, class RA, class RB>
__device__ __forceinline__ void vv_tile(RA ra, RB rb, int kend, int na, int a0, int b0,
                                        float* Ob) {
  if (b0 >= na) return;
  float acc[4][4];
  zero4x4(acc);
#pragma unroll 1
  for (int k = b0; k < kend; k += 4) {
    float va[4][4], vb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      unpack(ld4(ra(a0 + r) + k), va[r]);
      unpack(ld4(rb(b0 + r) + k), vb[r]);
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
    st4_clipped<kAligned>(Ob, na, a0 + r, b0,
                          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    st4_clipped<kAligned>(Ob, na, b0 + r, a0,
                          make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]));
  }
}

// kShared: S in dynamic shared memory, and na % 4 == 0; otherwise S is this
// block's packed_floats(n) slice of `scratch`, and na any order. A and out
// are of order na <= n, the panel grid's order (the pad in the header).
template <bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                   float* __restrict__ scratch, int na, int n) {
  extern __shared__ __align__(16) float smem[];
  float* S = kShared ? smem : scratch + (size_t)blockIdx.x * packed_floats(n);
  const Packed rows{S, n};
  __shared__ int bad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * na * na;
  const float* Ab = A + base;
  float* Ob = out + base;
  const int n4 = n / 4;

  // the packed upper triangle of A, unrolled so that several loads are in
  // flight, then its pad. Without a pad, the plain 16-byte loads alone (a
  // test per element cost 4% at n = 288 on an H100); with one and na % 4 ==
  // 0, A's rows by 16-byte loads and the pad's columns (j >= na: rows
  // i < na hold zeros there, rows i >= na the identity) by a loop of their
  // own (16% faster than a test per element at na = 120).
  if (na == n) {
#pragma unroll 4
    for (int e = tid; e < n * n4; e += kThreads) {
      const int i = e / n4, j4 = e - i * n4;
      if (j4 >= (i >> 2)) st4(S + rowoff(i, n) + 4 * j4, ld4(Ab + 4 * (size_t)e));
    }
  } else if (kShared) {
    const int na4 = na / 4, pc = (n - na) / 4;
#pragma unroll 4
    for (int e = tid; e < na * na4; e += kThreads) {
      const int i = e / na4, j4 = e - i * na4;
      if (j4 >= (i >> 2)) st4(S + rowoff(i, n) + 4 * j4, ld4(Ab + 4 * (size_t)e));
    }
    for (int e = tid; e < n * pc; e += kThreads) {
      const int i = e / pc, j = na + 4 * (e - i * pc);
      if ((j >> 2) >= (i >> 2)) st4(S + rowoff(i, n) + j, ld4_padded<true>(Ab, na, i, j));
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < n * n4; e += kThreads) {
      const int i = e / n4, j4 = e - i * n4;
      if (j4 >= (i >> 2)) st4(S + rowoff(i, n) + 4 * j4, ld4_padded<false>(Ab, na, i, 4 * j4));
    }
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  // ---- 1. blocked Cholesky, M = U'U, W = U_pp^-1 on each diagonal block ----
  const int P = n / NB;
  if (warp == 0) invert_diag_block(rows, 0, lane, &bad);
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
        if (lane < 10) trailing_tile(rows, c0, lane);
        __syncwarp();
        invert_diag_block(rows, c1, lane, &bad);
      }
    } else {
      for (int t = 10 + tid - 32; t < ntiles; t += kThreads - 32) trailing_tile(rows, c0, t);
    }
    __syncthreads();
  }

  if (bad) {
    const int na4 = (na + 3) / 4;
    const float qnan = __int_as_float(0x7fc00000);
    const float4 q4 = make_float4(qnan, qnan, qnan, qnan);
    for (int e = tid; e < na * na4; e += kThreads) {
      const int i = e / na4;
      st4_clipped<kShared>(Ob, na, i, 4 * (e - i * na4), q4);
    }
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
  // (the upper tiles of A's rows, the pad's come last in upper_tile order)
  const int na4 = (na + 3) / 4;
  const int ntiles = na4 * (na4 + 1) / 2;
  for (int t = tid; t < ntiles; t += kThreads) {
    int ta, tb;
    upper_tile(t, ta, tb);
    vv_tile<kShared>(rows, rows, 4 * na4, na, 4 * ta, 4 * tb, Ob);
  }
}

// ---- the cluster instance: S split between the two CTAs of a cluster -----

constexpr int kClusterThreads = 512;

// One matrix per cluster of 2 (blocks 2 b and 2 b + 1), of order na <= n,
// the panel grid's order, na % 4 == 0. The schedule is in the header; the
// numbered comments follow it.
template <int NT>
__global__ void __launch_bounds__(NT, 1)
spd_inverse_cluster_kernel(const float* __restrict__ A, float* __restrict__ out, int na,
                           int n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long sbar[2];  // one per staging slot
  __shared__ int bad, peer_bad;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), peer = r ^ 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = n / NB, G = n / 4, n4 = n / 4;
  const int K = (P + 1 - r) / 2, Kp = (P + 1 - peer) / 2;  // panels here and in the peer
  const size_t base = (size_t)(blockIdx.x >> 1) * na * na;
  const float* Ab = A + base;
  float* Ob = out + base;
  float* stage = smem + half_floats(n, 0);  // slot s: stage + 16 n s
  float* wpeer = stage + 32 * n;            // the peer's diagonal blocks, 16 x 16 each
  const Half mine{smem, n, r, 0};
  // row group gi of this CTA's 4 K: rows 4 grp(gi) .. 4 grp(gi) + 3
  auto grp = [&](int gi) { return 4 * (r + 2 * (gi >> 2)) + (gi & 3); };

  const uint32_t bar0 = smem_u32(&sbar[0]);
  const uint32_t peer_stage = map_rank(smem_u32(stage), peer), peer_bar0 = map_rank(bar0, peer);
  uint32_t parity = 0;  // bit s: the parity of the next wait on slot s
  // wait until `bytes` pushed by the peer have landed in slot s
  auto receive = [&](int s, uint32_t bytes) {
    if (tid == 0) bar_arm(bar0 + 8 * s, bytes);
    bar_wait(bar0 + 8 * s, (parity >> s) & 1);
    parity ^= 1u << s;
  };
  // v into the peer's slot s at float `off`
  auto push = [&](int s, int off, float4 v) {
    st_async4(peer_stage + 4u * (16 * n * s + off), v, peer_bar0 + 8 * s);
  };

  // this CTA's panels of A (and of its pad, as the one-CTA kernel's load)
  if (na == n) {
#pragma unroll 4
    for (int e = tid; e < 16 * K * n4; e += NT) {
      const int il = e / n4, j4 = e - il * n4;
      const int i = 16 * (r + 2 * (il >> 4)) + (il & 15);
      if (j4 >= (i >> 2)) st4(mine(i) + 4 * j4, ld4(Ab + (size_t)i * n + 4 * j4));
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < 16 * K * n4; e += NT) {
      const int il = e / n4, j4 = e - il * n4;
      const int i = 16 * (r + 2 * (il >> 4)) + (il & 15);
      if (j4 >= (i >> 2)) st4(mine(i) + 4 * j4, ld4_padded<true>(Ab, na, i, 4 * j4));
    }
  }
  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    bar_init_fence();
    bad = 0;
  }
  cluster.sync();  // both halves loaded, both CTAs' barriers exist

  // ---- 1. blocked Cholesky over this CTA's panels q ------------------------
  int sent = 0, got = 0;
  for (int q = r; q < P; q += 2) {
    const int c0 = q * NB, c1 = c0 + NB;
    Staged prev{stage, c0 - NB, n};  // panel q - 1, pushed by the peer
    // this CTA's later panels q + 2, q + 4, .. from the panel at cs, read
    // through src, by threads t, t + stride, ..: tile t of panel pa is row
    // group 4 pa + (t & 3), column group 4 pa + (t >> 2)
    auto later = [&](auto src, int cs, int t, int stride) {
      for (int pa = q + 2; pa < P;) {
        const int cnt = 4 * (G - 4 * pa);
        if (t >= cnt) {
          t -= cnt;
          pa += 2;
          continue;
        }
        const int ga = 4 * pa + (t & 3), gb = 4 * pa + (t >> 2);
        if (gb >= ga) update_tile(src, mine, cs, 4 * ga, 4 * gb);
        t += stride;
      }
    };
    if (q > 0) {
      const int s = got++ & 1;
      receive(s, 64u * (n - c0));
      prev.S = stage + 16 * n * s;
      // panel q's rows from panel q - 1: warp 0 the diagonal block, which it
      // then inverts; meanwhile the other warps the columns right of it and
      // the later panels from panel q - 1
      if (warp == 0) {
        if (lane < 10) {
          int ta, tb;
          upper_tile(lane, ta, tb);
          update_tile(prev, mine, c0 - NB, c0 + 4 * ta, c0 + 4 * tb);
        }
        __syncwarp();
        invert_diag_block(mine, c0, lane, &bad);
      } else {
        const int nt = 4 * ((n - c1) / 4);
        for (int t = tid - 32; t < nt; t += NT - 32)
          update_tile(prev, mine, c0 - NB, c0 + 4 * (t & 3), c1 + 4 * (t >> 2));
        later(prev, c0 - NB, tid - 32, NT - 32);
      }
    } else if (warp == 0) {
      invert_diag_block(mine, 0, lane, &bad);
    }
    __syncthreads();
    // the panel product, as the one-CTA kernel's, each finished tile also
    // pushed into the peer's next slot
    const int ntp = n - c1, s_out = sent & 1;
    for (int t0 = 0; t0 < ntp; t0 += NT) {
      const int t = t0 + tid;
      const int r0 = 4 * (t & 3), j0 = c1 + 4 * (t >> 2);
      float acc[4][4];
      zero4x4(acc);
      if (t < ntp) {
#pragma unroll 1
        for (int m = 0; m < r0 + 4; ++m) {
          const float* row = mine(c0 + m);
          float w[4], x[4];
          unpack(ld4(row + c0 + r0), w);
          unpack(ld4(row + j0), x);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[rr][c] += w[rr] * x[c];
        }
      }
      __syncthreads();  // every tile of the round has read its column strip
      if (t < ntp) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float4 v = make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
          st4(mine(c0 + r0 + rr) + j0, v);
          push(s_out, (r0 + rr) * n + j0, v);
        }
      }
    }
    if (ntp > 0) ++sent;
    __syncthreads();
    later(mine, c0, tid, NT);  // the later panels from panel q
    __syncthreads();
  }

  // both CTAs learn whether either met a pivot that is not > 0
  if (tid == 0) *cluster.map_shared_rank(&peer_bad, peer) = bad;
  cluster.sync();
  if (bad || peer_bad) {
    const float qnan = __int_as_float(0x7fc00000);
    const float4 q4 = make_float4(qnan, qnan, qnan, qnan);
    for (int e = tid; e < 16 * K * n4; e += NT) {
      const int il = e / n4, j4 = e - il * n4;
      st4_clipped<true>(Ob, na, 16 * (r + 2 * (il >> 4)) + (il & 15), 4 * j4, q4);
    }
    return;  // the peer reads nothing of this CTA from here on
  }

  // ---- 2. V = U^-1 in place, 16-column blocks left to right ---------------
  // the peer's diagonal blocks W, which no phase writes again
  const Half theirs{cluster.map_shared_rank(smem, peer), n, peer, 0};
  for (int e = tid; e < 64 * Kp; e += NT) {
    const int pk = e >> 6, i = (e >> 2) & 15, l4 = e & 3, c0 = NB * (peer + 2 * pk);
    if (l4 >= (i >> 2)) st4(wpeer + 256 * pk + 16 * i + 4 * l4, ld4(theirs(c0 + i) + c0 + 4 * l4));
  }
  __syncthreads();
  for (int q = 1; q < P; ++q) {
    const int c0 = q * NB, s = q & 1;
    const int rows = NB * ((q + 1 - r) / 2), peer_rows = NB * ((q + 1 - peer) / 2);
    float* strip = stage + 16 * n * s;  // strip[16 k + c] = (U W_q)[k][c], k < c0
    const bool own_w = (q & 1) == r;
    const float* wq = wpeer + 256 * (q >> 1);
    // (U W_q) for this CTA's rows k < c0: tile t = rows 4 grp(t >> 2).., block
    // columns 4 (t & 3)..
    for (int t = tid; t < rows; t += NT) {
      const int k0 = 4 * grp(t >> 2), cc = 4 * (t & 3);
      float acc[4][4];
      zero4x4(acc);
#pragma unroll 1
      for (int l0 = 0; l0 <= cc; l0 += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          a[rr] = ld4(mine(k0 + rr) + c0 + l0);
          b[rr] = ld4((own_w ? mine(c0 + l0 + rr) + c0 : wq + 16 * (l0 + rr)) + cc);
        }
        mac4x4(acc, a, b);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 v = make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
        st4(strip + 16 * (k0 + rr) + cc, v);
        push(s, 16 * (k0 + rr) + cc, v);
      }
    }
    if (peer_rows > 0) receive(s, 64u * peer_rows);
    __syncthreads();  // the whole strip is here
    // V[i][block] = -sum_{i <= k < c0} V[i][k] (U W_q)[k][block] for this
    // CTA's rows i < c0, two neighbouring lanes a tile
    const int ni = 2 * rows;
    for (int t0 = 0; t0 < ni; t0 += NT) {
      const int it = t0 + tid, t = it >> 1, half = it & 1;
      const int i0 = 4 * grp(t >> 2), cc = 4 * (t & 3);
      float acc[4][4];
      zero4x4(acc);
      if (it < ni) {
#pragma unroll 1
        for (int k = i0 + 4 * half; k < c0; k += 8) {
          float4 a[4], b[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            a[rr] = ld4(mine(i0 + rr) + k);
            b[rr] = ld4(strip + 16 * (k + rr) + cc);
          }
          mac4x4(acc, a, b);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[rr][c] += __shfl_xor_sync(kFull, acc[rr][c], 1);
      if (it < ni && half == 0) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          st4(mine(i0 + rr) + c0 + cc,
              make_float4(-acc[rr][0], -acc[rr][1], -acc[rr][2], -acc[rr][3]));
      }
    }
    __syncthreads();
  }

  // ---- 3. out = V V' --------------------------------------------------------
  cluster.sync();  // the peer's V is complete
  const int gm = 4 * K, nt = gm * (gm + 1) / 2, kend = (na + 3) & ~3;
  for (int t = tid; t < nt; t += NT) {
    int ta, tb;
    upper_tile(t, ta, tb);
    vv_tile<true>(mine, mine, kend, na, 4 * grp(ta), 4 * grp(tb), Ob);
  }
  // the tiles (row group here, row group of the peer's panel pb), the
  // panel's packed rows first copied into slot 0
  for (int pb = peer; pb < P; pb += 2) {
    const int ra = 4 * ((pb + 1 - r) / 2);  // this CTA's row groups above panel pb
    if (ra == 0) continue;
    const int first = half_rowoff(NB * pb, n, peer) + NB * pb, len = 16 * n - 256 * pb - 96;
    __syncthreads();  // the slot's previous panel is read
#pragma unroll 4
    for (int e = 4 * tid; e < len; e += 4 * NT) st4(stage + e, ld4(theirs.S + first + e));
    __syncthreads();
    const Half panel{stage, n, peer, first};
    for (int t = tid; t < 4 * ra; t += NT)
      vv_tile<true>(mine, panel, kend, na, 4 * grp(t % ra), 4 * (4 * pb + t / ra), Ob);
  }
  cluster.sync();  // the peer has copied what it reads of this CTA
}

// The launch for grid order n (and orders that are multiples of 4 or not:
// `aligned`) on the current device: smem dynamic shared bytes per CTA (0
// when S lives in the scratch), scratch floats per matrix (0 when S is on
// chip), resident (CTAs per SM for one CTA a matrix, clusters on the device
// for a cluster; 0: the launch does not fit) and csize, the CTAs a matrix
// (1 or 2).
struct Shape {
  int dev, n;
  bool aligned;
  size_t smem;
  long long scratch;
  int resident, csize;
};

// The one place that decides the instance: S on chip in one CTA where
// n (n + 4) / 2 floats fit one block's opt-in shared memory beside the
// kernel's static shared memory; else split over a cluster of 2 where
// cluster_floats(n) fit a CTA beside the cluster kernel's; else in a
// scratch buffer. Byte counts alone decide: a cluster shape that fits them
// but of which no cluster is resident is refused at launch, not moved to
// the scratch. An order that is no multiple of 4 (unaligned rows) runs the
// scratch instance at every n: the on-chip instances take aligned rows
// alone, since the unaligned loads and stores cost the one-CTA instance a
// spilled register and 2-4% of its time at n = 192 and 288 on an H100.
// Kept per (device, n, aligned), so a repeated launch makes none of
// these host calls again; on a device's first query the one-CTA on-chip
// instance is allowed all the dynamic shared memory a block may opt in to
// (the occupancy follows the bytes each launch asks; resident_clusters
// raises the cluster kernel's limit to its shape).
cudaError_t shape_for(int n, bool aligned, Shape* out) {
  static std::mutex mu;
  static std::vector<Shape> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool dev_known = false;
  for (const Shape& s : known) {
    if (s.dev == dev && s.n == n && s.aligned == aligned) {
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
  auto cluster_kernel = spd_inverse_cluster_kernel<kClusterThreads>;
  cudaFuncAttributes fc;
  if ((err = cudaFuncGetAttributes(&fc, cluster_kernel)) != cudaSuccess) return err;
  Shape s = {dev, n, aligned, 0, 0, 0, 1};
  const size_t bytes = (size_t)packed_floats(n) * sizeof(float);
  const size_t cbytes = (size_t)cluster_floats(n) * sizeof(float);
  if (aligned && bytes <= room) {
    s.smem = bytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.resident, spd_inverse_kernel<true>,
                                                        kThreads, bytes);
  } else if (aligned && cbytes + fc.sharedSizeBytes <= (size_t)optin) {
    s.smem = cbytes;
    s.csize = 2;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(1, 2, kClusterThreads, cbytes, nullptr, &attr);
    err = resident_clusters(cluster_kernel, cfg, &s.resident);
  } else {
    s.scratch = packed_floats(n);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.resident, spd_inverse_kernel<false>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  known.push_back(s);
  *out = s;
  return cudaSuccess;
}

}  // namespace

// The panel grid's order for a matrix of order n: n rounded up to a multiple
// of 16 (the pad in the header).
constexpr int grid_order(int n) { return (n + NB - 1) / NB * NB; }

// The launch spd_inverse_f32 makes for n on the current device, at the
// panel grid's order: its dynamic shared memory in bytes per CTA, the
// scratch floats it needs per matrix (0: the working set is on chip, pass
// scratch = NULL), how many are resident (CTAs per SM for one CTA a matrix,
// clusters on the device for a cluster) and the CTAs a matrix (1, or 2 for
// a cluster). Returns a cudaError_t (0 on success); cudaErrorInvalidValue
// unless n > 0.
extern "C" int spd_inverse_shape(int n, int* smem_bytes, long long* scratch_floats,
                                 int* resident, int* csize) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Shape s;
  const cudaError_t err = shape_for(grid_order(n), n % 4 == 0, &s);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)s.smem;
  *scratch_floats = s.scratch;
  *resident = s.resident;
  *csize = s.csize;
  return 0;
}

// C entry point: A and out are (batch, n, n) contiguous f32 device arrays,
// any n > 0; scratch is NULL or a (batch, scratch_floats) f32 device buffer
// as spd_inverse_shape says. Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue if scratch does not match the shape,
// cudaErrorInvalidConfiguration if no CTA or no cluster fits.
extern "C" int spd_inverse_f32(const float* A, float* out, float* scratch, int batch, int n,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int ng = grid_order(n);
  Shape s;
  cudaError_t err = shape_for(ng, n % 4 == 0, &s);
  if (err != cudaSuccess) return (int)err;
  if (s.resident < 1) return (int)cudaErrorInvalidConfiguration;
  if ((s.scratch > 0) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  if (s.csize == 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(batch, 2, kClusterThreads, s.smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, spd_inverse_cluster_kernel<kClusterThreads>, A, out, n, ng);
    if (err != cudaSuccess) return (int)err;
  } else if (s.scratch == 0) {
    spd_inverse_kernel<true><<<batch, kThreads, s.smem, stream>>>(A, out, nullptr, n, ng);
  } else {
    spd_inverse_kernel<false><<<batch, kThreads, 0, stream>>>(A, out, scratch, n, ng);
  }
  return (int)cudaGetLastError();
}
