// Dense-A ADMM iterations for Hopper (sm_90a): `iters` over-relaxed ADMM
// steps per scenario against a dense constraint matrix A, one thread-block
// cluster of 8 CTAs (16 at the largest shape) per scenario, Minv held on
// chip across it and A too where its rows fit, else streamed through a TMA
// ring (below: "Where the rows live").
//
// Replaces the TPU kernel convex_mpc_tpu/mpc/kernels.py::admm_iterations
// (_kernel), the iteration engine of the legacy fixed-segment solver
// admm.solve (mpc_cycle_fixed; B = 512, A (448, 192), Minv (192, 192) at
// horizon 16, up to A (1280, 768) on the full form at horizon 32). The plain
// PyTorch version is mpc/kernels.py::admm_iterations_plain.
//
// Per iteration: t = rho z - y; rhs = (sigma x - q) + A' t; xt = Minv rhs;
// x <- alpha xt + (1 - alpha) x; ax = alpha A xt + (1 - alpha) z;
// z <- clip(ax + y / rho, l, u) with true division, and y / rho = 0 on rows
// with rho = 0 (the TPU kernel's inert-padding rule); y <- y + rho (ax - z).
//
// What bounds it on this card. Per 25-iteration chunk at B = 512, m = 448,
// n = 192: 25 x (2 x 2mn + 2n^2) flops = 5.4 GFLOP, 0.081 ms at 67 TFLOP/s
// f32; reading A and Minv once is 252 MB, 0.075 ms at 3.35 TB/s. So the
// bound is ~0.08 ms, set by operations.
//
// The earlier design (one 512-thread block per scenario, Minv in its shared
// memory, A streamed from device memory twice per iteration: 8.8 GB per
// chunk) took 7.2566 ms per 25 iterations, slower than three torch.bmm
// GEMVs per iteration (6.1412 ms) (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): with one ~165 KB block per SM too few loads were in flight,
// and A' t ran one thread per column down a 448-long chain.
//
// This design. A scenario's working set, A + Minv + vectors ~ 501 KB, is
// more than one SM's 227 KB but fits a cluster: CTA r of C keeps rows
// [r m/C, (r+1) m/C) of A and [r n/C, (r+1) n/C) of Minv in its shared
// memory, loaded from device memory once per chunk. Per iteration:
//  1. each CTA forms its partial A_r' t over its rows: a thread per 4
//     columns and row group (10 groups at n = 192), float4 loads, then a
//     sum over the groups. CTA c owns columns [c s, (c + 1) s) of rhs,
//     s = ceil(n / C): each column of the partial is sent by st.async into
//     slot r of its owner only;
//  2. each CTA waits for its columns of the C partials (an mbarrier
//     counting their bytes), sums them in rank order, adds sigma x - q, and
//     sends its columns of rhs into every CTA's whole rhs;
//  3. each CTA waits for rhs, computes its rows of xt = Minv rhs (8 lanes
//     per row, lane l sending the row's entry to CTA l) and sends them into
//     every CTA's whole xt;
//  4. each CTA waits for xt, updates x, and computes A_r xt (8 lanes per
//     row), the relaxation, projection and dual step for its rows, and t
//     for the next iteration.
// Every column of rhs is summed once, by its owner, in rank order, so every
// CTA gets the same rhs. The partials, rhs and xt land in double-buffered
// slots, so no cluster-wide barrier is needed per iteration: a CTA waits
// only for the bytes it reads (a first version with two cluster.sync() per
// iteration took 2.04-2.10 ms in clusters of 8).
//
// Arithmetic, cluster of 4 (m/4 = 112 rows of A, 86,016 B; n/4 = 48 rows of
// Minv, 36,864 B; ~143 KB per CTA, one CTA per SM): 30 clusters, i.e.
// scenarios, in flight on 132 SMs (cudaOccupancyMaxActiveClusters), 17
// waves at B = 512. Shared memory read per CTA per iteration: 2 x 86 KB +
// 37 KB = 209 KB, ~1,630 cycles at 128 B per cycle (~0.9 us), plus the
// waits: ~1.5 us per iteration, ~0.7 ms per 25 iterations at B = 512.
// Cluster of 8 (56 + 24 rows, ~87 KB per CTA, two CTAs per SM): the same
// 30 scenarios in flight, half the shared-memory reads per CTA. Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, 25 iterations, B = 512):
// 1.5176 ms in clusters of 8 and 1.5755 ms in clusters of 4, against
// 5.3118 ms for torch.bmm and the 0.0811 ms bound. So this file launches
// clusters of 8 wherever Minv's rows fit them.
//
// The owners' gather (step 2) replaced an exchange in which every CTA
// received every CTA's whole partial (2 x 8 x n floats of slots) and summed
// all n columns itself: 12 n more floats, one wait fewer. That layout does
// not fit the full-form QP (formulation="full", nz = 24 N, m = 40 N) at
// horizon 16, A (640, 384): 80 + 48 rows of 384 and 25 x 384 + 480 floats
// more, 238,464 B, above the 232,448 B one CTA may have. The gather needs
// 218,496 B there (one CTA per SM) and 76,608 B at A (448, 192) (two).
// Measured (kernel_times.py, NVIDIA H100 80GB HBM3, 700.00 W, B = 512, 25
// iterations): 1.4775 ms at A (448, 192), against 1.5103-1.5223 ms for the
// whole-partial exchange, and 4.2834 ms at A (640, 384).
//
// Where the rows live. The kernel is one template, `admm_dense_kernel<P, C, V>`,
// over where the loops read each CTA's rows of A and of Minv (P), the CTAs
// per cluster (C) and, for kRing, the float4s of a row each lane holds (V):
//  P = kOnChip:     A and Minv rows in shared memory, as above (C = 8);
//  P = kRing:       Minv rows in shared memory; A's rows stream through a
//                   ring of 16 one-row slots in shared memory, one per warp,
//                   each row one TMA bulk copy (cp.async.bulk, completed on
//                   the slot's mbarrier with its bytes), read once an
//                   iteration (C = 8 or 16; n <= 128 V);
//  P = kStreamBoth: both read in place from device memory (float4 __ldg),
//                   for shapes no ring fits (none of the legacy paths').
// The launcher takes the first of (kOnChip, 8), (kRing, 8, 3), (kRing, 8,
// 6), (kRing, 16, 6), (kStreamBoth, 8) that takes n and whose shared bytes
// (smem_floats) fit one CTA with a cluster resident: shape arithmetic, no
// timing. By shape (horizon N: condensed A (28 N, 12 N), full form A (40 N,
// 24 N)):
//   A (280, 120), (448, 192), (672, 288), (640, 384): kOnChip, 36,840 /
//     76,608 / 157,536 / 218,496 B a CTA;
//   A (896, 384) (condensed, horizon 32): kRing, 8 CTAs, V = 3, 113,280 B,
//     two CTAs per SM;
//   A (960, 576) (full, horizon 24): kRing, 8 CTAs, V = 6, 224,064 B, one
//     CTA per SM;
//   A (1280, 768) (full, horizon 32): kRing, 16 CTAs (a non-portable
//     cluster: Minv's 96 rows of 768 a CTA of 8 are 294,912 B, its 48 rows
//     a CTA of 16 147,456 B), V = 6, 223,104 B, one CTA per SM: 7 clusters
//     resident on the H100.
//
// The ring pass. A launch of k iterations makes k + 1 passes over each
// CTA's rows of A: a prologue pass forms iteration 0's partial A_r' t, and
// the pass of iteration it runs step 5 on each row (A xt, the relaxation,
// projection and dual step, the row's new t) and then adds the same row's
// share of iteration it + 1's partial A_r' t; the last iteration's pass
// forms no partial. Where the other instances read A twice an iteration
// (steps 1 and 5), the ring reads it once: 11 passes instead of 20 in the
// legacy solver's 10-iteration launches. Warp w takes the CTA's rows w, w +
// 16, ... from its slot: it waits for the slot's barrier, copies the row
// into registers (V float4s a lane), and its lane 0 at once asks for the
// warp's next row, which is in flight while the warp forms the row's dot
// product with xt (lanes over columns, a butterfly), the row update (in
// every lane, lane 0 storing z and y) and its partial A' t, n floats held in
// registers (V float4s a lane) across the pass. No block barrier falls
// inside a pass. At its end each warp stores its partial in its own slot,
// step 2 sums the 16 in warp order, and after that the first rows of the
// next pass are asked for, in flight during steps 3 and 4.
// A first design passed tiles of 4 rows through a 3-stage ring shared by
// the CTA, with one block barrier a tile (the tile's t before its A' t) and
// four busy warps in step 5: slower than the streamed loops it replaced at
// A (896, 384) and (960, 576), and hardly faster without its copies, so the
// per-tile chain, not the bytes, set its time (PERF.md). The
// per-warp slots have no such chain; tools/torch_dense_variants.py times
// this source against variants without the copies or without the pass.
// The two fence.proxy.async are needed: without them, at two CTAs an SM
// ((896, 384)) a TMA write overtook a slot's queued shared-memory loads and
// whole scenarios came out wrong (the tool's "nofence").
// Bytes a 25-iteration chunk at B = 512: A and Minv from HBM once a launch
// (6.29 MB a scenario at (1280, 768), 3.2 GB; 3.5 MB and 1.8 GB at (960,
// 576)), then each A row from L2 once an iteration (2.0 GB an iteration at
// (1280, 768)): the resident clusters' A, ~27.5 MB at (1280, 768) (7
// clusters) and ~33 MB at (960, 576) (15), stays in L2's 50 MB. Measured
// times of every shape in PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_push.cuh"

namespace cg = cooperative_groups;
using namespace cluster_push;

namespace {

constexpr int kThreads = 512;    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;  // lanes that share one row of Minv rhs (step 4)

// where a CTA's rows of A and Minv are read (header: "Where the rows live")
constexpr int kOnChip = 0, kRing = 1, kStreamBoth = 2;

// the float4 at index i of a row: from device memory through the read-only
// path, or from shared memory
template <bool kDevice>
__device__ __forceinline__ float4 row4(const float* row, int i) {
  if constexpr (kDevice)
    return __ldg(reinterpret_cast<const float4*>(row) + i);
  else
    return reinterpret_cast<const float4*>(row)[i];
}

// `bytes` (a multiple of 16) from global `src` into this CTA's shared
// memory at `dst` (16-byte aligned) by the TMA, counted on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// orders this thread's earlier shared-memory accesses before TMA writes to
// the same bytes that a barrier after it lets another thread issue
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp / jnp.clip
  return (v > hi) ? hi : v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  return acc + a.w * b.w;
}

// Row-split geometry of a cluster of C CTAs.
struct Split {
  int mr, nr, groups;  // A rows and Minv rows per CTA; row groups of A' t
};

__host__ __device__ __forceinline__ Split split(int m, int n, int C) {
  const int nc4 = n / 4;
  Split s;
  s.mr = (m + C - 1) / C;
  s.nr = (n + C - 1) / C;
  s.groups = kThreads / nc4 > 0 ? kThreads / nc4 : 1;
  return s;
}

// columns of rhs each CTA owns
__host__ __device__ __forceinline__ int segment(int n, int C) { return (n + C - 1) / C; }

// Shared floats per CTA of instance `place` in clusters of C, in this order:
// rows of A (kOnChip) or the ring's slots, which end each pass holding the
// warps' partials A' t (kRing), first, so that each is 16-byte aligned; rows
// of Minv (not kStreamBoth); the row-group partials (not kRing); the push
// slots (2 x C x segment), q and x, rhs and xt (2 x n each), and six
// per-row vectors.
__host__ __device__ __forceinline__ size_t a_floats(int m, int n, int place, int C) {
  return place == kOnChip ? (size_t)split(m, n, C).mr * n
         : place == kRing ? (size_t)kWarps * n
                          : 0;
}
__host__ __device__ __forceinline__ size_t smem_floats(int m, int n, int place, int C) {
  const Split s = split(m, n, C);
  return a_floats(m, n, place, C) + (place != kStreamBoth ? (size_t)s.nr * n : 0) +
         (place != kRing ? (size_t)s.groups * n : 0) + 2 * (size_t)C * segment(n, C) +
         6 * (size_t)n + 6 * (size_t)s.mr;
}

// the relaxation, projection and dual step of a row, given (A xt)_r
struct RowStep {
  float z, y, t;
};
__device__ __forceinline__ RowStep row_step(float axt, float zi, float yi, float ri, float li,
                                            float ui, float alpha, float oma) {
  const float axr = alpha * axt + oma * zi;
  const float y_over_rho = (ri > 0.0f) ? yi / ri : 0.0f;
  const float zn = clip(axr + y_over_rho, li, ui);
  const float yn = yi + ri * (axr - zn);
  return {zn, yn, ri * zn - yn};
}

template <int P, int C, int V>
__global__ void __launch_bounds__(kThreads, V > 3 ? 1 : 2)
admm_dense_kernel(const float* __restrict__ A, const float* __restrict__ Minv,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ z0,
                  const float* __restrict__ y0, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo, int m, int n, int iters,
                  float sigma, float alpha, float oma) {
  extern __shared__ __align__(16) float smem[];
  // [0, 1]: this CTA's columns of the C partials A_c' t of iteration it
  // land in buffer it & 1; [2, 3]: the rows of xt; [4, 5]: the owners'
  // columns of rhs; [6, 6 + kWarps): the ring's slots (kRing)
  constexpr int kBars = 6 + kWarps;
  __shared__ __align__(8) unsigned long long bars[kBars];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Split sp = split(m, n, C);
  const int a0 = rank * sp.mr, a1 = min(m, a0 + sp.mr), ma = a1 > a0 ? a1 - a0 : 0;
  const int k0 = rank * sp.nr, k1 = min(n, k0 + sp.nr), nk = k1 > k0 ? k1 - k0 : 0;
  const int nc4 = n / 4;
  const int b = blockIdx.x / C, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid & (kLanesPerRow - 1);
  const int rgroup = tid / kLanesPerRow, ngroups = kThreads / kLanesPerRow;
  // this CTA owns columns [c0, c0 + nown) of rhs
  const int seg = segment(n, C), c0 = rank * seg, nown = max(0, min(n, c0 + seg) - c0);

  constexpr bool kRingA = P == kRing, kDev = P == kStreamBoth;
  // the partials A_r' t: G row groups (a thread per (group, 4 columns)), or
  // one a warp, in the ring's slots
  const int G = kRingA ? kWarps : sp.groups;
  float* sA = smem;                           // kOnChip: ma x n, rows [a0, a1) of A; kRing: slots
  float* sM = sA + a_floats(m, n, P, C);      // nk x n: rows [k0, k1) of Minv
  float* send = sM + (kDev ? 0 : (size_t)sp.nr * n);
  float* sred = kRingA ? sA : send;           // G x n
  float* srecv = kRingA ? send : sred + (size_t)G * n;  // 2 x C x seg: A_c' t from CTA c
  float* sq = srecv + 2 * (size_t)C * seg;              // n
  float* sx = sq + n;                                   // n
  float* srhs = sx + n;                                 // 2 x n: the whole rhs, from its owners
  float* sxf = srhs + 2 * n;                            // 2 x n: the whole xt, from its owners
  float* sl = sxf + 2 * n;                              // ma each: this CTA's rows
  float* su = sl + sp.mr;
  float* srho = su + sp.mr;
  float* sz = srho + sp.mr;
  float* sy = sz + sp.mr;
  float* st = sy + sp.mr;

  const size_t bn = (size_t)b * n, bm = (size_t)b * m + a0;
  const float* Ad = A + ((size_t)b * m + a0) * n;  // this CTA's rows in device memory
  const float* Md = Minv + ((size_t)b * n + k0) * n;
  const uint32_t bar0 = smem_u32(&bars[0]);  // bars[j] is bar0 + 8 j

  // kRing: row r of this CTA's into slot r % kWarps, counted on its barrier
  auto fetch = [&](int r) {
    const int w = r % kWarps;
    const uint32_t bar = bar0 + 8 * (6 + w);
    bar_arm(bar, 4u * n);
    bulk_load(smem_u32(sA + (size_t)w * n), Ad + (size_t)r * n, 4u * n, bar);
  };
  if (tid == 0) {  // armed for iterations 0 and 1; the prologue's first rows asked for
    const uint32_t recv_bytes = 4u * C * nown, xt_bytes = 4u * n;
    for (int j = 0; j < kBars; ++j) bar_init(bar0 + 8 * j);
    bar_init_fence();
    for (int it = 0; it < 2 && it < iters; ++it) {
      bar_arm(bar0 + 8 * it, recv_bytes);
      bar_arm(bar0 + 8 * (2 + it), xt_bytes);
      bar_arm(bar0 + 8 * (4 + it), xt_bytes);
    }
    if (kRingA && iters > 0)
      for (int r = 0; r < kWarps && r < ma; ++r) fetch(r);
  }
  if constexpr (P == kOnChip) {
    const float4* Ag = reinterpret_cast<const float4*>(Ad);
    for (int i = tid; i < ma * nc4; i += kThreads) reinterpret_cast<float4*>(sA)[i] = Ag[i];
  }
  if constexpr (!kDev) {
    const float4* Mg = reinterpret_cast<const float4*>(Md);
    for (int i = tid; i < nk * nc4; i += kThreads) reinterpret_cast<float4*>(sM)[i] = Mg[i];
  }
  // the rows that steps 1, 4 and 5 read (kRing: the slots)
  const float* Ar = kDev ? Ad : sA;
  const float* Mrows = kDev ? Md : sM;
  for (int i = tid; i < n; i += kThreads) {
    sq[i] = q[bn + i];
    sx[i] = x0[bn + i];
  }
  for (int i = tid; i < ma; i += kThreads) {
    const float zi = z0[bm + i], yi = y0[bm + i], ri = rho[bm + i];
    sl[i] = l[bm + i];
    su[i] = u[bm + i];
    srho[i] = ri;
    sz[i] = zi;
    sy[i] = yi;
    st[i] = ri * zi - yi;
  }
  // every CTA of the cluster has started (its shared memory and barriers
  // exist) and this CTA's loads are visible to its threads
  cluster.sync();

  // until barrier j's phase of iteration it has completed; then armed for
  // iteration it + 2 (its peers send for it + 2 only after this CTA's next
  // sends, which come after the arm)
  auto wait = [&](int j, int it) {
    const uint32_t bar = bar0 + 8 * j;
    // two CTAs may share the SM: one warp polls, the others sleep in the
    // block barrier instead of taking issue slots from the other CTA
    if (warp == 0) bar_wait(bar, (it >> 1) & 1);
    __syncthreads();
    if (tid == 0 && it + 2 < iters)
      bar_arm(bar, j < 2 ? 4u * C * nown : 4u * n);
  };

  // kRing: one pass of this warp over its rows warp, warp + kWarps, ...
  // through its slot (header: "The ring pass"). With xv (iteration it's
  // xt), step 5 on each row; with `partial`, then the row's share of the
  // next partial A_r' t, stored in the warp's slot when the pass ends.
  constexpr int kV = V > 0 ? V : 1;
  const float* slot = sA + (size_t)warp * n;
  const uint32_t slot_bar = bar0 + 8 * (6 + warp);
  int taken = 0;  // rows this warp has taken from its slot
  auto ring_pass = [&](const float* xv, bool partial) {
    float4 acc[kV], xq[kV];  // the warp's partial; the lane's columns of xt
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c4 = lane + 32 * i;
      acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      xq[i] = xv != nullptr && c4 < nc4 ? reinterpret_cast<const float4*>(xv)[c4] : acc[i];
    }
    for (int r = warp; r < ma; r += kWarps) {
      bar_wait(slot_bar, taken++ & 1);
      float4 a[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int c4 = lane + 32 * i;
        a[i] = c4 < nc4 ? row4<false>(slot, c4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // the slot is read (its loads ordered before the TMA's writes, which
      // at two CTAs an SM overtook queued loads: header): the warp's next
      // row may land in it
      fence_async_shared();
      __syncwarp();
      if (lane == 0 && r + kWarps < ma) fetch(r + kWarps);
      const float zi = sz[r], yi = sy[r], ri = srho[r];
      float ti = ri * zi - yi;
      if (xv != nullptr) {  // step 5
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < kV; ++i) d = dot4(a[i], xq[i], d);  // zero past n
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        const RowStep s = row_step(d, zi, yi, ri, sl[r], su[r], alpha, oma);
        __syncwarp();  // every lane has read z and y of row r
        if (lane == 0) {
          sz[r] = s.z;
          sy[r] = s.y;
        }
        ti = s.t;
      }
      if (partial) {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          acc[i].x += a[i].x * ti;
          acc[i].y += a[i].y * ti;
          acc[i].z += a[i].z * ti;
          acc[i].w += a[i].w * ti;
        }
      }
    }
    if (partial) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int c4 = lane + 32 * i;
        if (c4 < nc4) reinterpret_cast<float4*>(sA + (size_t)warp * n)[c4] = acc[i];
      }
    }
    __syncthreads();
  };

  if constexpr (kRingA)
    if (iters > 0) ring_pass(nullptr, true);  // iteration 0's partial A_r' t
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    float* recv = srecv + (size_t)buf * C * seg;
    float* xf = sxf + (size_t)buf * n;
    float* rhs = srhs + (size_t)buf * n;
    if constexpr (!kRingA) {
      // 1. partial A_r' t: a thread per (row group, 4 columns)
      for (int e = tid; e < G * nc4; e += kThreads) {
        const int c4 = e % nc4, g = e / nc4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        // on chip not unrolled: unrolled twice it was 4% slower at A (448,
        // 192) (PERF.md); from device memory four rows' loads in flight
#pragma unroll (kDev ? 4 : 1)
        for (int i = g; i < ma; i += G) {
          const float4 a = row4<kDev>(Ar + (size_t)i * n, c4);
          const float ti = st[i];
          acc.x += a.x * ti;
          acc.y += a.y * ti;
          acc.z += a.z * ti;
          acc.w += a.w * ti;
        }
        reinterpret_cast<float4*>(sred + (size_t)g * n)[c4] = acc;
      }
      __syncthreads();
    }
    // 2. sum the G partials in order and send each column of A_r' t into
    //    slot `rank` of its owner
    for (int k = tid; k < n; k += kThreads) {
      float s = sred[k];
      for (int g = 1; g < G; ++g) s += sred[(size_t)g * n + k];
      const int c = k / seg;
      const uint32_t slot_k = smem_u32(recv + (size_t)rank * seg + (k - c * seg));
      st_async(map_rank(slot_k, c), s, map_rank(bar0 + 8 * buf, c));
    }
    if (kRingA) fence_async_shared();  // the slots are read, as in the pass
    wait(buf, it);
    if (kRingA && tid == 0) {  // the partials are summed: this pass's first rows
      for (int r = 0; r < kWarps && r < ma; ++r) fetch(r);
    }
    // 3. this CTA's columns of rhs = (sigma x - q) + sum over the cluster of
    //    A_c' t, in rank order, sent into every CTA's rhs: a thread per
    //    (column, destination), each forming the same sum
    for (int e = tid; e < nown * C; e += kThreads) {
      const int jc = e / C, dst = e % C;
      float s = recv[jc];
#pragma unroll 8  // fully unrolled at C = 16 it spilled
      for (int c = 1; c < C; ++c) s += recv[(size_t)c * seg + jc];
      const int k = c0 + jc;
      const float v = (sigma * sx[k] - sq[k]) + s;
      st_async(map_rank(smem_u32(rhs + k), dst), v, map_rank(bar0 + 8 * (4 + buf), dst));
    }
    wait(4 + buf, it);
    // 4. this CTA's rows of xt = Minv rhs, 8 lanes per row, sent into every
    //    CTA's whole xt
    for (int r0 = 0; r0 < nk; r0 += ngroups) {  // uniform bound: every lane shuffles
      const int r = r0 + rgroup;
      float acc = 0.0f;
      if (r < nk) {
        const float* Mr = Mrows + (size_t)r * n;
        const float4* rv = reinterpret_cast<const float4*>(rhs);
#pragma unroll 2  // two float4 pairs in flight: the cluster-of-8 CTA has 64 registers
        for (int c4 = sub; c4 < nc4; c4 += kLanesPerRow)
          acc = dot4(row4<kDev>(Mr, c4), rv[c4], acc);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      // the butterfly leaves the same sum in all 8 lanes: lane `sub` sends
      // it to CTAs sub, sub + 8, ...
      if (r < nk)
        for (int d = sub; d < C; d += kLanesPerRow)
          st_async(map_rank(smem_u32(xf + k0 + r), d), acc, map_rank(bar0 + 8 * (2 + buf), d));
    }
    wait(2 + buf, it);
    // 5. x; A_r xt, relaxation, projection, dual step, next t
    for (int k = tid; k < n; k += kThreads) sx[k] = alpha * xf[k] + oma * sx[k];
    if constexpr (kRingA) {
      ring_pass(xf, it + 1 < iters);  // with the next iteration's step 1
    } else {
      for (int r0 = 0; r0 < ma; r0 += ngroups) {  // 8 lanes per row
        const int r = r0 + rgroup;
        float acc = 0.0f;
        if (r < ma) {
          const float* Arow = Ar + (size_t)r * n;
          const float4* xv = reinterpret_cast<const float4*>(xf);
#pragma unroll 2
          for (int c4 = sub; c4 < nc4; c4 += kLanesPerRow)
            acc = dot4(row4<kDev>(Arow, c4), xv[c4], acc);
        }
#pragma unroll
        for (int off = kLanesPerRow / 2; off >= 1; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (r < ma && sub == 0) {
          const RowStep s = row_step(acc, sz[r], sy[r], srho[r], sl[r], su[r], alpha, oma);
          sz[r] = s.z;
          sy[r] = s.y;
          st[r] = s.t;
        }
      }
      __syncthreads();
    }
  }
  // Every value sent to this CTA was waited for above, and no CTA reads
  // another's shared memory, so each may exit on its own.
  if (rank == 0)
    for (int i = tid; i < n; i += kThreads) xo[bn + i] = sx[i];
  for (int i = tid; i < ma; i += kThreads) {
    zo[bm + i] = sz[i];
    yo[bm + i] = sy[i];
  }
}

using DenseKernel = void (*)(const float*, const float*, const float*, const float*,
                            const float*, const float*, const float*, const float*,
                            const float*, float*, float*, float*, int, int, int, float, float,
                            float);

// The launches in the order the launcher tries them: instance, CTAs per
// cluster, and the largest n it takes (the ring: 128 V, a lane's V float4s
// of a row; 0: any).
struct Launch {
  int place, csize, max_n;
  DenseKernel kernel;
};
const Launch kLaunches[] = {{kOnChip, 8, 0, admm_dense_kernel<kOnChip, 8, 0>},
                            {kRing, 8, 384, admm_dense_kernel<kRing, 8, 3>},
                            {kRing, 8, 768, admm_dense_kernel<kRing, 8, 6>},
                            {kRing, 16, 768, admm_dense_kernel<kRing, 16, 6>},
                            {kStreamBoth, 8, 0, admm_dense_kernel<kStreamBoth, 8, 0>}};

// Launches the kernel, or only asks where it fits (batch <= 0): the first of
// kLaunches of which a cluster can be resident. *place is its instance (-1
// if none), *csize its CTAs per cluster, *clusters how many of its clusters
// can be resident at once (the answer cached per shape; 0 if none fits) and
// *smem its dynamic shared bytes per CTA.
cudaError_t launch(const float* A, const float* Minv, const float* q, const float* l,
                   const float* u, const float* rho, const float* x0, const float* z0,
                   const float* y0, float* xo, float* zo, float* yo, int batch, int m, int n,
                   int iters, float sigma, float alpha, float oma, cudaStream_t stream,
                   int* csize, int* clusters, int* place, size_t* smem) {
  *csize = 0;
  *clusters = 0;
  *place = -1;
  *smem = 0;
  if (n % 4 != 0 || m <= 0 || n <= 0) return cudaErrorInvalidValue;
  for (const Launch& c : kLaunches) {
    if (c.max_n > 0 && n > c.max_n) continue;
    cudaLaunchAttribute attr;
    const size_t bytes = smem_floats(m, n, c.place, c.csize) * sizeof(float);
    const cudaLaunchConfig_t cfg = cluster_config(batch, c.csize, kThreads, bytes, stream, &attr);
    cudaError_t err = resident_clusters(c.kernel, cfg, clusters);
    if (err != cudaSuccess) return err;
    if (*clusters < 1) continue;
    *place = c.place;
    *csize = c.csize;
    *smem = bytes;
    if (batch <= 0) return cudaSuccess;
    err = cudaLaunchKernelEx(&cfg, c.kernel, A, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, m, n,
                             iters, sigma, alpha, oma);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// C entry point. A (batch, m, n); Minv (batch, n, n); q, x0, xo (batch, n);
// l, u, rho, z0, y0, zo, yo (batch, m); all contiguous f32 on the device,
// A and Minv 16-byte aligned; n % 4 == 0. Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidConfiguration if no instance fits.
extern "C" int admm_dense_f32(const float* A, const float* Minv, const float* q, const float* l,
                              const float* u, const float* rho, const float* x0, const float* z0,
                              const float* y0, float* xo, float* zo, float* yo, int batch, int m,
                              int n, int iters, float sigma, float alpha, float oma,
                              cudaStream_t stream) {
  int csize = 0, clusters = 0, place = -1;
  size_t smem = 0;
  const cudaError_t err = launch(A, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, batch, m, n, iters,
                                 sigma, alpha, oma, stream, &csize, &clusters, &place, &smem);
  return err == cudaSuccess && clusters < 1 ? (int)cudaErrorInvalidConfiguration : (int)err;
}

// The launch admm_dense_f32 makes for A (m, n): its CTAs per cluster into
// *csize, how many such clusters can be resident at once into *clusters (0:
// no instance fits), its dynamic shared memory per CTA into *smem_bytes and
// its instance (0 kOnChip, 1 kRing, 2 kStreamBoth; -1 none) into *instance.
// Returns a cudaError_t as above.
extern "C" int admm_dense_shape(int m, int n, int* csize, int* clusters, int* smem_bytes,
                                int* instance) {
  size_t smem = 0;
  const cudaError_t err =
      launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, 0, m, n, 0, 0.f, 0.f, 0.f, nullptr, csize, clusters,
             instance, &smem);
  *smem_bytes = (int)smem;
  return (int)err;
}
