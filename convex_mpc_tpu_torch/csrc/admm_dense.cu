// Dense-A ADMM iterations for Hopper (sm_90a): `iters` over-relaxed ADMM
// steps per scenario against a dense constraint matrix A, one thread-block
// cluster of C CTAs per scenario, A and Minv held on chip across it.
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
// clusters of 8 only, and raises where A's and Minv's rows do not fit.
//
// The owners' gather (step 2) replaced an exchange in which every CTA
// received every CTA's whole partial (2 x 8 x n floats of slots) and summed
// all n columns itself: 12 n more floats, one wait fewer. That layout does
// not fit the full-form QP (formulation="full", nz = 24 N, m = 40 N) at
// horizon 16, A (640, 384): 80 + 48 rows of 384 and 25 x 384 + 480 floats
// more, 238,464 B, above the 232,448 B one CTA may have. The gather needs
// 218,496 B there (one CTA per SM) and 76,608 B at A (448, 192) (two).
// Horizons 24 and 32 (A (960, 576), (1280, 768)) do not fit, and the
// launcher returns cudaErrorInvalidConfiguration. Measured (kernel_times.py,
// NVIDIA H100 80GB HBM3, 700.00 W, B = 512, 25 iterations): 1.4775 ms at
// A (448, 192), against 1.5103-1.5223 ms for the whole-partial exchange,
// and 4.2834 ms at A (640, 384).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_push.cuh"

namespace cg = cooperative_groups;
using namespace cluster_push;

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kCluster = 8;    // CTAs per cluster (scenario): faster than 4 (header)
constexpr int kMinBlocks = 2;  // CTAs per SM at A (448, 192) (~77 KB each); one at (640, 384)
constexpr int kLanesPerRow = 8;  // lanes that share one row's dot product
static_assert(kLanesPerRow == kCluster, "lane l of a row sends its xt entry to CTA l");

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

// Row-split geometry of a cluster.
struct Split {
  int mr, nr, groups;  // A rows and Minv rows per CTA; row groups of A' t
};

__host__ __device__ __forceinline__ Split split(int m, int n) {
  const int nc4 = n / 4;
  Split s;
  s.mr = (m + kCluster - 1) / kCluster;
  s.nr = (n + kCluster - 1) / kCluster;
  s.groups = kThreads / nc4 > 0 ? kThreads / nc4 : 1;
  return s;
}

// columns of rhs each CTA owns
__host__ __device__ __forceinline__ int segment(int n) { return (n + kCluster - 1) / kCluster; }

// Shared floats per CTA: rows of A and Minv, the row-group partials, the
// push slots (2 x 8 x segment), q and x, rhs and xt (2 x n each), and six
// per-row vectors.
__host__ __device__ __forceinline__ size_t smem_floats(int m, int n) {
  const Split s = split(m, n);
  return (size_t)s.mr * n + (size_t)s.nr * n + (size_t)s.groups * n +
         2 * (size_t)kCluster * segment(n) + 6 * (size_t)n + 6 * (size_t)s.mr;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  // columns of rhs
  constexpr int kBars = 6;
  __shared__ __align__(8) unsigned long long bars[kBars];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Split sp = split(m, n);
  const int a0 = rank * sp.mr, a1 = min(m, a0 + sp.mr), ma = a1 > a0 ? a1 - a0 : 0;
  const int k0 = rank * sp.nr, k1 = min(n, k0 + sp.nr), nk = k1 > k0 ? k1 - k0 : 0;
  const int nc4 = n / 4, G = sp.groups;
  const int b = blockIdx.x / kCluster, tid = threadIdx.x, warp = tid >> 5;
  const int sub = tid & (kLanesPerRow - 1);
  const int rgroup = tid / kLanesPerRow, ngroups = kThreads / kLanesPerRow;
  // this CTA owns columns [c0, c0 + nown) of rhs
  const int seg = segment(n), c0 = rank * seg, nown = max(0, min(n, c0 + seg) - c0);

  float* sA = smem;                          // ma x n: rows [a0, a1) of A
  float* sM = sA + (size_t)sp.mr * n;        // nk x n: rows [k0, k1) of Minv
  float* sred = sM + (size_t)sp.nr * n;      // G x n: row-group partials of A_r' t
  float* srecv = sred + (size_t)G * n;       // 2 x kCluster x seg: A_c' t from each CTA c
  float* sq = srecv + 2 * (size_t)kCluster * seg;  // n
  float* sx = sq + n;                        // n
  float* srhs = sx + n;                      // 2 x n: the whole rhs, from its owners
  float* sxf = srhs + 2 * n;                 // 2 x n: the whole xt, from its owners
  float* sl = sxf + 2 * n;                   // ma each: this CTA's rows
  float* su = sl + sp.mr;
  float* srho = su + sp.mr;
  float* sz = srho + sp.mr;
  float* sy = sz + sp.mr;
  float* st = sy + sp.mr;

  const size_t bn = (size_t)b * n, bm = (size_t)b * m + a0;
  const float4* Ag = reinterpret_cast<const float4*>(A + ((size_t)b * m + a0) * n);
  for (int i = tid; i < ma * nc4; i += kThreads) reinterpret_cast<float4*>(sA)[i] = Ag[i];
  const float4* Mg = reinterpret_cast<const float4*>(Minv + ((size_t)b * n + k0) * n);
  for (int i = tid; i < nk * nc4; i += kThreads) reinterpret_cast<float4*>(sM)[i] = Mg[i];
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
  const uint32_t bar0 = smem_u32(&bars[0]);  // bars[j] is bar0 + 8 j
  // the xt and rhs barriers both expect n floats
  const uint32_t recv_bytes = 4u * kCluster * nown, xt_bytes = 4u * n;
  if (tid == 0) {  // armed for iterations 0 and 1
    for (int j = 0; j < kBars; ++j) bar_init(bar0 + 8 * j);
    bar_init_fence();
    for (int it = 0; it < 2 && it < iters; ++it) {
      bar_arm(bar0 + 8 * it, recv_bytes);
      bar_arm(bar0 + 8 * (2 + it), xt_bytes);
      bar_arm(bar0 + 8 * (4 + it), xt_bytes);
    }
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
    if (tid == 0 && it + 2 < iters) bar_arm(bar, j < 2 ? recv_bytes : xt_bytes);
  };

  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    float* recv = srecv + (size_t)buf * kCluster * seg;
    float* xf = sxf + (size_t)buf * n;
    float* rhs = srhs + (size_t)buf * n;
    // 1. partial A_r' t: a thread per (row group, 4 columns)
    for (int e = tid; e < G * nc4; e += kThreads) {
      const int c4 = e % nc4, g = e / nc4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1  // unrolled twice it was 4% slower at A (448, 192) (PERF.md)
      for (int i = g; i < ma; i += G) {
        const float4 a = reinterpret_cast<const float4*>(sA + (size_t)i * n)[c4];
        const float ti = st[i];
        acc.x += a.x * ti;
        acc.y += a.y * ti;
        acc.z += a.z * ti;
        acc.w += a.w * ti;
      }
      reinterpret_cast<float4*>(sred + (size_t)g * n)[c4] = acc;
    }
    __syncthreads();
    // 2. sum the row groups and send each column of A_r' t into slot `rank`
    //    of its owner
    for (int k = tid; k < n; k += kThreads) {
      float s = sred[k];
      for (int g = 1; g < G; ++g) s += sred[(size_t)g * n + k];
      const int c = k / seg;
      const uint32_t slot = smem_u32(recv + (size_t)rank * seg + (k - c * seg));
      st_async(map_rank(slot, c), s, map_rank(bar0 + 8 * buf, c));
    }
    wait(buf, it);
    // 3. this CTA's columns of rhs = (sigma x - q) + sum over the cluster of
    //    A_c' t, in rank order, sent into every CTA's rhs: a thread per
    //    (column, destination), each forming the same sum
    for (int e = tid; e < nown * kCluster; e += kThreads) {
      const int j = e / kCluster, dst = e % kCluster;
      float s = recv[j];
#pragma unroll
      for (int c = 1; c < kCluster; ++c) s += recv[(size_t)c * seg + j];
      const int k = c0 + j;
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
        const float4* Mr = reinterpret_cast<const float4*>(sM + (size_t)r * n);
        const float4* rv = reinterpret_cast<const float4*>(rhs);
#pragma unroll 2  // two float4 pairs in flight: the cluster-of-8 CTA has 64 registers
        for (int c4 = sub; c4 < nc4; c4 += kLanesPerRow) acc = dot4(Mr[c4], rv[c4], acc);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      // the butterfly leaves the same sum in all 8 lanes: lane `sub` sends
      // it to CTA `sub`
      if (r < nk)
        st_async(map_rank(smem_u32(xf + k0 + r), sub), acc, map_rank(bar0 + 8 * (2 + buf), sub));
    }
    wait(2 + buf, it);
    // 5. x; A_r xt (8 lanes per row), relaxation, projection, dual step, next t
    for (int k = tid; k < n; k += kThreads) sx[k] = alpha * xf[k] + oma * sx[k];
    for (int r0 = 0; r0 < ma; r0 += ngroups) {
      const int r = r0 + rgroup;
      float acc = 0.0f;
      if (r < ma) {
        const float4* Ar = reinterpret_cast<const float4*>(sA + (size_t)r * n);
        const float4* xv = reinterpret_cast<const float4*>(xf);
#pragma unroll 2
        for (int c4 = sub; c4 < nc4; c4 += kLanesPerRow) acc = dot4(Ar[c4], xv[c4], acc);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (r < ma && sub == 0) {
        const float zi = sz[r], yi = sy[r], ri = srho[r];
        const float axr = alpha * acc + oma * zi;
        const float y_over_rho = (ri > 0.0f) ? yi / ri : 0.0f;
        const float zn = clip(axr + y_over_rho, sl[r], su[r]);
        const float yn = yi + ri * (axr - zn);
        sz[r] = zn;
        sy[r] = yn;
        st[r] = ri * zn - yn;
      }
    }
    __syncthreads();
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

// Launches the kernel, or only asks where it fits (batch <= 0): *clusters is
// how many clusters can be resident at once (the answer cached per shape), 0
// if A's and Minv's rows do not fit one cluster.
cudaError_t launch(const float* A, const float* Minv, const float* q, const float* l,
                   const float* u, const float* rho, const float* x0, const float* z0,
                   const float* y0, float* xo, float* zo, float* yo, int batch, int m, int n,
                   int iters, float sigma, float alpha, float oma, cudaStream_t stream,
                   int* clusters) {
  *clusters = 0;
  if (n % 4 != 0 || m <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      batch, kCluster, kThreads, smem_floats(m, n) * sizeof(float), stream, &attr);
  cudaError_t err = resident_clusters(admm_dense_kernel, cfg, clusters);
  if (err != cudaSuccess || *clusters < 1 || batch <= 0) return err;
  err = cudaLaunchKernelEx(&cfg, admm_dense_kernel, A, Minv, q, l, u, rho, x0, z0, y0, xo, zo,
                           yo, m, n, iters, sigma, alpha, oma);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry point. A (batch, m, n); Minv (batch, n, n); q, x0, xo (batch, n);
// l, u, rho, z0, y0, zo, yo (batch, m); all contiguous f32 on the device;
// n % 4 == 0. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidConfiguration if A's and Minv's rows do not fit a cluster.
extern "C" int admm_dense_f32(const float* A, const float* Minv, const float* q, const float* l,
                              const float* u, const float* rho, const float* x0, const float* z0,
                              const float* y0, float* xo, float* zo, float* yo, int batch, int m,
                              int n, int iters, float sigma, float alpha, float oma,
                              cudaStream_t stream) {
  int clusters = 0;
  const cudaError_t err = launch(A, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo, batch, m, n,
                                 iters, sigma, alpha, oma, stream, &clusters);
  return err == cudaSuccess && clusters < 1 ? (int)cudaErrorInvalidConfiguration : (int)err;
}

// The cluster admm_dense_f32 launches for A (m, n): its CTAs into *csize,
// how many such clusters can be resident at once into *clusters (0: A does
// not fit) and its dynamic shared memory per CTA into *smem_bytes (0 if it
// does not fit). Returns a cudaError_t as above.
extern "C" int admm_dense_shape(int m, int n, int* csize, int* clusters, int* smem_bytes) {
  *csize = kCluster;
  const cudaError_t err = launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, nullptr, 0, m, n, 0, 0.f,
                                 0.f, 0.f, nullptr, clusters);
  *smem_bytes = *clusters >= 1 ? (int)(smem_floats(m, n) * sizeof(float)) : 0;
  return (int)err;
}
