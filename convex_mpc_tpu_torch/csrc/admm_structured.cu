// Structured ADMM chunk for Hopper (sm_90a): `iters` over-relaxed ADMM steps
// per scenario on the condensed MPC QP's block form, one thread-block cluster
// of C CTAs per scenario.
//
// Replaces the TPU kernel convex_mpc_tpu/mpc/kernels.py::
// admm_iterations_structured (_structured_kernel), the iteration engine of
// admm.solve_adaptive (25 iterations per chunk on the main path, B = 512,
// nb = 4 x horizon friction blocks: nz = 3 nb = 192, m = 7 nb = 448 at
// horizon 16; nz = 288 and 384 at horizons 24 and 32).
//
// What bounds it on this card. Per iteration a scenario reads its KKT
// inverse Minv (nz x nz f32, 147,456 B at nz = 192) once for the matvec;
// everything else is O(m). The least traffic is Minv and the vectors read
// once and the iterate written once: 78 MB per chunk at B = 512, nz = 192,
// 0.025 ms at 3.35 TB/s (bytes bound it; the 2 nz^2 flops per iteration
// are 0.019 ms at 67 TFLOP/s). Minv is therefore loaded into shared memory
// once per chunk and the matvec runs from there.
//
// The earlier design (one 512-thread block per scenario, all of Minv in its
// shared memory, four barriers per iteration) took 0.3298 ms per 25
// iterations at nz = 192 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W):
// ~165 KB of shared memory let one block run per SM (3.88 waves of 132
// scenarios); its short phases between barriers left most warps idle; above
// nz ~ 230 it read Minv from device memory every iteration. A first cluster
// version that split Minv's rows but had every CTA redo the whole block
// phase for all m rows was no faster (0.2974-0.4856 ms over six runs): per
// SM it issued as many instructions per scenario-iteration as before.
//
// This design: a cluster of C CTAs per scenario (up to nz = 256 the
// smallest C >= 2 whose share fits a CTA, 2 at nz = 192; above, see the
// end) splits the scenario by friction blocks. CTA c owns blocks
// [c bpc, (c+1) bpc): their 3 bpc columns (the same rows of Minv, and of
// xt), their 4 bpc face rows and 3 bpc box rows. It keeps those rows of
// Minv in shared memory and the state of its rows (z, y, rho, l, u, the
// block's coefficients, x, q) in registers, four
// threads per block (thread i: face row i; threads 0-2 also box row and
// column i). Per iteration:
//  1. wait until the whole rhs (nz floats) has arrived in this CTA's buffer
//     (an mbarrier counting the bytes of every CTA's st.async);
//  2. fold this CTA's rows of xt = Minv rhs into local shared memory;
//  3. one block barrier;
//  4. each block's four threads update their rows and column from xt, form
//     the next rhs of their columns (the four face rows' w exchanged by
//     shuffles) and store it into the rhs buffer of every CTA of the cluster.
// One block barrier and one cluster-wide exchange per iteration (the
// earlier design had four block barriers); no work is done twice. Shared
// memory per CTA is Minv's rows plus 2 nz + 2 rpc floats: 76,032 B at
// nz = 192, so three CTAs (1.5 scenarios, 24 warps) fit per SM, 198
// scenarios in flight, 2.59 waves at B = 512.
// Estimate at nz = 192, C = 2: per CTA and iteration the fold is 96 rows of
// ~20 warp instructions and the block phase ~130 instructions on 4 warps;
// with three CTAs per SM ~2,000 cycles per iteration of each, ~1.1 us, so
// ~0.03 ms per wave of 25 iterations and ~0.10-0.15 ms per chunk at
// B = 512 with the load. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W, 25 iterations, B = 512): 0.1969 ms at nz = 192, 7.8x the
// bound; 0.4923 ms at nz = 288 and 0.9628 ms at nz = 384 (clusters of 3).
//
// Above nz = 256 the smallest cluster's share of Minv takes most of an SM's
// shared memory, so that layout kept one CTA, and one iteration chain, on
// each SM (39 scenarios resident at nz = 384). clock64() stamps of one
// chain (tools/torch_structured_variants.py `clock`) put ~4,050 cycles in
// an iteration there: the fold 2,530, the two divisions y / rho 710, the
// update 355, the send 290, the rhs wait 145. So:
//  - a zero y skips the division's slow path (over(), at every nz);
//  - nz = 384 runs S = 3 slots (scenarios) a CTA, each on its own warps,
//    shared memory, rhs barriers and named barrier, in clusters of 8 (45
//    resident, 48 rows a slot; the smallest cluster that holds three
//    slots' rows); nz = 288 one slot in clusters of 3, two CTAs an SM (79
//    resident against 66 in clusters of 2). Every other nz keeps one slot
//    in the smallest cluster that fits (slots_for, min_cluster).
// Measured (same card, 25 iterations, B = 512 / 1,280): nz = 384 0.674 /
// 1.609 ms against 0.954 / 2.254 before; nz = 288 0.370 / 0.868 against
// 0.489 / 1.210. One slot at nz = 384 (0.746 / 1.747 with the guard) and
// two or three slots at nz = 288 lost. The slots' chains keep in step (all
// start together): a chain's iteration is ~3,600 cycles, its fold ~2,450
// for 48 rows while the other two slots fold theirs. Starting slots apart,
// letting their folds take turns, two slots a CTA, and float4 reads of a
// lane-major Minv were no faster (PERF.md, section 6).
//
// Arithmetic order is pinned to the plain PyTorch version (and to the JAX
// twin admm_iterations_structured_xla), whichever CTA computes a row: the
// 4-term A'w and 3-term Av block sums in order with the box term last;
// rhs = (sigma x - q) + A'(rho z - y); the KKT matvec as the same halving
// tree over lanes zero-padded to a power of two (each lane holds lanes t,
// t+32, ...; the in-register stages halve them, then __shfl_down_sync 16, 8,
// 4, 2, 1; a warp folds four rows at once so their latency chains overlap);
// true division y / rho; every product and sum rounded on its own
// (__fmul_rn/__fadd_rn, and the file is compiled with -fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_push.cuh"

namespace cg = cooperative_groups;
using namespace cluster_push;

namespace {

constexpr int R = 4;                // rows a warp folds at once
constexpr int kRowsPerWarp = 3 * R;  // rows per warp per fold: three passes

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp / jnp.clip
  return (v > hi) ? hi : v;
}

// Shared memory of one slot (one scenario's share of a CTA), in floats, for
// bpc owned blocks (rpc = 3 bpc rows of Minv and xt); a multiple of 4, so
// every slot's rows of Minv start 16-byte aligned.
__host__ __device__ __forceinline__ size_t smem_floats(int nb, int bpc) {
  const size_t nz = 3 * (size_t)nb, rpc = 3 * (size_t)bpc;
  return (rpc * nz + 2 * nz + 2 * rpc + 3) & ~(size_t)3;
}

// Waits at slot `slot`'s barrier: the whole CTA when it runs one slot, else
// the slot's own named barrier (1 + slot) over its nts threads.
template <int S>
__device__ __forceinline__ void slot_sync(int slot, int nts) {
  if constexpr (S == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(nts) : "memory");
}

// One level of the in-register halving tree, then the next: lanes k and
// k + H of each row are added for k < H (a template per level, so every
// index is a constant and v stays in registers).
template <int H, int VPL, int NR>
struct Halve {
  static __device__ __forceinline__ void run(float (&v)[NR][VPL]) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int k = 0; k < H; ++k) v[i][k] = __fadd_rn(v[i][k], v[i][k + H]);
    Halve<H / 2, VPL, NR>::run(v);
  }
};
template <int VPL, int NR>
struct Halve<0, VPL, NR> {
  static __device__ __forceinline__ void run(float (&)[NR][VPL]) {}
};

// The in-register stage of the fold for NR rows of Minv (row pointers Mr)
// against the lanes r[] of rhs: part[i] = this lane's sum, by the halving
// tree, of r[k] Mr[i][lane + 32 k] (zero beyond nz). KFULL >= 0: nz is
// 32 KFULL, so chunks k < KFULL are whole and the rest are zero.
template <int VPL, int KFULL, int NR>
__device__ __forceinline__ void fold_lanes(const float* const* Mr, const float (&r)[VPL],
                                           int lane, int nz, float (&part)[NR]) {
  float v[NR][VPL];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (KFULL >= 0)
        v[i][k] = (k < KFULL) ? __fmul_rn(r[k], Mr[i][j]) : 0.0f;
      else
        v[i][k] = (j < nz) ? __fmul_rn(r[k], Mr[i][j]) : 0.0f;
    }
  Halve<VPL / 2, VPL, NR>::run(v);
#pragma unroll
  for (int i = 0; i < NR; ++i) part[i] = v[i][0];
}

// y / rho, true division. A zero y over a positive rho gives y itself,
// which is IEEE's quotient, and the division runs on 1 instead: a zero
// dividend (every inactive row's y) sends the card's division down its slow
// path. Measured at nz = 384: an iteration's two divisions took ~700
// cycles, ~220 with the guard.
__device__ __forceinline__ float over(float y, float rho) {
  const bool z = y == 0.0f && rho > 0.0f;
  const float q = __fdiv_rn(z ? 1.0f : y, rho);
  return z ? y : q;
}

// relaxation, projection and dual step of one row, with y / rho and
// (1 - alpha) z of the previous iterate computed ahead
__device__ __forceinline__ void step(float axt, float& z, float& y, float rr, float lo, float hi,
                                     float yr, float oz, float alpha) {
  const float axr = __fadd_rn(__fmul_rn(alpha, axt), oz);
  const float zn = clip(__fadd_rn(axr, yr), lo, hi);
  y = __fadd_rn(y, __fmul_rn(rr, __fsub_rn(axr, zn)));
  z = zn;
}

// VPL: lanes of the KKT fold / 32; KFULL: nz / 32 when nz is a multiple of
// 32, else -1; MAXT, MINB: the launch bounds (threads per CTA, CTAs per SM)
// that size the register budget; S: slots, the scenarios a CTA runs side by
// side. Slot s of cluster k runs scenario k S + s on its own warps (threads
// [s nts, (s + 1) nts)), its own shared memory, rhs barriers and named
// barrier; a slot past the batch only takes part in the start.
template <int VPL, int KFULL, int MAXT, int MINB, int S>
__global__ void __launch_bounds__(MAXT, MINB)
admm_structured_kernel(const float* __restrict__ C, const float* __restrict__ box,
                       const float* __restrict__ Minv, const float* __restrict__ q,
                       const float* __restrict__ l, const float* __restrict__ u,
                       const float* __restrict__ rho, const float* __restrict__ x0,
                       const float* __restrict__ z0, const float* __restrict__ y0,
                       float* __restrict__ xo, float* __restrict__ zo,
                       float* __restrict__ yo, int batch, int nb, int iters, float sigma,
                       float alpha, float oma) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long rbar[2 * S];  // per slot, one per rhs buffer
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nz = 3 * nb, mfr = 4 * nb;
  const int bpc = (nb + csize - 1) / csize;  // blocks per CTA
  const int bl0 = min(nb, rank * bpc), nbo = min(nb, bl0 + bpc) - bl0;  // this CTA's blocks
  const int r0 = 3 * bl0, r1 = r0 + 3 * nbo;  // its rows of Minv and xt
  const int nts = blockDim.x / S;  // threads of a slot, a multiple of 32
  const int slot = threadIdx.x / nts, tid = threadIdx.x - slot * nts;
  const int b = (blockIdx.x / csize) * S + slot;
  const bool live = b < batch;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nts >> 5;

  float* sM = smem + (size_t)slot * smem_floats(nb, bpc);  // 3 bpc x nz: this slot's rows of Minv
  float* srhs = sM + (size_t)3 * bpc * nz;   // 2 x nz: the whole rhs, double-buffered
  float* sxt = srhs + 2 * nz;                // 2 x 3 bpc: this CTA's rows of xt

  const size_t bm = (size_t)b * (mfr + nz), bv = (size_t)b * nz;
  const float* Mg = Minv + (size_t)b * nz * nz + (size_t)r0 * nz;
  const int mcount = live ? (r1 - r0) * nz : 0;
  if ((nz & 3) == 0) {
    for (int i = tid; i < mcount / 4; i += nts)
      reinterpret_cast<float4*>(sM)[i] = reinterpret_cast<const float4*>(Mg)[i];
  } else {
    for (int i = tid; i < mcount; i += nts) sM[i] = Mg[i];
  }

  // The block phase's thread: block blk, face row fi = 4 blk + li; for li < 3
  // also column col = 3 blk + li and box row mfr + col. Its rows' state stays
  // in registers for the whole chunk.
  const bool mine = live && tid < 4 * nbo;
  const int li = tid & 3, blk = bl0 + (tid >> 2);
  const bool has_col = mine && li < 3;
  const int fi = 4 * blk + li, col = 3 * blk + li, bi = mfr + col;
  float zf = 0.f, yf = 0.f, rf = 1.f, lf = 0.f, uf = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float zb = 0.f, yb = 0.f, rb = 1.f, lb = 0.f, ub = 0.f, bx = 0.f, xv = 0.f, qv = 0.f;
  float cc0 = 0.f, cc1 = 0.f, cc2 = 0.f, cc3 = 0.f;  // column li of the block's C (A' row)
  if (mine) {
    const float* Cb = C + ((size_t)b * nb + blk) * 12;  // [face][coord]
    zf = z0[bm + fi];
    yf = y0[bm + fi];
    rf = rho[bm + fi];
    lf = l[bm + fi];
    uf = u[bm + fi];
    c0 = Cb[3 * li];
    c1 = Cb[3 * li + 1];
    c2 = Cb[3 * li + 2];
    if (has_col) {
      zb = z0[bm + bi];
      yb = y0[bm + bi];
      rb = rho[bm + bi];
      lb = l[bm + bi];
      ub = u[bm + bi];
      bx = box[bv + col];
      xv = x0[bv + col];
      qv = q[bv + col];
      cc0 = Cb[li];
      cc1 = Cb[3 + li];
      cc2 = Cb[6 + li];
      cc3 = Cb[9 + li];
    }
  }

  const uint32_t bar0 = smem_u32(&rbar[2 * slot]);  // the slot's second is bar0 + 8
  const uint32_t rhs_bytes = 4u * nz;
  if (tid == 0) {  // armed for the rhs of iterations 0 and 1
    bar_init(bar0);
    bar_init(bar0 + 8);
    bar_init_fence();
    if (live && iters > 0) bar_arm(bar0, rhs_bytes);
    if (live && iters > 1) bar_arm(bar0 + 8, rhs_bytes);
  }
  // every CTA of the cluster has started (its shared memory and barriers
  // exist) and this CTA's Minv rows are visible to its threads
  cluster.sync();
  if (!live) return;  // the same slot of every CTA of the cluster is empty

  // rhs of this thread's column = (sigma x - q) + A'(rho z - y): the four
  // face rows' w by shuffles within the block's four lanes, then the 4-term
  // sum in face order, the box term last; stored into rhs buffer `buf` of
  // every CTA of the cluster. Every thread calls it (shuffles).
  auto send_rhs = [&](int buf) {
    const float wf = mine ? __fsub_rn(__fmul_rn(rf, zf), yf) : 0.0f;
    const float w0 = __shfl_sync(0xffffffffu, wf, 0, 4);
    const float w1 = __shfl_sync(0xffffffffu, wf, 1, 4);
    const float w2 = __shfl_sync(0xffffffffu, wf, 2, 4);
    const float w3 = __shfl_sync(0xffffffffu, wf, 3, 4);
    if (has_col) {
      const float wb = __fsub_rn(__fmul_rn(rb, zb), yb);
      float acc = __fmul_rn(cc0, w0);
      acc = __fadd_rn(acc, __fmul_rn(cc1, w1));
      acc = __fadd_rn(acc, __fmul_rn(cc2, w2));
      acc = __fadd_rn(acc, __fmul_rn(cc3, w3));
      acc = __fadd_rn(acc, __fmul_rn(bx, wb));
      const float rv = __fadd_rn(__fsub_rn(__fmul_rn(sigma, xv), qv), acc);
      const uint32_t dst = smem_u32(srhs + buf * nz + col), bar = bar0 + 8 * buf;
      for (int c = 0; c < csize; ++c) st_async(map_rank(dst, c), rv, map_rank(bar, c));
    }
  };
  if (iters > 0) send_rhs(0);

  // y / rho, (1 - alpha) z and (1 - alpha) x of the current iterate, formed
  // while the rhs travels
  float yrf = over(yf, rf), ozf = __fmul_rn(oma, zf);
  float yrb = over(yb, rb), ozb = __fmul_rn(oma, zb), ox = __fmul_rn(oma, xv);

  const int hi = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    if (MINB > 1) {
      // CTAs share the SM: one warp polls, the others sleep in the block
      // barrier instead of taking issue slots from the other CTAs
      if (warp == 0) bar_wait(bar0 + 8 * buf, parity);
      __syncthreads();
    } else {  // every thread polls (slots too: a polling warp and a slot barrier were slower)
      bar_wait(bar0 + 8 * buf, parity);
    }
    // every thread has passed the wait (or sits in the barrier behind it); a
    // peer sends the rhs of iteration it + 2 only after this CTA's rhs of
    // it + 1, which comes after this arm
    if (tid == 0 && it + 2 < iters) bar_arm(bar0 + 8 * buf, rhs_bytes);

    // xt = Minv rhs for this CTA's rows, R rows per warp: each row's lanes by
    // the in-register halving tree, then across lanes by the tree of
    // __shfl_down_sync 16, 8, 4, 2, 1. Its first two levels run as a
    // butterfly that hands each lane pair two of the R rows (the same pairs
    // of lanes are added, so each row's sum is the same); its last three as
    // shuffles within groups of 8 lanes. Lane 8 i then holds row i's sum.
    {
      const float* rb_ = srhs + buf * nz;
      float r[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = lane + 32 * k;
        r[k] = (KFULL >= 0 ? k < KFULL : j < nz) ? rb_[j] : 0.0f;
      }
      float* xt = sxt + buf * 3 * bpc;
      for (int n0 = r0 + R * warp; n0 < r1; n0 += R * nwarps) {
        float part[R];
        if constexpr (VPL >= 16) {  // two rows at a time: four rows' lanes take too many registers
#pragma unroll
          for (int h = 0; h < R; h += 2) {
            const float* Mr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              Mr[i] = sM + (size_t)((n0 + h + i < r1 ? n0 + h + i : r0) - r0) * nz;
            float p2[2];
            fold_lanes<VPL, KFULL, 2>(Mr, r, lane, nz, p2);
            part[h] = p2[0];
            part[h + 1] = p2[1];
          }
        } else {
          const float* Mr[R];
#pragma unroll
          for (int i = 0; i < R; ++i) Mr[i] = sM + (size_t)((n0 + i < r1 ? n0 + i : r0) - r0) * nz;
          fold_lanes<VPL, KFULL, R>(Mr, r, lane, nz, part);
        }
        // level 16: lanes t and t ^ 16 each add the pair (t, t + 16) of two rows
        const float s0 = hi ? part[0] : part[2], s1 = hi ? part[1] : part[3];
        const float k0 = hi ? part[2] : part[0], k1 = hi ? part[3] : part[1];
        const float q0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, s0, 16));
        const float q1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, s1, 16));
        // level 8: lanes t and t ^ 8 each add the pair (t, t + 8) of one row,
        // row 2 hi + b3
        const float s = b3 ? q0 : q1, kp = b3 ? q1 : q0;
        float w = __fadd_rn(kp, __shfl_xor_sync(0xffffffffu, s, 8));
        w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, 4));
        w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, 2));
        w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, 1));
        const int row = n0 + (lane >> 3);
        if ((lane & 7) == 0 && row < r1) xt[row - r0] = w;
      }
    }
    slot_sync<S>(slot, nts);  // this CTA's xt complete

    // update this thread's rows and column from its block's xt, then the
    // next rhs
    if (mine) {
      const float* xb = sxt + buf * 3 * bpc + 3 * (blk - bl0);
      const float xt0 = xb[0], xt1 = xb[1], xt2 = xb[2];
      float axt = __fmul_rn(c0, xt0);
      axt = __fadd_rn(axt, __fmul_rn(c1, xt1));
      axt = __fadd_rn(axt, __fmul_rn(c2, xt2));
      step(axt, zf, yf, rf, lf, uf, yrf, ozf, alpha);
      if (has_col) {
        const float xj = (li == 0) ? xt0 : (li == 1) ? xt1 : xt2;
        step(__fmul_rn(bx, xj), zb, yb, rb, lb, ub, yrb, ozb, alpha);
        xv = __fadd_rn(__fmul_rn(alpha, xj), ox);
      }
    }
    if (it + 1 < iters) {
      send_rhs((it + 1) & 1);
      yrf = over(yf, rf);
      ozf = __fmul_rn(oma, zf);
      yrb = over(yb, rb);
      ozb = __fmul_rn(oma, zb);
      ox = __fmul_rn(oma, xv);
    }
  }
  // Every rhs sent to this CTA was waited for above, and no CTA reads
  // another's shared memory, so each slot may exit on its own.
  if (mine) {
    zo[bm + fi] = zf;
    yo[bm + fi] = yf;
    if (has_col) {
      zo[bm + bi] = zb;
      yo[bm + bi] = yb;
      xo[bv + col] = xv;
    }
  }
}

// Threads of a slot for bpc owned blocks: three fold passes of R rows per
// warp, and at least four threads per block.
__host__ __forceinline__ int threads_for(int bpc) {
  const int rpc = 3 * bpc;
  int warps = (rpc + kRowsPerWarp - 1) / kRowsPerWarp;
  const int wblk = (4 * bpc + 31) / 32;
  return 32 * (warps > wblk ? warps : wblk);
}

// The operands of one launch; batch <= 0 only asks where it fits.
struct Operands {
  const float *C, *box, *Minv, *q, *l, *u, *rho, *x0, *z0, *y0;
  float *xo, *zo, *yo;
  int batch, nb, iters;
  float sigma, alpha, oma;
};

// Launches the instance in clusters of csize CTAs of S slots if that shape
// fits; into *clusters how many such clusters can be resident at once (0: it
// does not fit, and nothing is launched).
template <int VPL, int KFULL, int MAXT, int MINB, int S>
int launch(const Operands& o, int csize, cudaStream_t stream, int* clusters) {
  const int bpc = (o.nb + csize - 1) / csize;
  auto kernel = admm_structured_kernel<VPL, KFULL, MAXT, MINB, S>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config((o.batch + S - 1) / S, csize,
                                                S * threads_for(bpc),
                                                S * smem_floats(o.nb, bpc) * sizeof(float),
                                                stream, &attr);
  cudaError_t err = resident_clusters(kernel, cfg, clusters);
  if (err != cudaSuccess || *clusters < 1 || o.batch <= 0) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, o.C, o.box, o.Minv, o.q, o.l, o.u, o.rho, o.x0, o.z0,
                           o.y0, o.xo, o.zo, o.yo, o.batch, o.nb, o.iters, o.sigma, o.alpha,
                           o.oma);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Scenarios a CTA runs side by side at nz = 384.
constexpr int kSlots = 3;

// The launch for nz = 3 nb, measured on the H100 (header): its slots, and
// the smallest cluster tried. nz = 384: three slots in clusters of 8, the
// smallest that holds three slots' rows; nz = 288: one slot in clusters of
// 3, two CTAs an SM; elsewhere one slot in the smallest cluster of at least
// 2 CTAs that fits (2 at nz = 120 and 192; several CTAs share an SM).
int slots_for(int nz) { return nz == 384 ? kSlots : 1; }
int min_cluster(int nz) { return nz == 384 ? 8 : nz == 288 ? 3 : 2; }

// The instance for nz = 3 nb and csize: the solver's sizes, nz = 12 x
// horizon at horizons 16, 24, 32, with whole 32-lane chunks known at
// compile time (nz = 192 in clusters of 2 fits three CTAs of 256 threads
// per SM); any other nz <= 512 by its fold width.
int launch_at(const Operands& o, int csize, cudaStream_t stream, int* clusters) {
  const int nz = 3 * o.nb;
  if (nz == 192 && csize == 2) return launch<8, 6, 256, 3, 1>(o, csize, stream, clusters);
  if (nz == 288) return launch<16, 9, 512, 1, 1>(o, csize, stream, clusters);
  if (nz == 384) return launch<16, 12, 512, 1, kSlots>(o, csize, stream, clusters);
  if (nz <= 128) return launch<4, -1, 512, 1, 1>(o, csize, stream, clusters);
  if (nz <= 256) return launch<8, -1, 512, 1, 1>(o, csize, stream, clusters);
  return launch<16, -1, 512, 1, 1>(o, csize, stream, clusters);
}

// A launch's shape: CTAs a cluster, clusters resident at once, slots a CTA.
struct Shape {
  int csize, clusters, slots;
};

// Launches o in the smallest cluster of at least min_cluster CTAs that fits
// (batch <= 0: launches nothing); its shape into *shape.
int dispatch(const Operands& o, cudaStream_t stream, Shape* shape) {
  if (o.nb < 1 || 3 * o.nb > 512) return (int)cudaErrorInvalidValue;
  shape->slots = slots_for(3 * o.nb);
  for (int c = min_cluster(3 * o.nb); c <= 8; ++c) {
    const int err = launch_at(o, c, stream, &shape->clusters);
    if (err != 0 || shape->clusters > 0) {
      shape->csize = c;
      return err;
    }
  }
  return (int)cudaErrorInvalidConfiguration;  // no cluster of up to 8 CTAs holds it
}

}  // namespace

// C entry point. C (batch, nb, 4, 3); box, q, x0, xo (batch, 3 nb);
// Minv (batch, 3 nb, 3 nb); l, u, rho, z0, y0, zo, yo (batch, 7 nb); all
// contiguous f32 on the device; 3 nb <= 512. Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidConfiguration if no cluster of up
// to 8 CTAs holds a scenario.
extern "C" int admm_structured_f32(const float* C, const float* box, const float* Minv,
                                   const float* q, const float* l, const float* u,
                                   const float* rho, const float* x0, const float* z0,
                                   const float* y0, float* xo, float* zo, float* yo,
                                   int batch, int nb, int iters, float sigma, float alpha,
                                   float oma, cudaStream_t stream) {
  const Operands o = {C, box, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo,
                      batch, nb, iters, sigma, alpha, oma};
  Shape shape;
  return dispatch(o, stream, &shape);
}

// The launch admm_structured_f32 makes for nb blocks: the CTAs of a cluster
// into *csize, how many such clusters can be resident at once into
// *clusters, and the scenarios a CTA runs into *slots. Returns a cudaError_t
// as above.
extern "C" int admm_structured_shape(int nb, int* csize, int* clusters, int* slots) {
  const Operands o = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, nullptr, 0, nb, 0, 0.f, 0.f, 0.f};
  Shape shape = {0, 0, 0};
  const int err = dispatch(o, nullptr, &shape);
  *csize = shape.csize;
  *clusters = shape.clusters;
  *slots = shape.slots;
  return err;
}

// The scenarios a CTA runs in admm_structured_f32's launch for nb blocks,
// into *slots, from nb alone (no device query). Returns a cudaError_t.
extern "C" int admm_structured_slots(int nb, int* slots) {
  if (nb < 1 || 3 * nb > 512) return (int)cudaErrorInvalidValue;
  *slots = slots_for(3 * nb);
  return 0;
}
