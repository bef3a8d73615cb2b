// The adaptive solve's per-chunk step for Hopper (sm_90a): the residual and
// convergence check after each ADMM chunk (adapt_check) and the rho step
// after the chunk's polish decision (adapt_rho), each one launch.
//
// Replaces no TPU kernel. In the JAX package this arithmetic sits inside
// admm.solve_adaptive's jitted lax.while_loop (convex_mpc_tpu/mpc/admm.py),
// where XLA fuses it; the port ran it as ~100 eager operations a chunk,
// three of them cuBLAS batched GEMVs (A x, A' y, P x), 40 chunks a cycle.
//
// What bounds adapt_check on this card. Per scenario it reads P (nz x nz
// f32) once for P x; everything else is O(nz): C's blocks (12 nb floats),
// q, d, box, x, x_prev (nz each), z and y (7 nb each). At B = 1,280, nz =
// 384 that is 755 MB of P a chunk, 0.225 ms at 3.35 TB/s; at B = 10,240,
// nz = 120, 590 MB, 0.176 ms. The 2 nz^2 flops per scenario are 20x below
// the card's f32 rate at that byte count. So the design streams P: each
// warp reads whole rows of P with 16-byte loads, lane l taking columns
// 128 k + 4 l .. + 3 of chunk k, two rows in flight a warp; the launcher
// gives a scenario W warps (nz / W >= 16 rows each, W <= 16) and a CTA
// 8 / W scenarios (at least 256 threads), so the rows of many scenarios
// are in flight at once. adapt_rho reads a few floats a scenario.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; the bound
// counting the vectors too): 0.2618 ms at B = 1,280, nz = 384, 1.12x its
// bound of 0.2334 ms; 0.2308 ms at B = 10,240, nz = 120, 1.18x of 0.1962;
// 0.0733 ms at B = 1,024, nz = 192, 1.52x of 0.0483 (one wave).
//
// Arithmetic order, pinned to the plain versions in mpc/kernels.py, which
// spell it out op by op:
//  - P x, row n: the products P[n, c] x[c] over columns padded with zeros
//    to 128 KP (KP chunks of 128, a power of two), each chunk k as lanes l
//    of four columns; the chunks halved in registers (k + h into k); then
//    in the lane (x + y) + (z + w); then across lanes by __shfl_down_sync
//    16, 8, 4, 2, 1 (lane 0 holds the row's sum);
//  - A x and A' y: kernel 2's block sums (admm_structured.cu), 3 terms and
//    4 terms in order, the box term last;
//  - the maxima are exact in any order (NaN propagates, as torch.amax);
//  - every product and sum rounded on its own (__fmul_rn, __fadd_rn, and the
//    file is compiled with -fmad=false); IEEE division, sqrtf, and the logf
//    that torch's CUDA log calls.
// The flag counts (scenarios still open, rho moved) are integer atomics, so
// exact in any order: each CTA adds its counts to a device workspace, and
// the last CTA to finish moves them to the output and leaves the workspace
// zero for the next launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 2;  // rows of P a warp has in flight

// the larger of m and v, NaN if either is (torch.amax / torch.maximum)
__device__ __forceinline__ float nmax(float m, float v) { return (v > m || v != v) ? v : m; }

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp
  return (v > hi) ? hi : v;
}

__device__ __forceinline__ float clip_lo(float v, float lo) { return (v < lo) ? lo : v; }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// columns c .. c + 3 of a row, zero at and beyond nz (VEC: nz % 4 == 0 and
// the rows 16-byte aligned, so a group is whole or wholly out)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int c, int nz) {
  if (VEC) {
    return (c < nz) ? __ldg(reinterpret_cast<const float4*>(row + c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(c < nz ? __ldg(row + c) : 0.f, c + 1 < nz ? __ldg(row + c + 1) : 0.f,
                     c + 2 < nz ? __ldg(row + c + 2) : 0.f, c + 3 < nz ? __ldg(row + c + 3) : 0.f);
}

// Adds this CTA's counts v[0..N) to ws[0..N) and counts it done in ws[N];
// the CTA that finishes last writes the totals to out and zeroes ws. Called
// by one thread of each CTA.
template <int N>
__device__ void publish(int* ws, const int (&v)[N], int* out) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (v[i]) atomicAdd(&ws[i], v[i]);
  __threadfence();
  const unsigned done = atomicAdd(reinterpret_cast<unsigned*>(&ws[N]), 1u);
  if (done == gridDim.x - 1) {
    __threadfence();
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = atomicExch(&ws[i], 0);
    atomicExch(&ws[N], 0);
  }
}

// maxima a thread folds in adapt_check's second phase
enum { kAxZ, kAx, kZ, kRd, kPx, kAty, kQ, kStep, kMax };

struct CheckArgs {
  const float *P, *C, *box, *q, *d, *x, *xp, *z, *y, *rho;
  const unsigned char* conv;
  const int* conv_it;
  float *pr, *dr, *step;
  unsigned char* conv_out;
  int* conv_it_out;
  int *ws, *open;
  int batch, nb, warps, spc, iters_done;
  float eps_abs, eps_rel, rho_accept_max, stall_tol, stall_dual_cap;
};

// One group of `warps` warps per scenario, `spc` groups a CTA. Phase 1:
// P x into shared memory, row n by warp n % warps. Phase 2: the residuals'
// maxima over the scenario's columns and rows by the group's threads, folded
// by warp shuffles and then across the group's warps. Then the group's
// first thread decides the scenario.
template <int KP, bool VEC>
__global__ void __launch_bounds__(512) adapt_check_kernel(const CheckArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_open;
  const int nb = a.nb, nz = 3 * nb, mfr = 4 * nb, m = mfr + nz, W = a.warps;
  const int gsize = 32 * W, g = threadIdx.x / gsize, t = threadIdx.x % gsize;
  const int lane = threadIdx.x & 31, w = t >> 5;
  const int b = blockIdx.x * a.spc + g;
  const bool valid = b < a.batch;
  float* px = smem + (size_t)g * nz;
  float* red = smem + (size_t)a.spc * nz + (size_t)(g * W + w) * kMax;
  if (threadIdx.x == 0) s_open = 0;

  if (valid) {
    const float* xb = a.x + (size_t)b * nz;
    float4 xr[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) xr[k] = load4<VEC>(xb, 128 * k + 4 * lane, nz);
    const float* Pb = a.P + (size_t)b * nz * nz;
    for (int n0 = w; n0 < nz; n0 += kRows * W) {
      float4 v[kRows][KP];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r * W;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          v[r][k] = (n < nz) ? load4<VEC>(Pb + (size_t)n * nz, 128 * k + 4 * lane, nz)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < KP; ++k) v[r][k] = mul4(v[r][k], xr[k]);
        if (KP == 4) {  // the halving tree over the chunks: h = 2, then h = 1
          v[r][0] = add4(v[r][0], v[r][2]);
          v[r][1] = add4(v[r][1], v[r][3]);
        }
        if (KP >= 2) v[r][0] = add4(v[r][0], v[r][1]);
        float s = __fadd_rn(__fadd_rn(v[r][0].x, v[r][0].y), __fadd_rn(v[r][0].z, v[r][0].w));
#pragma unroll
        for (int off = 16; off >= 1; off /= 2)
          s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
        const int n = n0 + r * W;
        if (lane == 0 && n < nz) px[n] = s;
      }
    }
  }
  __syncthreads();

  float mx[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) mx[i] = 0.f;
  if (valid) {
    const float* Cb = a.C + (size_t)b * nb * 12;  // [block][face][coordinate]
    const float *xb = a.x + (size_t)b * nz, *xpb = a.xp + (size_t)b * nz;
    const float *qb = a.q + (size_t)b * nz, *db = a.d + (size_t)b * nz;
    const float* bxb = a.box + (size_t)b * nz;
    const float *zb = a.z + (size_t)b * m, *yb = a.y + (size_t)b * m;
    // columns: A' y, the dual residual's terms, the step; and the box rows
    for (int j = t; j < nz; j += gsize) {
      const int blk = j / 3, r = j - 3 * blk;
      const float* Cc = Cb + 12 * blk + r;
      const float* yf = yb + 4 * blk;
      float aty = __fmul_rn(Cc[0], yf[0]);
      aty = __fadd_rn(aty, __fmul_rn(Cc[3], yf[1]));
      aty = __fadd_rn(aty, __fmul_rn(Cc[6], yf[2]));
      aty = __fadd_rn(aty, __fmul_rn(Cc[9], yf[3]));
      const float bx = bxb[j], xj = xb[j];
      aty = __fadd_rn(aty, __fmul_rn(bx, yb[mfr + j]));
      const float pj = px[j], qj = qb[j];
      mx[kRd] = nmax(mx[kRd], fabsf(__fadd_rn(__fadd_rn(pj, qj), aty)));
      mx[kPx] = nmax(mx[kPx], fabsf(pj));
      mx[kAty] = nmax(mx[kAty], fabsf(aty));
      mx[kQ] = nmax(mx[kQ], fabsf(qj));
      mx[kStep] = nmax(mx[kStep], fabsf(__fmul_rn(db[j], __fsub_rn(xj, xpb[j]))));
      const float ax = __fmul_rn(bx, xj), zj = zb[mfr + j];
      mx[kAxZ] = nmax(mx[kAxZ], fabsf(__fsub_rn(ax, zj)));
      mx[kAx] = nmax(mx[kAx], fabsf(ax));
      mx[kZ] = nmax(mx[kZ], fabsf(zj));
    }
    // friction rows: A x
    for (int i = t; i < mfr; i += gsize) {
      const int blk = i >> 2;
      const float* Cr = Cb + 3 * i;
      const float* xv = xb + 3 * blk;
      float ax = __fmul_rn(Cr[0], xv[0]);
      ax = __fadd_rn(ax, __fmul_rn(Cr[1], xv[1]));
      ax = __fadd_rn(ax, __fmul_rn(Cr[2], xv[2]));
      const float zi = zb[i];
      mx[kAxZ] = nmax(mx[kAxZ], fabsf(__fsub_rn(ax, zi)));
      mx[kAx] = nmax(mx[kAx], fabsf(ax));
      mx[kZ] = nmax(mx[kZ], fabsf(zi));
    }
  }
#pragma unroll
  for (int i = 0; i < kMax; ++i)
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      mx[i] = nmax(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kMax; ++i) red[i] = mx[i];
  __syncthreads();

  if (valid && t == 0) {
    const float* rg = smem + (size_t)a.spc * nz + (size_t)g * W * kMax;
    for (int ww = 1; ww < W; ++ww)
#pragma unroll
      for (int i = 0; i < kMax; ++i) mx[i] = nmax(mx[i], rg[ww * kMax + i]);
    const float ep = __fadd_rn(a.eps_abs, __fmul_rn(a.eps_rel, nmax(mx[kAx], mx[kZ])));
    const float ed = __fadd_rn(a.eps_abs,
                               __fmul_rn(a.eps_rel, nmax(mx[kPx], nmax(mx[kAty], mx[kQ]))));
    const float pr = __fdiv_rn(mx[kAxZ], ep), dr = __fdiv_rn(mx[kRd], ed), st = mx[kStep];
    const bool rho_ok = a.rho[b] <= a.rho_accept_max;
    const bool stalled = rho_ok && pr <= 1.0f && dr <= a.stall_dual_cap && st <= a.stall_tol;
    const bool newly = (rho_ok && pr <= 1.0f && dr <= 1.0f) || stalled;
    int it = a.conv_it[b];
    if (newly && it < 0) it = a.iters_done;
    const bool conv = a.conv[b] != 0 || newly;
    a.pr[b] = pr;
    a.dr[b] = dr;
    a.step[b] = st;
    a.conv_out[b] = conv;
    a.conv_it_out[b] = it;
    if (!conv) atomicAdd_block(&s_open, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int v[1] = {s_open};
    publish<1>(a.ws, v, a.open);
  }
}

struct RhoArgs {
  const float *pr, *dr, *step, *rho, *x, *d;
  const unsigned char *conv, *pol_ok;
  const int *conv_it, *d_count;
  float* rho_out;
  int *d_count_out, *conv_it_out;
  unsigned char *conv_out, *changed;
  int *ws, *flags;
  int batch, nz, nu, polish, apply_polish, at_boundary, rescue, max_adapts;
  float stall_tol, small_force_scale, log_ratio, rho_accept_max;
};

// One thread per scenario.
__global__ void __launch_bounds__(256) adapt_rho_kernel(const RhoArgs a) {
  __shared__ int s_cnt[2];  // rho moved, still open
  if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.batch) {
    bool conv = a.conv[b] != 0;
    int it = a.conv_it[b], dc = a.d_count[b];
    const float pr = a.pr[b], dr = a.dr[b], rho = a.rho[b];
    if (a.polish) {
      const float *xb = a.x + (size_t)b * a.nz, *db = a.d + (size_t)b * a.nz;
      float xs = 0.f;
      for (int j = 0; j < a.nu; ++j) xs = nmax(xs, fabsf(__fmul_rn(db[j], xb[j])));
      const bool step_ok = a.step[b] <= a.stall_tol || xs >= a.small_force_scale;
      if (a.apply_polish) conv = conv && a.pol_ok[b] != 0 && step_ok;
      if (!conv) it = -1;
    }
    const bool can = a.at_boundary && !conv && dc < a.max_adapts;
    const float ratio = sqrtf(__fdiv_rn(pr, clip_lo(dr, 1e-12f)));
    const float rho_desc = clip(__fmul_rn(rho, clip(ratio, 0.1f, 1.0f)), 1e-6f, 1e6f);
    const bool moved = fabsf(logf(__fdiv_rn(rho_desc, rho))) > a.log_ratio;
    const bool descend = can && moved;
    dc += descend;
    float rn = descend ? rho_desc : rho;
    const bool rho_ok = rho <= a.rho_accept_max;
    const bool rescue = a.rescue && !conv && rho_ok;
    if (rescue) {
      rn = 0.1f;
      dc = 0;
    }
    const bool gate = !conv && pr <= 1.0f && dr <= 1.0f && !rho_ok;
    if (gate) rn = clip_lo(__fmul_rn(rho, 0.1f), 1e-4f);
    const bool changed = descend || rescue || gate;
    a.rho_out[b] = rn;
    a.d_count_out[b] = dc;
    a.conv_out[b] = conv;
    a.conv_it_out[b] = it;
    a.changed[b] = changed;
    if (changed) atomicAdd_block(&s_cnt[0], 1);
    if (!conv) atomicAdd_block(&s_cnt[1], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int v[2] = {s_cnt[0], s_cnt[1]};
    publish<2>(a.ws, v, a.flags);
  }
}

// Warps per scenario (a power of two up to 16 that leaves each at least 16
// rows of P, or 1) and scenarios a CTA (at least 256 threads) for nz.
void check_shape(int nz, int* warps, int* spc) {
  int w = 1;
  while (w < 16 && nz / (2 * w) >= 16) w *= 2;
  *warps = w;
  *spc = w >= 8 ? 1 : 8 / w;
}

template <int KP, bool VEC>
int launch_check(const CheckArgs& a, cudaStream_t stream) {
  const int threads = 32 * a.warps * a.spc;
  const int blocks = (a.batch + a.spc - 1) / a.spc;
  const size_t smem = sizeof(float) * ((size_t)a.spc * 3 * a.nb + (size_t)a.spc * a.warps * kMax);
  adapt_check_kernel<KP, VEC><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. P (batch, nz, nz); C (batch, nb, 4, 3); box, q, d, x, xp
// (batch, nz); z, y (batch, 7 nb); rho, pr, dr, step (batch); conv,
// conv_out (batch) bytes 0 / 1; conv_it, conv_it_out (batch) int32; ws four
// int32 left zero by the previous launch; open (1) int32: the scenarios not
// converged. nz = 3 nb <= 512. All contiguous on the device. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int adapt_check_f32(const float* P, const float* C, const float* box, const float* q,
                               const float* d, const float* x, const float* xp, const float* z,
                               const float* y, const float* rho, const unsigned char* conv,
                               const int* conv_it, float* pr, float* dr, float* step,
                               unsigned char* conv_out, int* conv_it_out, int* ws, int* open,
                               int batch, int nb, int iters_done, float eps_abs, float eps_rel,
                               float rho_accept_max, float stall_tol, float stall_dual_cap,
                               cudaStream_t stream) {
  const int nz = 3 * nb;
  if (batch < 1 || nb < 1 || nz > 512) return (int)cudaErrorInvalidValue;
  CheckArgs a = {P, C, box, q, d, x, xp, z, y, rho, conv, conv_it, pr, dr, step, conv_out,
                 conv_it_out, ws, open, batch, nb, 0, 0, iters_done, eps_abs, eps_rel,
                 rho_accept_max, stall_tol, stall_dual_cap};
  check_shape(nz, &a.warps, &a.spc);
  const bool vec = (nz % 4 == 0) && ((uintptr_t)P % 16 == 0);
  const int kp = nz <= 128 ? 1 : nz <= 256 ? 2 : 4;
  if (kp == 1) return vec ? launch_check<1, true>(a, stream) : launch_check<1, false>(a, stream);
  if (kp == 2) return vec ? launch_check<2, true>(a, stream) : launch_check<2, false>(a, stream);
  return vec ? launch_check<4, true>(a, stream) : launch_check<4, false>(a, stream);
}

// pr, dr, step, rho, rho_out (batch) f32; x, d (batch, nz) f32; conv,
// pol_ok, conv_out, changed (batch) bytes 0 / 1; conv_it, d_count and their
// outputs (batch) int32; ws three int32 left zero by the previous launch;
// flags (2) int32: the scenarios whose rho moved, the scenarios not
// converged. polish, apply_polish, at_boundary, rescue: 0 or 1.
extern "C" int adapt_rho_f32(const float* pr, const float* dr, const float* step,
                             const float* rho, const float* x, const float* d,
                             const unsigned char* conv, const unsigned char* pol_ok,
                             const int* conv_it, const int* d_count, float* rho_out,
                             int* d_count_out, int* conv_it_out, unsigned char* conv_out,
                             unsigned char* changed, int* ws, int* flags, int batch, int nz,
                             int nu, int polish, int apply_polish, int at_boundary, int rescue,
                             int max_adapts, float stall_tol, float small_force_scale,
                             float log_ratio, float rho_accept_max, cudaStream_t stream) {
  if (batch < 1 || nu < 0 || nu > nz) return (int)cudaErrorInvalidValue;
  const RhoArgs a = {pr, dr, step, rho, x, d, conv, pol_ok, conv_it, d_count, rho_out,
                     d_count_out, conv_it_out, conv_out, changed, ws, flags, batch, nz, nu,
                     polish, apply_polish, at_boundary, rescue, max_adapts, stall_tol,
                     small_force_scale, log_ratio, rho_accept_max};
  adapt_rho_kernel<<<(batch + 255) / 256, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
