// Fused 1 kHz tick window for Hopper (sm_90a): `steps` ticks of the Go2 tick
// model, leg controller and implicit-damping plant step per scenario, in one
// launch.
//
// Replaces the TPU kernel convex_mpc_tpu/sim/tick_fused.py::run_ticks_fused
// (_window_kernel over _tick_soa), which computes engine._run_ticks for a
// whole MPC period (20 ticks on the main path, B = 512). The plain PyTorch
// version is sim/tick_fused.py::run_window_soa.
//
// Design. A group of four lanes runs one scenario for the whole window; lane
// l owns leg l. Most of a tick is per leg and independent across the legs:
// lane l evaluates leg l's part of the model (its FK chain, the column
// blocks Bt/Br, the diagonal block Dl, the foot Jacobian blocks, bias_j,
// foot position, velocity and J'dot q'dot) and its share of the trunk sums;
// leg l's blocks of each arrow factorization (Dinv, B Dinv and its term of
// the 6 x 6 Schur complement); the swing target, the operational-space
// inertia of foot l, the torques, the contact force and leg l's blocks of
// the implicit matrix. Only the trunk couples the legs. Its sums over legs
// (42 floats for the model, 27 for each Schur complement, 6 for the
// eliminated right side) are reduced across the group by __shfl_xor_sync on
// the group's mask, and every lane then computes the trunk quantities, the
// 6 x 6 factor and solve and the base integration redundantly: a + b == b + a
// in IEEE arithmetic, so both halves of each butterfly get the same bits and
// the four lanes stay in step without shared memory. Each lane carries one
// leg's blocks where one thread carried four, and its dependent chain is
// about a third as long. Its state then just fits in registers (255, no
// local memory): the window's inputs and leg l's swing state are read from
// device memory where they are used, not held across the model, and sin_cos
// below replaces sinf / cosf, with which the kernel kept a stack frame.
//
// A block is one scenario: its four lanes, one warp. At 255 registers a
// lane, 8 such warps are resident per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor, read back by tick_window_shape), 1,056 on the 132 SMs of
// an H100, so B = 512 runs in one wave: ~4 warps per SM, about one per
// scheduler, a lane's chain runs at its own latency and no other scenario's
// swing or stance branch shares its warp. Eight scenarios packed into a warp
// ran 5-7% slower at B = 512 (PERF.md, PR 6 run A); a larger B runs in more
// waves of the same blocks. The model constants (220 floats) sit in
// shared memory, loaded as float4. Each lane writes its own leg's log
// entries and a quarter of the scenario's trunk entries.
//
// The tangent. JAX's single jax.linearize tangent (velocity-product
// accelerations for the bias, and the feet's J'dot q'dot) is forward-mode
// arithmetic here: the geometry and velocity map is one template over its
// scalar type (model<T>), evaluated with T = Dual {v, d}, whose operators
// carry the derivative. q is seeded with the tangent qdot(q, dq); v, w and the joint
// rates are constants, as in _model_soa's model_fn. The value parts give the
// FK, Jacobian blocks and velocities; the derivative parts give the body
// accelerations and jdot_qd. Rotations use CUDA's atan2f and sin_cos (no
// fast math: division and sqrtf stay IEEE).
//
// What bounds it on this card. Bytes: per scenario the window reads 113
// floats of state and inputs and writes 78 floats of state and 20 x 71 floats
// of logs: 6.4 KB, 3.3 MB at B = 512, 1 us at 3.35 TB/s. Operations: worked
// out from the arithmetic of one scenario with structural zeros and constant
// ones left out (chip_smoke.py TICK_OPS, where each term is derived; an FMA
// counts 2, a transcendental 1): 14,824 per scenario-tick whatever the data
// (the Dual model 12,246, the implicit step's arrow factor 1,455 and solve
// 414), plus per leg 777 in swing (its operational-space inertia 653), 427 in
// contact (the dt J'CJ blocks 405) and 15 in stance, and 1,452 for M's arrow
// factor on a tick with a leg in swing. The lanes' redundant trunk arithmetic
// is not counted: it is not work the window needs. chip_smoke.py's B = 512
// battery needs ~18,100 per scenario-tick, 0.19 GFLOP per 20-tick window,
// 2.8 us at 67 TFLOP/s. So the bound is ~3 us, set by operations. The kernel
// stays far from it (~0.35 ms on an H100 SXM, PERF.md): 2,048 lanes, about
// one warp per scheduler, are too few to hide the latency of their dependent
// scalar chains.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kGroup = 4;   // lanes per scenario, and threads per block; lane l owns leg l
constexpr int kWarp = 32;   // the launch bound below
constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.28318530717959f;
constexpr float kGravZ = -9.81f;

// the constant table: TickConsts' fields flattened in order, m_legs4 left out
constexpr int C_HIP = 0;       // (4, 3) trunk -> hip joint
constexpr int C_THIGH = 12;    // (4, 3) hip -> thigh joint
constexpr int C_CALF = 24;     // (3,) thigh -> calf joint
constexpr int C_FOOT = 27;     // (3,) calf -> foot center
constexpr int C_HOX = 30;      // (4,) hip offsets, x
constexpr int C_HOY = 34;      // (4,) hip offsets, y
constexpr int C_MTR = 38;      // trunk mass
constexpr int C_MLEG = 39;     // (4, 3) link masses [hip, thigh, calf]
constexpr int C_COMTR = 51;    // (3,) trunk COM
constexpr int C_COMLEG = 54;   // (4, 3, 3) link COMs
constexpr int C_ITR = 90;      // (3, 3) trunk inertia
constexpr int C_ILEG = 99;     // (4, 3, 3, 3) link inertias
constexpr int C_MTOT = 207;    // total mass
constexpr int C_LIM = 208;     // (4, 3) torque limits
constexpr int kNumConsts = 220;
static_assert(kNumConsts % 4 == 0, "the table is loaded as float4");

// ---------------------------------------------------------------------------
// forward-mode scalar
// ---------------------------------------------------------------------------
struct Dual {
  float v, d;
  __device__ Dual() {}
  __device__ Dual(float v_, float d_ = 0.0f) : v(v_), d(d_) {}
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.v * b.d + a.d * b.v);
}
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.d); }

// sin and cos of x: CUDA's sinf / cosf without their Payne-Hanek path. The
// same 3-constant Cody-Waite reduction to [-pi/4, pi/4] (exact to f32
// rounding for |x| < 105615; the window's angles are joint angles, yaw and
// half a tick's rotation) and the Cephes minimax polynomials. The slow path
// for larger |x| keeps a 7-word array in local memory, which would be the
// kernel's only stack frame.
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  const int q = __float2int_rn(x * 0.636619772f);  // x / (pi / 2), nearest
  const float k = (float)q;
  float r = fmaf(k, -1.57079601e+00f, x);
  r = fmaf(k, -3.13916473e-07f, r);
  r = fmaf(k, -5.39030253e-15f, r);
  r = isinf(x) ? x - x : r;  // NaN, as sinf (inf) gives
  const float r2 = r * r;
  float ps = fmaf(-1.95152959e-04f, r2, 8.33216087e-03f);
  ps = fmaf(ps, r2, -1.66666546e-01f);
  ps = fmaf(ps * r2, r, r);  // sin r
  float pc = fmaf(2.44331571e-05f, r2, -1.38873163e-03f);
  pc = fmaf(pc, r2, 4.16666457e-02f);
  pc = fmaf(pc, r2, -5.00000000e-01f);
  pc = fmaf(pc, r2, 1.0f);  // cos r
  const float sq = (q & 1) ? pc : ps, cq = (q & 1) ? ps : pc;
  *s = (q & 2) ? -sq : sq;
  *c = ((q + 1) & 2) ? -cq : cq;
}

__device__ __forceinline__ void sin_cos(Dual a, Dual* s, Dual* c) {
  float sv, cv;
  sin_cos(a.v, &sv, &cv);
  *s = Dual(sv, cv * a.d);
  *c = Dual(cv, -sv * a.d);
}
__device__ __forceinline__ float val(Dual a) { return a.v; }
__device__ __forceinline__ float der(Dual a) { return a.d; }

// ---------------------------------------------------------------------------
// 3-vectors and row-major 3x3 matrices over a scalar type
// ---------------------------------------------------------------------------
template <class T>
__device__ __forceinline__ void mm(const T* A, const T* B, T* C) {  // C = A B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
template <class T>
__device__ __forceinline__ void mtm(const T* A, const T* B, T* C) {  // C = A' B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}
template <class T>
__device__ __forceinline__ void mmt(const T* A, const T* B, T* C) {  // C = A B'
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}
template <class T, class S, class R>
__device__ __forceinline__ void mv(const T* A, const S* x, R* y) {  // y = A x
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
template <class T, class S, class R>
__device__ __forceinline__ void mtv(const T* A, const S* x, R* y) {  // y = A' x
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = A[i] * x[0] + A[3 + i] * x[1] + A[6 + i] * x[2];
}
template <class T, class S, class R>
__device__ __forceinline__ void cross(const T* a, const S* b, R* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
template <int N>
__device__ __forceinline__ void add_to(float* acc, const float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += x[i];
}
template <int N>
__device__ __forceinline__ void copy(const float* x, float* y) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = x[i];
}
template <int N>
__device__ __forceinline__ void zero(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}
template <int N, class T>
__device__ __forceinline__ void values(const T* x, float* y) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = val(x[i]);
}

// the sum of v over the scenario's lane group, the same bits in every lane
__device__ __forceinline__ float group_sum(float v, unsigned gm) {
  v += __shfl_xor_sync(gm, v, 1, kGroup);
  return v + __shfl_xor_sync(gm, v, 2, kGroup);
}
template <int N>
__device__ __forceinline__ void group_sum(float* v, unsigned gm) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = group_sum(v[i], gm);
}

// adjugate 3x3 inverse (tick_fused._inv3)
__device__ __forceinline__ void inv3(const float* A, float* Ai) {
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5];
  const float g = A[6], h = A[7], i = A[8];
  const float r00 = e * i - f * h, r01 = c * h - b * i, r02 = b * f - c * e;
  const float r10 = f * g - d * i, r11 = a * i - c * g, r12 = c * d - a * f;
  const float r20 = d * h - e * g, r21 = b * g - a * h, r22 = a * e - b * d;
  const float det = a * r00 + b * r10 + c * r20;
  Ai[0] = r00 / det; Ai[1] = r01 / det; Ai[2] = r02 / det;
  Ai[3] = r10 / det; Ai[4] = r11 / det; Ai[5] = r12 / det;
  Ai[6] = r20 / det; Ai[7] = r21 / det; Ai[8] = r22 / det;
}

template <class T>
__device__ __forceinline__ void quat_to_R(const T* qu, T* R) {
  const T x = qu[0], y = qu[1], z = qu[2], w = qu[3];
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}
template <class T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* c) {
  c[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  c[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  c[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  c[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}
template <class T>
__device__ __forceinline__ void rot_x(T a, T* R) {
  T s, c;
  sin_cos(a, &s, &c);
  R[0] = T(1.0f); R[1] = T(0.0f); R[2] = T(0.0f);
  R[3] = T(0.0f); R[4] = c; R[5] = -s;
  R[6] = T(0.0f); R[7] = s; R[8] = c;
}
template <class T>
__device__ __forceinline__ void rot_y(T a, T* R) {
  T s, c;
  sin_cos(a, &s, &c);
  R[0] = c; R[1] = T(0.0f); R[2] = s;
  R[3] = T(0.0f); R[4] = T(1.0f); R[5] = T(0.0f);
  R[6] = -s; R[7] = T(0.0f); R[8] = c;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = (v < lo) ? lo : v;  // NaN passes through, as torch.clamp does
  return (v > hi) ? hi : v;
}
__device__ __forceinline__ float floor_mod(float a, float b) {  // jnp.mod / torch.remainder
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

// ---------------------------------------------------------------------------
// the model (tick_fused._model_soa): arrow-block M, bias, feet, COM
// ---------------------------------------------------------------------------
// One lane's part: the trunk blocks, the same in every lane of the group, and
// leg l's blocks.
struct Model {
  float R[9];                       // base_R
  float Mtr[9], Mrr[9];             // Mtt = m_tot I
  float bias_t[3], bias_r[3];
  float com[3], vcom[3];
  float Bt[9], Br[9], Dl[9];        // leg l's column blocks and diagonal block
  float bias_j[3];
  float Af[9], Qf[9];               // foot l's Jacobian blocks (base-linear block is R)
  float foot_pos[3], foot_vel[3], jdot[3];
};

// A cols_j = cross(R[:, j], p - base_p)
template <class T>
__device__ __forceinline__ void a_block(const T* R, const T* p, const T* bp, T* A) {
  T rel[3] = {p[0] - bp[0], p[1] - bp[1], p[2] - bp[2]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T col[3] = {R[j], R[3 + j], R[6 + j]}, c[3];
    cross(col, rel, c);
    A[j] = c[0]; A[3 + j] = c[1]; A[6 + j] = c[2];
  }
}

// world inertia R I R'
__device__ __forceinline__ void world_inertia(const float* R, const float* I, float* Iw) {
  float t[9];
  mm(R, I, t);
  mmt(t, R, Iw);
}

// N = I alpha + w x (I w)
__device__ __forceinline__ void euler_torque(const float* I, const float* alpha, const float* w,
                                             float* N) {
  float Ia[3], Iw[3], c[3];
  mv(I, alpha, Ia);
  mv(I, w, Iw);
  cross(w, Iw, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) N[i] = Ia[i] + c[i];
}

// The geometry and velocity map, written once over the scalar type T and
// evaluated with T = Dual: values are the primal, derivatives the tangent.
// qb: the base's 7 coordinates, qj: leg l's 3 joints; v, w: the base rates,
// qdl: leg l's joint rates. The legs' trunk sums are reduced over the group.
template <class T>
__device__ __forceinline__ void model(const float* cs, const T* qb, const T* qj, const float* v,
                                      const float* w, const float* qdl, int l, unsigned gm,
                                      Model& md) {
  const float grav[3] = {0.0f, 0.0f, kGravZ};
  const T bp[3] = {qb[0], qb[1], qb[2]};
  T R[9], Rv[3], Rw[3];
  quat_to_R(qb + 3, R);
  mv(R, v, Rv);
  mv(R, w, Rw);
  float Rf[9];
  values<9>(R, Rf);
  copy<9>(Rf, md.R);

  // leg l's share of the trunk sums
  float SA[9], AtA[9], SI[9], SF[3], SN[3], bias_rA[3], com_acc[3], vcom_acc[3];
  zero<9>(SA); zero<9>(AtA); zero<9>(SI);
  zero<3>(SF); zero<3>(SN); zero<3>(bias_rA); zero<3>(com_acc); zero<3>(vcom_acc);
  // leg l's own blocks
  float SQ[9], SIW[9], BrA[9], Dl[9], bj[3];
  zero<9>(SQ); zero<9>(SIW); zero<9>(BrA); zero<9>(Dl); zero<3>(bj);

  // the chain, one body at a time: Rb is body b's frame, pb[j] and ax[j]
  // joint j's position and axis
  T Rb[9], pb[3][3], ax[3][3];
  {
    T E[9], t[3];
    rot_x(qj[0], E);
    mm(R, E, Rb);
    mv(R, cs + C_HIP + 3 * l, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pb[0][i] = bp[i] + t[i];
      ax[0][i] = R[3 * i];  // hip axis: base x column
    }
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if (b > 0) {
      T E[9], t[3], Rn[9];
      rot_y(qj[b], E);
      mm(Rb, E, Rn);
      mv(Rb, b == 1 ? cs + C_THIGH + 3 * l : cs + C_CALF, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pb[b][i] = pb[b - 1][i] + t[i];
        ax[b][i] = Rb[3 * i + 1];  // thigh / calf axis: the parent's y column
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) Rb[i] = Rn[i];
    }
    const float m = cs[C_MLEG + 3 * l + b];
    T com_b[3], A_b[9], Q_b[9], W_b[9];
    {
      T t[3];
      mv(Rb, cs + C_COMLEG + 9 * l + 3 * b, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) com_b[i] = pb[b][i] + t[i];
    }
    a_block(R, com_b, bp, A_b);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T c[3] = {T(0.0f), T(0.0f), T(0.0f)}, wc[3] = {T(0.0f), T(0.0f), T(0.0f)};
      if (j <= b) {  // body b moves with joints j <= b
        T arm[3] = {com_b[0] - pb[j][0], com_b[1] - pb[j][1], com_b[2] - pb[j][2]};
        cross(ax[j], arm, c);
#pragma unroll
        for (int i = 0; i < 3; ++i) wc[i] = ax[j][i];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Q_b[3 * i + j] = c[i];
        W_b[3 * i + j] = wc[i];
      }
    }
    T vb[3], wb[3];
    {
      T t1[3], t2[3];
      mv(A_b, w, t1);
      mv(Q_b, qdl, t2);
#pragma unroll
      for (int i = 0; i < 3; ++i) vb[i] = Rv[i] + t1[i] + t2[i];
      mv(W_b, qdl, t1);
#pragma unroll
      for (int i = 0; i < 3; ++i) wb[i] = Rw[i] + t1[i];
    }
    float Ab[9], Qb[9], Wb[9], Rbf[9], Ib[9];
    values<9>(A_b, Ab);
    values<9>(Q_b, Qb);
    values<9>(W_b, Wb);
    values<9>(Rb, Rbf);
    world_inertia(Rbf, cs + C_ILEG + 27 * l + 9 * b, Ib);

    float t9[9], u9[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      SA[i] += m * Ab[i];
      SI[i] += Ib[i];
      SQ[i] += m * Qb[i];
    }
    mtm(Ab, Ab, t9);
#pragma unroll
    for (int i = 0; i < 9; ++i) AtA[i] += m * t9[i];
    mm(Ib, Wb, t9);
    add_to<9>(SIW, t9);
    mtm(Wb, t9, u9);  // W' I W
    mtm(Qb, Qb, t9);
#pragma unroll
    for (int i = 0; i < 9; ++i) Dl[i] += m * t9[i] + u9[i];
    mtm(Ab, Qb, t9);
#pragma unroll
    for (int i = 0; i < 9; ++i) BrA[i] += m * t9[i];

    float F[3], N[3], wv[3], al[3], t3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      F[i] = m * (der(vb[i]) - grav[i]);
      wv[i] = val(wb[i]);
      al[i] = der(wb[i]);
      com_acc[i] += m * val(com_b[i]);
      vcom_acc[i] += m * val(vb[i]);
    }
    euler_torque(Ib, al, wv, N);
    add_to<3>(SF, F);
    add_to<3>(SN, N);
    mtv(Ab, F, t3);
    add_to<3>(bias_rA, t3);
    mtv(Qb, F, t3);
    add_to<3>(bj, t3);
    mtv(Wb, N, t3);
    add_to<3>(bj, t3);
  }

  // the foot: a point on the calf that sees all three joints
  {
    T foot[3], A_f[9], Q_f[9];
    {
      T t[3];
      mv(Rb, cs + C_FOOT, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) foot[i] = pb[2][i] + t[i];
    }
    a_block(R, foot, bp, A_f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T arm[3] = {foot[0] - pb[j][0], foot[1] - pb[j][1], foot[2] - pb[j][2]}, c[3];
      cross(ax[j], arm, c);
#pragma unroll
      for (int i = 0; i < 3; ++i) Q_f[3 * i + j] = c[i];
    }
    T t1[3], t2[3];
    mv(A_f, w, t1);
    mv(Q_f, qdl, t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T fv = Rv[i] + t1[i] + t2[i];
      md.foot_pos[i] = val(foot[i]);
      md.foot_vel[i] = val(fv);
      md.jdot[i] = der(fv);
    }
    values<9>(A_f, md.Af);
    values<9>(Q_f, md.Qf);
  }
  {
    float t9[9];
    mtm(Rf, SQ, md.Bt);
    mtm(Rf, SIW, t9);
#pragma unroll
    for (int i = 0; i < 9; ++i) md.Br[i] = BrA[i] + t9[i];
    copy<9>(Dl, md.Dl);
    copy<3>(bj, md.bias_j);
  }

  // the trunk sums: the four legs' shares, then the trunk body's own terms
  group_sum<9>(SA, gm);
  group_sum<9>(AtA, gm);
  group_sum<9>(SI, gm);
  group_sum<3>(SF, gm);
  group_sum<3>(SN, gm);
  group_sum<3>(bias_rA, gm);
  group_sum<3>(com_acc, gm);
  group_sum<3>(vcom_acc, gm);
  {
    const float mtr = cs[C_MTR];
    T com_tr[3], A_tr[9], v_tr[3];
    {
      T t[3];
      mv(R, cs + C_COMTR, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) com_tr[i] = bp[i] + t[i];
    }
    a_block(R, com_tr, bp, A_tr);
    {
      T t[3];
      mv(A_tr, w, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) v_tr[i] = Rv[i] + t[i];
    }
    float Atr[9], Itr[9], t9[9];
    values<9>(A_tr, Atr);
    world_inertia(Rf, cs + C_ITR, Itr);
    mtm(Atr, Atr, t9);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      SA[i] += mtr * Atr[i];
      AtA[i] += mtr * t9[i];
      SI[i] += Itr[i];
    }
    float F_tr[3], w_tr[3], alpha_tr[3], N_tr[3], t3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      F_tr[i] = mtr * (der(v_tr[i]) - grav[i]);
      w_tr[i] = val(Rw[i]);
      alpha_tr[i] = der(Rw[i]);
      com_acc[i] += mtr * val(com_tr[i]);
      vcom_acc[i] += mtr * val(v_tr[i]);
    }
    euler_torque(Itr, alpha_tr, w_tr, N_tr);
    add_to<3>(SF, F_tr);
    add_to<3>(SN, N_tr);
    mtv(Atr, F_tr, t3);  // A_tr' F_tr
    add_to<3>(bias_rA, t3);
  }

  mtm(Rf, SA, md.Mtr);
  {
    float t9[9], u9[9];
    mm(SI, Rf, t9);
    mtm(Rf, t9, u9);
#pragma unroll
    for (int i = 0; i < 9; ++i) md.Mrr[i] = AtA[i] + u9[i];
  }
  float t3[3];
  mtv(Rf, SF, md.bias_t);
  mtv(Rf, SN, t3);
  const float mtot = cs[C_MTOT];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    md.bias_r[i] = bias_rA[i] + t3[i];
    md.com[i] = com_acc[i] / mtot;
    md.vcom[i] = vcom_acc[i] / mtot;
  }
}

// ---------------------------------------------------------------------------
// arrow factorization and solves (tick_fused._arrow_factor_soa / _arrow_solve_vec)
// ---------------------------------------------------------------------------
struct Arrow {
  float itt[9], itr[9], irr[9];  // blocks of the 6x6 Schur complement's inverse (trunk)
  float Dinv[9], BDt[9], BDr[9];  // leg l's
};

// The arrow matrix [[mtt I + sum Ptt, Str0 + sum Ptr, Bt_l], [., Srr0 + sum
// Prr, Br_l], [., ., Dl_l]] with Ptt/Ptr/Prr leg l's extra trunk terms (the
// arguments are overwritten). Lane l factors leg l's block; the Schur
// complement's leg terms are reduced over the group.
__device__ __forceinline__ void arrow_factor(float mtt_diag, const float* Str0, const float* Srr0,
                                             const float* Bt, const float* Br, const float* Dl,
                                             float* Ptt, float* Ptr, float* Prr, unsigned gm,
                                             Arrow& f) {
  float t9[9];
  inv3(Dl, f.Dinv);
  mm(Bt, f.Dinv, f.BDt);
  mm(Br, f.Dinv, f.BDr);
  mmt(f.BDt, Bt, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) Ptt[i] -= t9[i];
  mmt(f.BDt, Br, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) Ptr[i] -= t9[i];
  mmt(f.BDr, Br, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) Prr[i] -= t9[i];
  group_sum<9>(Ptt, gm);
  group_sum<9>(Ptr, gm);
  group_sum<9>(Prr, gm);
  float Stt[9], Str[9], Srr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    Stt[i] = Ptt[i] + ((i % 4 == 0) ? mtt_diag : 0.0f);
    Str[i] = Str0[i] + Ptr[i];
    Srr[i] = Srr0[i] + Prr[i];
  }
  float Pi[9], W[9], T[9];
  inv3(Stt, Pi);
  mm(Pi, Str, W);
  mtm(Str, W, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) T[i] = Srr[i] - t9[i];
  inv3(T, f.irr);
  mm(W, f.irr, t9);  // W Ti
  float u9[9];
  mmt(t9, W, u9);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f.itt[i] = Pi[i] + u9[i];
    f.itr[i] = -t9[i];
  }
}

// operational-space inertia of foot l: (J M^-1 J')^-1 (tick_fused._lambda_feet)
__device__ __forceinline__ void lambda_foot(const Arrow& f, const Model& md, float* lam) {
  float Lt[9], Lr[9], Lj[9], t9[9], ut[9], ur[9], xt[9], xr[9], xj[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Lt[3 * i + j] = md.R[3 * j + i];
      Lr[3 * i + j] = md.Af[3 * j + i];
      Lj[3 * i + j] = md.Qf[3 * j + i];
    }
  mm(f.BDt, Lj, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) ut[i] = Lt[i] - t9[i];
  mm(f.BDr, Lj, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) ur[i] = Lr[i] - t9[i];
  mm(f.itt, ut, xt);
  mm(f.itr, ur, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) xt[i] += t9[i];
  mtm(f.itr, ut, xr);  // S^-1 is symmetric: its lower-left block is itr'
  mm(f.irr, ur, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) xr[i] += t9[i];
  float r9[9], u9[9];
  mtm(md.Bt, xt, t9);
  mtm(md.Br, xr, u9);
#pragma unroll
  for (int i = 0; i < 9; ++i) r9[i] = Lj[i] - t9[i] - u9[i];
  mm(f.Dinv, r9, xj);
  float JMJt[9];
  mm(md.R, xt, JMJt);
  mm(md.Af, xr, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) JMJt[i] += t9[i];
  mm(md.Qf, xj, t9);
#pragma unroll
  for (int i = 0; i < 9; ++i) JMJt[i] += t9[i];
  inv3(JMJt, lam);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
struct Args {
  // carry in
  const float *q, *dq;
  const int* last_mask;
  const float *takeoff, *swing_p0, *swing_td, *yaw_cont, *yaw_prev, *vfilt, *t;
  // window inputs
  const float *u0, *pos_des, *vel_des, *yaw_rate, *period, *duty, *phase, *swing_h, *td_z;
  const float *kn, *dn, *mu, *vtol, *gz, *fr, *arm, *jd, *consts;
  // carry out
  float *q_o, *dq_o;
  int* last_mask_o;
  float *takeoff_o, *swing_p0_o, *swing_td_o, *yaw_cont_o, *yaw_prev_o, *vfilt_o, *t_o;
  // per-tick logs (B, steps, ...)
  float *x_vec, *q_log, *tau_log, *fpd_log, *fpn_log;
  int* mask_log;
};
constexpr int kNumPtrs = 44;
static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args holds the 44 pointers");

struct Gains {
  float kp, kd, touch_z, foot_radius, early_fz;
};

// lane l's share of n trunk entries: entry i belongs to lane i % 4
template <int N>
__device__ __forceinline__ void store_share(float* dst, const float* x, int l) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i % kGroup == l) dst[i] = x[i];
}

// The launch is one group a block, so b = blockIdx.x, l = threadIdx.x, the
// mask 0xF and no lane leaves. The index arithmetic and bound below are the
// general ones for blocks of up to eight groups all the same: at 255
// registers the kernel keeps no stack frame with them, and kept 16 bytes
// with those constants written in and a bound of four threads (PERF.md,
// PR 6 run E).
__global__ void __launch_bounds__(kWarp)
tick_window_kernel(Args a, int batch, int steps, float dt, float alpha, Gains g) {
  __shared__ __align__(16) float cs[kNumConsts];
  {
    const float4* src = reinterpret_cast<const float4*>(a.consts);
    float4* dst = reinterpret_cast<float4*>(cs);
#pragma unroll 4
    for (int i = threadIdx.x; i < kNumConsts / 4; i += blockDim.x) dst[i] = __ldg(src + i);
  }
  __syncthreads();
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const int l = threadIdx.x % kGroup;  // this lane's leg
  if (b >= batch) return;
  const unsigned gm = 0xFu << ((threadIdx.x % kWarp) & ~(kGroup - 1));

  // carried state in registers: the base, the velocity filter, yaw and clock
  // (every lane) and leg l's joints
  float qb[7], qj[3], v[3], w[3], qd[3], vfilt[6];
#pragma unroll
  for (int i = 0; i < 7; ++i) qb[i] = a.q[19 * b + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    qj[i] = a.q[19 * b + 7 + 3 * l + i];
    v[i] = a.dq[18 * b + i];
    w[i] = a.dq[18 * b + 3 + i];
    qd[i] = a.dq[18 * b + 6 + 3 * l + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) vfilt[i] = a.vfilt[6 * b + i];
  float yc = a.yaw_cont[b], yp = a.yaw_prev[b], t = a.t[b];
  // Leg l's swing state lives in its carry-out entries, read and written by
  // the controller, and the window's inputs are read where they are used:
  // the logs' stores may alias them, so the compiler holds neither in
  // registers across the model, the tick's peak of live values.
  int* last_mask = a.last_mask_o + 4 * b + l;
  float* takeoff = a.takeoff_o + 4 * b + l;
  float* p0 = a.swing_p0_o + 12 * b + 3 * l;
  float* td = a.swing_td_o + 12 * b + 3 * l;
  *last_mask = a.last_mask[4 * b + l];
  *takeoff = a.takeoff[4 * b + l];
  copy<3>(a.swing_p0 + 12 * b + 3 * l, p0);
  copy<3>(a.swing_td + 12 * b + 3 * l, td);

  Model md;
  Arrow fac;
  for (int step = 0; step < steps; ++step) {
    // attitude and yaw unwrap (rotations.yaw_unwrap_step)
    float Rq[9];
    quat_to_R(qb + 3, Rq);
    const float pitch = atan2f(-Rq[6], sqrtf(Rq[0] * Rq[0] + Rq[3] * Rq[3]));
    const float yaw_m = atan2f(Rq[3], Rq[0]);
    const float roll = atan2f(Rq[7], Rq[8]);
    yc = yc + (floor_mod(yaw_m - yp + kPi, kTwoPi) - kPi);
    yp = yaw_m;

    {
      Dual qbD[7], qjD[3];
      float pdot[3], qq[4];
      mv(Rq, v, pdot);  // position rate R v
      const float om[4] = {w[0], w[1], w[2], 0.0f};
      quat_mul(qb + 3, om, qq);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        qbD[i] = Dual(qb[i], pdot[i]);
        qjD[i] = Dual(qj[i], qd[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) qbD[3 + i] = Dual(qb[3 + i], 0.5f * qq[i]);
      model(cs, qbD, qjD, v, w, qd, l, gm, md);
    }

    // velocity estimator: raw6 = [vcom_world, omega_world]
    float raw6[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) raw6[i] = md.vcom[i];
    mv(md.R, w, raw6 + 3);
#pragma unroll
    for (int i = 0; i < 6; ++i) vfilt[i] = vfilt[i] + alpha * (raw6[i] - vfilt[i]);

    // leg controller (leg.compute_torques), leg l
    const float period = a.period[b], duty = a.duty[b];
    const float t_swing = (1.0f - duty) * period;
    const float big_t = t_swing + 0.5f * (duty * period);
    const float safe_ts = (t_swing > 0.0f) ? t_swing : 1.0f;
    const int mask = floor_mod(a.phase[4 * b + l] + t / period, 1.0f) < duty ? 1 : 0;
    const bool swing = mask == 0;
    if (swing && mask != *last_mask) {  // take-off: latch the swing's start and target
      float sy, cy;
      sin_cos(yc, &sy, &cy);
      const float k_v_x = 0.4f * big_t, k_v_y = 0.2f * big_t;
      const float k_p_x = 0.1f, k_p_y = 0.05f;
      const float pred_time = big_t / 2.0f, yaw_rate = a.yaw_rate[b];
      const float hx = cs[C_HOX + l], hy = cs[C_HOY + l];
      const float hip_rel_x = cy * hx - sy * hy;
      const float hip_rel_y = sy * hx + cy * hy;
      const float* pos_des = a.pos_des + 3 * b;
      const float* vel_des = a.vel_des + 3 * b;
      *takeoff = t;
      copy<3>(md.foot_pos, p0);
      td[0] = qb[0] + hip_rel_x + vel_des[0] * pred_time + k_p_x * (md.com[0] - pos_des[0]) +
              k_v_x * (vfilt[0] - vel_des[0]) + (-(yaw_rate * pred_time)) * hip_rel_y;
      td[1] = qb[1] + hip_rel_y + vel_des[1] * pred_time + k_p_y * (md.com[1] - pos_des[1]) +
              k_v_y * (vfilt[1] - vel_des[1]) + (yaw_rate * pred_time) * hip_rel_x;
      td[2] = a.td_z[b];
    }
    *last_mask = mask;
    // min-jerk swing (gait.swing_eval)
    const float t_since = t - *takeoff;
    float p_des[3], v_des[3], a_des[3];
    {
      const float s = (t_swing > 0.0f) ? clip(t_since / safe_ts, 0.0f, 1.0f) : 1.0f;
      const float s2 = s * s, s3 = s2 * s, s4 = s3 * s, s5 = s4 * s, r = 1.0f - s;
      const float mj = 10.0f * s3 - 15.0f * s4 + 6.0f * s5;
      const float dmj = 30.0f * s2 - 60.0f * s3 + 30.0f * s4;
      const float d2mj = 60.0f * s - 180.0f * s2 + 120.0f * s3;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float dp = td[i] - p0[i];
        p_des[i] = p0[i] + dp * mj;
        v_des[i] = dp * dmj / safe_ts;
        a_des[i] = dp * d2mj / (safe_ts * safe_ts);
      }
      const float bump = 64.0f * s3 * (r * r * r);
      const float dbump = 192.0f * s2 * (r * r) * (1.0f - 2.0f * s);
      const float d2bump = 192.0f * (2.0f * s * (r * r) * (1.0f - 2.0f * s) -
                                     2.0f * s2 * r * (1.0f - 2.0f * s) - 2.0f * s2 * (r * r));
      const float swing_h = a.swing_h[b];
      p_des[2] += swing_h * bump;
      v_des[2] += swing_h * dbump / safe_ts;
      a_des[2] += swing_h * d2bump / (safe_ts * safe_ts);
    }

    // operational-space feedforward: only a swing leg's torque reads it, so
    // M's arrow factor runs on the ticks where a leg of the scenario swings
    // (a branch the whole group takes together)
    float f_ff[3] = {0.0f, 0.0f, 0.0f};
    if (__any_sync(gm, swing)) {
      float Ptt[9], Ptr[9], Prr[9], lam[9], e[3];
      zero<9>(Ptt); zero<9>(Ptr); zero<9>(Prr);
      arrow_factor(cs[C_MTOT], md.Mtr, md.Mrr, md.Bt, md.Br, md.Dl, Ptt, Ptr, Prr, gm, fac);
      lambda_foot(fac, md, lam);
#pragma unroll
      for (int i = 0; i < 3; ++i) e[i] = a_des[i] - md.jdot[i];
      mv(lam, e, f_ff);
    }
    float tau[3], pos_des_log[3];
    {
      float force_sw[3], tau_sw[3], tau_st[3], tau_e[3], neg_u0[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        force_sw[i] = g.kp * (p_des[i] - md.foot_pos[i]) + g.kd * (v_des[i] - md.foot_vel[i]) +
                      f_ff[i];
        neg_u0[i] = -a.u0[12 * b + 3 * l + i];
      }
      mtv(md.Qf, force_sw, tau_sw);
#pragma unroll
      for (int i = 0; i < 3; ++i) tau_sw[i] += md.bias_j[i];
      mtv(md.Qf, neg_u0, tau_st);

      // early contact: divides by the raw swing time, as leg.compute_torques does
      const float s_phase = clip(t_since / t_swing, 0.0f, 1.0f);
      const bool touching = md.foot_pos[2] - g.foot_radius <= g.touch_z;
      const bool early = swing && (s_phase > 0.5f) && touching;
      const float fx = g.kp * (td[0] - md.foot_pos[0]) - g.kd * md.foot_vel[0];
      const float fy = g.kp * (td[1] - md.foot_pos[1]) - g.kd * md.foot_vel[1];
      const float f_cap = 0.8f * g.early_fz;
      const float f_norm = sqrtf(fx * fx + fy * fy);
      const float k = fminf(1.0f, f_cap / fmaxf(f_norm, 1e-6f));
      const float f_early[3] = {fx * k, fy * k, -g.early_fz};
      mtv(md.Qf, f_early, tau_e);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float lim = cs[C_LIM + 3 * l + i];
        tau[i] = clip(early ? tau_e[i] : (swing ? tau_sw[i] : tau_st[i]), -lim, lim);
        pos_des_log[i] = swing ? p_des[i] : md.foot_pos[i];
      }
    }

    // logs of this tick (q before the step): leg l's entries, and lane l
    // writes x_vec[3l : 3l + 3] and its share of the base coordinates
    {
      const size_t bt = (size_t)b * steps + step;
      float xv[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rpy = i == 0 ? roll : (i == 1 ? pitch : yc);
        xv[i] = l == 0 ? md.com[i] : (l == 1 ? rpy : (l == 2 ? raw6[i] : raw6[3 + i]));
      }
      copy<3>(xv, a.x_vec + 12 * bt + 3 * l);
      store_share<7>(a.q_log + 19 * bt, qb, l);
      copy<3>(qj, a.q_log + 19 * bt + 7 + 3 * l);
      a.mask_log[4 * bt + l] = mask;
      copy<3>(tau, a.tau_log + 12 * bt + 3 * l);
      copy<3>(pos_des_log, a.fpd_log + 12 * bt + 3 * l);
      copy<3>(md.foot_pos, a.fpn_log + 12 * bt + 3 * l);
    }

    // plant step (physics.step, implicit contact damping): leg l's contact
    const float arm = a.arm[b];
    float f0[3], Cd[3];
    {
      const float kn = a.kn[b], dn = a.dn[b];
      const float pen = a.gz[b] - (md.foot_pos[2] - a.fr[b]);
      const bool active = pen > 0.0f;
      const float fz_est = fmaxf(active ? kn * pen - dn * md.foot_vel[2] : 0.0f, 0.0f);
      const float vt = sqrtf(md.foot_vel[0] * md.foot_vel[0] + md.foot_vel[1] * md.foot_vel[1]);
      const float ct = active ? a.mu[b] * fz_est / fmaxf(a.vtol[b], vt) : 0.0f;
      f0[0] = 0.0f;
      f0[1] = 0.0f;
      f0[2] = active ? kn * pen : 0.0f;
      Cd[0] = ct;
      Cd[1] = ct;
      Cd[2] = (active && fz_est > 0.0f) ? dn : 0.0f;
    }
    // A = M + diag(arm) + dt (J' C J + diag(jd)), arrow blocks: leg l's
    // blocks, and its terms of the trunk blocks in P*
    float ABt[9], ABr[9], ADl[9], Ptt[9], Ptr[9], Prr[9];
    {
      float CR[9], CA[9], CQ[9], t9[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          CR[3 * i + j] = Cd[i] * md.R[3 * i + j];
          CA[3 * i + j] = Cd[i] * md.Af[3 * i + j];
          CQ[3 * i + j] = Cd[i] * md.Qf[3 * i + j];
        }
      mtm(md.R, CR, t9);
#pragma unroll
      for (int i = 0; i < 9; ++i) Ptt[i] = dt * t9[i];
      mtm(md.R, CA, t9);
#pragma unroll
      for (int i = 0; i < 9; ++i) Ptr[i] = dt * t9[i];
      mtm(md.Af, CA, t9);
#pragma unroll
      for (int i = 0; i < 9; ++i) Prr[i] = dt * t9[i];
      mtm(md.R, CQ, t9);
#pragma unroll
      for (int i = 0; i < 9; ++i) ABt[i] = md.Bt[i] + dt * t9[i];
      mtm(md.Af, CQ, t9);
#pragma unroll
      for (int i = 0; i < 9; ++i) ABr[i] = md.Br[i] + dt * t9[i];
      mtm(md.Qf, CQ, t9);
      const float diag = arm + dt * a.jd[b];
#pragma unroll
      for (int i = 0; i < 9; ++i) ADl[i] = md.Dl[i] + ((i % 4 == 0) ? diag : 0.0f) + dt * t9[i];
    }
    // right side rhs = (M + diag(arm)) dq + dt (tau_gen - bias + J' f0): leg
    // l's rows
    float rj[3];
    {
      float Mv_j[3], Jf_j[3], t3[3], u3[3];
      mtv(md.Bt, v, Mv_j);
      mtv(md.Br, w, t3);
      mv(md.Dl, qd, u3);
      mtv(md.Qf, f0, Jf_j);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Mv_j[i] += t3[i] + u3[i] + arm * qd[i];
        rj[i] = Mv_j[i] + dt * (tau[i] - md.bias_j[i] + Jf_j[i]);
      }
    }
    const float mtot = cs[C_MTOT];
    arrow_factor(mtot, md.Mtr, md.Mrr, ABt, ABr, ADl, Ptt, Ptr, Prr, gm, fac);
    // the trunk rows with the legs eliminated: u = r_trunk - sum_l BD_l rj_l,
    // leg l's terms reduced over the group
    float xt[3], xr[3], xj[3];
    {
      float pt[3], pr[3], t3[3], u3[3];
      mv(md.Bt, qd, pt);
      mv(md.Br, qd, pr);
      mtv(md.R, f0, t3);
      mtv(md.Af, f0, u3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pt[i] += dt * t3[i];
        pr[i] += dt * u3[i];
      }
      mv(fac.BDt, rj, t3);
      mv(fac.BDr, rj, u3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pt[i] -= t3[i];
        pr[i] -= u3[i];
      }
      group_sum<3>(pt, gm);
      group_sum<3>(pr, gm);
      float ut[3], ur[3];
      mv(md.Mtr, w, ut);
      mtv(md.Mtr, v, ur);
      mv(md.Mrr, w, t3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ut[i] += mtot * v[i] - dt * md.bias_t[i] + pt[i];
        ur[i] += t3[i] - dt * md.bias_r[i] + pr[i];
      }
      mv(fac.itt, ut, xt);
      mv(fac.itr, ur, t3);
#pragma unroll
      for (int i = 0; i < 3; ++i) xt[i] += t3[i];
      mtv(fac.itr, ut, xr);
      mv(fac.irr, ur, t3);
#pragma unroll
      for (int i = 0; i < 3; ++i) xr[i] += t3[i];
      float r[3];
      mtv(ABt, xt, t3);
      mtv(ABr, xr, u3);
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = rj[i] - t3[i] - u3[i];
      mv(fac.Dinv, r, xj);
    }

    // integrate: position in the world frame, quaternion by the body rate
    {
      float t3[3];
      mv(md.R, xt, t3);
#pragma unroll
      for (int i = 0; i < 3; ++i) qb[i] += dt * t3[i];
      const float ang[3] = {xr[0] * dt, xr[1] * dt, xr[2] * dt};
      const float theta = sqrtf(ang[0] * ang[0] + ang[1] * ang[1] + ang[2] * ang[2]);
      const float half = 0.5f * theta;
      const bool small = theta < 1e-8f;
      float sh, ch;
      sin_cos(half, &sh, &ch);
      const float k = small ? 0.5f : sh / theta;
      const float dquat[4] = {ang[0] * k, ang[1] * k, ang[2] * k, ch};
      float out[4];
      quat_mul(qb + 3, dquat, out);
      const float nrm = sqrtf(out[0] * out[0] + out[1] * out[1] + out[2] * out[2] + out[3] * out[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qb[3 + i] = out[i] / nrm;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        qj[i] += dt * xj[i];
        v[i] = xt[i];
        w[i] = xr[i];
        qd[i] = xj[i];
      }
    }
    t = t + dt;
  }

  // carry out (the swing state is in place): leg l's entries and lane l's
  // share of the scenario's
  store_share<7>(a.q_o + 19 * b, qb, l);
  copy<3>(qj, a.q_o + 19 * b + 7 + 3 * l);
  {
    const float vw[6] = {v[0], v[1], v[2], w[0], w[1], w[2]};
    store_share<6>(a.dq_o + 18 * b, vw, l);
  }
  copy<3>(qd, a.dq_o + 18 * b + 6 + 3 * l);
  store_share<6>(a.vfilt_o + 6 * b, vfilt, l);
  if (l == 0) a.yaw_cont_o[b] = yc;
  if (l == 1) a.yaw_prev_o[b] = yp;
  if (l == 2) a.t_o[b] = t;
}

}  // namespace

// The launch for `batch` scenarios on the current card: threads per block,
// blocks, and the blocks (warps) resident per SM.
extern "C" int tick_window_shape(int batch, int* threads, int* blocks, int* warps_per_sm) {
  *threads = kGroup;
  *blocks = batch;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(warps_per_sm, tick_window_kernel,
                                                            kGroup, 0);
}

// C entry point. `ptrs` is a host array of the 44 device pointers of Args, in
// its order (batch-first contiguous tensors: f32, the two masks int32).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tick_window_f32(void* const* ptrs, int batch, int steps, float dt, float alpha,
                               float kp, float kd, float touch_z, float foot_radius,
                               float early_fz, cudaStream_t stream) {
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  if (batch <= 0) return 0;
  const Gains g{kp, kd, touch_z, foot_radius, early_fz};
  tick_window_kernel<<<batch, kGroup, 0, stream>>>(a, batch, steps, dt, alpha, g);
  return (int)cudaGetLastError();
}
