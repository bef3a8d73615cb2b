// Fused 1 kHz tick window for Hopper (sm_90a): `steps` ticks of the Go2 tick
// model, leg controller and implicit-damping plant step per scenario, in one
// launch.
//
// Replaces the TPU kernel convex_mpc_tpu/sim/tick_fused.py::run_ticks_fused
// (_window_kernel over _tick_soa), which computes engine._run_ticks for a
// whole MPC period (20 ticks on the main path, B = 512). The plain PyTorch
// version is sim/tick_fused.py::run_window_soa.
//
// Design. One thread per scenario runs the whole window: the carried state,
// the window inputs and every per-tick quantity stay in registers or local
// memory, so device memory is read once and written once per window, plus
// the per-tick logs. The kernel reads and writes the batch-first tensors of
// engine._run_ticks' signature directly (scenario b's fields are contiguous
// runs of 1-19 floats), so the apply stage is one launch and no layout copy;
// at B = 512 the strided accesses touch a few MB. The model constants (220
// floats) sit in shared memory, read by all threads of a block at one
// address. Blocks of 32 threads spread B = 512 over 16 SMs.
//
// The tangent. JAX's single jax.linearize tangent (velocity-product
// accelerations for the bias, and the feet's J'dot q'dot) is forward-mode
// arithmetic here: the geometry and velocity map is one template over its
// scalar type (model<T>), evaluated with T = Dual {v, d}, whose operators
// carry the derivative. q is seeded with the tangent qdot(q, dq); v, w and the joint
// rates are constants, as in _model_soa's model_fn. The value parts give the
// FK, Jacobian blocks and velocities; the derivative parts give the body
// accelerations and jdot_qd. Rotations use CUDA's atan2f / sinf / cosf
// (no fast math: division and sqrtf stay IEEE).
//
// What bounds it on this card. Bytes: per scenario the window reads 113
// floats of state and inputs and writes 78 floats of state and 20 x 71 floats
// of logs: 6.4 KB, 3.3 MB at B = 512, 1 us at 3.35 TB/s. Operations: worked
// out from this file's arithmetic with structural zeros and constant ones
// left out (chip_smoke.py TICK_OPS, where each term is derived; an FMA counts
// 2, a transcendental 1): 14,824 per scenario-tick whatever the data (the
// Dual model 12,246, the implicit step's arrow factor 1,455 and solve 414),
// plus per leg 777 in swing (its operational-space inertia 653), 427 in
// contact (the dt J'CJ blocks 405) and 15 in stance, and 1,452 for M's arrow
// factor on a tick with a leg in swing. chip_smoke.py's B = 512 battery
// needs ~18,100 per scenario-tick, 0.19 GFLOP per 20-tick window, 2.8 us at
// 67 TFLOP/s. So the bound is ~3 us, set by operations. The kernel is far
// from it by design: only 512 threads are in flight, one warp per SM, each
// a long chain of dependent scalar math, so it is latency-bound; the
// per-thread model and factor blocks (~1,500 floats) exceed the register
// file: ptxas reports 255 registers and a 3,408-byte stack frame with 660
// bytes of spill stores. Several threads per scenario and fewer spills are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 32;
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

__device__ __forceinline__ Dual sin_(Dual a) { return Dual(sinf(a.v), cosf(a.v) * a.d); }
__device__ __forceinline__ Dual cos_(Dual a) { return Dual(cosf(a.v), -sinf(a.v) * a.d); }
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
__device__ __forceinline__ void add_to(float* acc, const float* x, int n) {
  for (int i = 0; i < n; ++i) acc[i] += x[i];
}
__device__ __forceinline__ void copy(const float* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = x[i];
}
template <class T>
__device__ __forceinline__ void values(const T* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = val(x[i]);
}

// adjugate 3x3 inverse (tick_fused._inv3)
__device__ void inv3(const float* A, float* Ai) {
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
__device__ void quat_to_R(const T* qu, T* R) {
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
__device__ void rot_x(T a, T* R) {
  const T c = cos_(a), s = sin_(a);
  R[0] = T(1.0f); R[1] = T(0.0f); R[2] = T(0.0f);
  R[3] = T(0.0f); R[4] = c; R[5] = -s;
  R[6] = T(0.0f); R[7] = s; R[8] = c;
}
template <class T>
__device__ void rot_y(T a, T* R) {
  const T c = cos_(a), s = sin_(a);
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
struct Model {
  float R[9];                      // base_R
  float Mtr[9], Mrr[9];            // Mtt = m_tot I
  float Bt[4][9], Br[4][9], Dl[4][9];
  float bias_t[3], bias_r[3], bias_j[4][3];
  float Af[4][9], Qf[4][9];        // foot Jacobian blocks (base-linear block is R)
  float foot_pos[4][3], foot_vel[4][3], jdot[4][3];
  float com[3], vcom[3];
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
  for (int i = 0; i < 3; ++i) N[i] = Ia[i] + c[i];
}

// The geometry and velocity map, written once over the scalar type T and
// evaluated with T = Dual: values are the primal, derivatives the tangent.
template <class T>
__device__ void model(const float* cs, const T* q, const float* dq, Model& md) {
  const float* v = dq;
  const float* w = dq + 3;
  const float grav[3] = {0.0f, 0.0f, kGravZ};
  const T bp[3] = {q[0], q[1], q[2]};
  T R[9], Rv[3], Rw[3];
  quat_to_R(q + 3, R);
  mv(R, v, Rv);
  mv(R, w, Rw);
  float Rf[9];
  values(R, Rf, 9);
  copy(Rf, md.R, 9);

  // trunk
  const float mtr = cs[C_MTR];
  T com_tr[3], A_tr[9];
  {
    T t[3];
    mv(R, cs + C_COMTR, t);
    for (int i = 0; i < 3; ++i) com_tr[i] = bp[i] + t[i];
  }
  a_block(R, com_tr, bp, A_tr);
  T v_tr[3];
  {
    T t[3];
    mv(A_tr, w, t);
    for (int i = 0; i < 3; ++i) v_tr[i] = Rv[i] + t[i];
  }
  float Atr[9], Itr[9];
  values(A_tr, Atr, 9);
  world_inertia(Rf, cs + C_ITR, Itr);

  float SA[9], AtA[9], SI[9], SF[3], SN[3], bias_rA[3], com_acc[3], vcom_acc[3];
  mtm(Atr, Atr, AtA);
  for (int i = 0; i < 9; ++i) {
    SA[i] = mtr * Atr[i];
    AtA[i] = mtr * AtA[i];
    SI[i] = Itr[i];
  }
  {
    float w_tr[3], alpha_tr[3], N_tr[3];
    for (int i = 0; i < 3; ++i) {
      SF[i] = mtr * (der(v_tr[i]) - grav[i]);
      w_tr[i] = val(Rw[i]);
      alpha_tr[i] = der(Rw[i]);
      com_acc[i] = mtr * val(com_tr[i]);
      vcom_acc[i] = mtr * val(v_tr[i]);
    }
    euler_torque(Itr, alpha_tr, w_tr, N_tr);
    copy(N_tr, SN, 3);
    mtv(Atr, SF, bias_rA);  // A_tr' F_tr
  }

  for (int l = 0; l < 4; ++l) {
    const T* qj = q + 7 + 3 * l;
    const float* qdl = dq + 6 + 3 * l;
    T Rb[3][9], pb[3][3], ax[3][3];
    {
      T E[9], t[3];
      rot_x(qj[0], E);
      mm(R, E, Rb[0]);
      mv(R, cs + C_HIP + 3 * l, t);
      for (int i = 0; i < 3; ++i) pb[0][i] = bp[i] + t[i];
      rot_y(qj[1], E);
      mm(Rb[0], E, Rb[1]);
      mv(Rb[0], cs + C_THIGH + 3 * l, t);
      for (int i = 0; i < 3; ++i) pb[1][i] = pb[0][i] + t[i];
      rot_y(qj[2], E);
      mm(Rb[1], E, Rb[2]);
      mv(Rb[1], cs + C_CALF, t);
      for (int i = 0; i < 3; ++i) pb[2][i] = pb[1][i] + t[i];
    }
    for (int i = 0; i < 3; ++i) {
      ax[0][i] = R[3 * i];         // hip axis: base x column
      ax[1][i] = Rb[0][3 * i + 1];  // thigh axis: hip y column
      ax[2][i] = Rb[1][3 * i + 1];  // calf axis: thigh y column
    }

    float SQ[9], SIW[9], BrA[9], Dl[9], bj[3];
    for (int i = 0; i < 9; ++i) SQ[i] = SIW[i] = BrA[i] = Dl[i] = 0.0f;
    for (int i = 0; i < 3; ++i) bj[i] = 0.0f;

    for (int b = 0; b < 3; ++b) {
      const float m = cs[C_MLEG + 3 * l + b];
      T com_b[3], A_b[9], Q_b[9], W_b[9];
      {
        T t[3];
        mv(Rb[b], cs + C_COMLEG + 9 * l + 3 * b, t);
        for (int i = 0; i < 3; ++i) com_b[i] = pb[b][i] + t[i];
      }
      a_block(R, com_b, bp, A_b);
      for (int j = 0; j < 3; ++j) {
        T c[3] = {T(0.0f), T(0.0f), T(0.0f)}, wc[3] = {T(0.0f), T(0.0f), T(0.0f)};
        if (j <= b) {  // body b moves with joints j <= b
          T arm[3] = {com_b[0] - pb[j][0], com_b[1] - pb[j][1], com_b[2] - pb[j][2]};
          cross(ax[j], arm, c);
          for (int i = 0; i < 3; ++i) wc[i] = ax[j][i];
        }
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
        for (int i = 0; i < 3; ++i) vb[i] = Rv[i] + t1[i] + t2[i];
        mv(W_b, qdl, t1);
        for (int i = 0; i < 3; ++i) wb[i] = Rw[i] + t1[i];
      }
      float Ab[9], Qb[9], Wb[9], Rbf[9], Ib[9];
      values(A_b, Ab, 9);
      values(Q_b, Qb, 9);
      values(W_b, Wb, 9);
      values(Rb[b], Rbf, 9);
      world_inertia(Rbf, cs + C_ILEG + 27 * l + 9 * b, Ib);

      float t9[9], u9[9];
      for (int i = 0; i < 9; ++i) {
        SA[i] += m * Ab[i];
        SI[i] += Ib[i];
        SQ[i] += m * Qb[i];
      }
      mtm(Ab, Ab, t9);
      for (int i = 0; i < 9; ++i) AtA[i] += m * t9[i];
      mm(Ib, Wb, t9);
      add_to(SIW, t9, 9);
      mtm(Wb, t9, u9);  // W' I W
      mtm(Qb, Qb, t9);
      for (int i = 0; i < 9; ++i) Dl[i] += m * t9[i] + u9[i];
      mtm(Ab, Qb, t9);
      for (int i = 0; i < 9; ++i) BrA[i] += m * t9[i];

      float F[3], N[3], wv[3], al[3], t3[3];
      for (int i = 0; i < 3; ++i) {
        F[i] = m * (der(vb[i]) - grav[i]);
        wv[i] = val(wb[i]);
        al[i] = der(wb[i]);
        com_acc[i] += m * val(com_b[i]);
        vcom_acc[i] += m * val(vb[i]);
      }
      euler_torque(Ib, al, wv, N);
      add_to(SF, F, 3);
      add_to(SN, N, 3);
      mtv(Ab, F, t3);
      add_to(bias_rA, t3, 3);
      mtv(Qb, F, t3);
      add_to(bj, t3, 3);
      mtv(Wb, N, t3);
      add_to(bj, t3, 3);
    }

    // the foot: a point on the calf that sees all three joints
    T foot[3], A_f[9], Q_f[9];
    {
      T t[3];
      mv(Rb[2], cs + C_FOOT, t);
      for (int i = 0; i < 3; ++i) foot[i] = pb[2][i] + t[i];
    }
    a_block(R, foot, bp, A_f);
    for (int j = 0; j < 3; ++j) {
      T arm[3] = {foot[0] - pb[j][0], foot[1] - pb[j][1], foot[2] - pb[j][2]}, c[3];
      cross(ax[j], arm, c);
      for (int i = 0; i < 3; ++i) Q_f[3 * i + j] = c[i];
    }
    {
      T t1[3], t2[3];
      mv(A_f, w, t1);
      mv(Q_f, qdl, t2);
      for (int i = 0; i < 3; ++i) {
        const T fv = Rv[i] + t1[i] + t2[i];
        md.foot_pos[l][i] = val(foot[i]);
        md.foot_vel[l][i] = val(fv);
        md.jdot[l][i] = der(fv);
      }
    }
    values(A_f, md.Af[l], 9);
    values(Q_f, md.Qf[l], 9);
    float t9[9];
    mtm(Rf, SQ, md.Bt[l]);
    mtm(Rf, SIW, t9);
    for (int i = 0; i < 9; ++i) md.Br[l][i] = BrA[i] + t9[i];
    copy(Dl, md.Dl[l], 9);
    copy(bj, md.bias_j[l], 3);
  }

  mtm(Rf, SA, md.Mtr);
  {
    float t9[9], u9[9];
    mm(SI, Rf, t9);
    mtm(Rf, t9, u9);
    for (int i = 0; i < 9; ++i) md.Mrr[i] = AtA[i] + u9[i];
  }
  float t3[3];
  mtv(Rf, SF, md.bias_t);
  mtv(Rf, SN, t3);
  const float mtot = cs[C_MTOT];
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
  float itt[9], itr[9], irr[9];  // blocks of the 6x6 Schur complement's inverse
  float Dinv[4][9], BDt[4][9], BDr[4][9];
};

__device__ void arrow_factor(float mtt_diag, const float* Mtt_extra, const float* Mtr,
                             const float* Mrr, const float (*Bt)[9], const float (*Br)[9],
                             const float (*Dl)[9], Arrow& f) {
  float Stt[9], Str[9], Srr[9], t9[9];
  for (int i = 0; i < 9; ++i) {
    Stt[i] = Mtt_extra[i] + ((i % 4 == 0) ? mtt_diag : 0.0f);
    Str[i] = Mtr[i];
    Srr[i] = Mrr[i];
  }
  for (int l = 0; l < 4; ++l) {
    inv3(Dl[l], f.Dinv[l]);
    mm(Bt[l], f.Dinv[l], f.BDt[l]);
    mm(Br[l], f.Dinv[l], f.BDr[l]);
    mmt(f.BDt[l], Bt[l], t9);
    for (int i = 0; i < 9; ++i) Stt[i] -= t9[i];
    mmt(f.BDt[l], Br[l], t9);
    for (int i = 0; i < 9; ++i) Str[i] -= t9[i];
    mmt(f.BDr[l], Br[l], t9);
    for (int i = 0; i < 9; ++i) Srr[i] -= t9[i];
  }
  float Pi[9], W[9], T[9];
  inv3(Stt, Pi);
  mm(Pi, Str, W);
  mtm(Str, W, t9);
  for (int i = 0; i < 9; ++i) T[i] = Srr[i] - t9[i];
  inv3(T, f.irr);
  mm(W, f.irr, t9);  // W Ti
  float u9[9];
  mmt(t9, W, u9);
  for (int i = 0; i < 9; ++i) {
    f.itt[i] = Pi[i] + u9[i];
    f.itr[i] = -t9[i];
  }
}

// solve A x = r with r = (rt, rr, rj[4])
__device__ void arrow_solve(const Arrow& f, const float (*Bt)[9], const float (*Br)[9],
                            const float* rt, const float* rr, const float (*rj)[3], float* xt,
                            float* xr, float (*xj)[3]) {
  float ut[3] = {rt[0], rt[1], rt[2]}, ur[3] = {rr[0], rr[1], rr[2]}, t3[3], u3[3];
  for (int l = 0; l < 4; ++l) {
    mv(f.BDt[l], rj[l], t3);
    mv(f.BDr[l], rj[l], u3);
    for (int i = 0; i < 3; ++i) {
      ut[i] -= t3[i];
      ur[i] -= u3[i];
    }
  }
  mv(f.itt, ut, xt);
  mv(f.itr, ur, t3);
  for (int i = 0; i < 3; ++i) xt[i] += t3[i];
  mtv(f.itr, ut, xr);
  mv(f.irr, ur, t3);
  for (int i = 0; i < 3; ++i) xr[i] += t3[i];
  for (int l = 0; l < 4; ++l) {
    float r[3];
    mtv(Bt[l], xt, t3);
    mtv(Br[l], xr, u3);
    for (int i = 0; i < 3; ++i) r[i] = rj[l][i] - t3[i] - u3[i];
    mv(f.Dinv[l], r, xj[l]);
  }
}

// operational-space inertia of foot l: (J M^-1 J')^-1 (tick_fused._lambda_feet)
__device__ void lambda_foot(const Arrow& f, const Model& md, int l, float* lam) {
  float Lt[9], Lr[9], Lj[9], t9[9], ut[9], ur[9], xt[9], xr[9], xj[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Lt[3 * i + j] = md.R[3 * j + i];
      Lr[3 * i + j] = md.Af[l][3 * j + i];
      Lj[3 * i + j] = md.Qf[l][3 * j + i];
    }
  mm(f.BDt[l], Lj, t9);
  for (int i = 0; i < 9; ++i) ut[i] = Lt[i] - t9[i];
  mm(f.BDr[l], Lj, t9);
  for (int i = 0; i < 9; ++i) ur[i] = Lr[i] - t9[i];
  mm(f.itt, ut, xt);
  mm(f.itr, ur, t9);
  for (int i = 0; i < 9; ++i) xt[i] += t9[i];
  mtm(f.itr, ut, xr);  // S^-1 is symmetric: its lower-left block is itr'
  mm(f.irr, ur, t9);
  for (int i = 0; i < 9; ++i) xr[i] += t9[i];
  float r9[9], u9[9];
  mtm(md.Bt[l], xt, t9);
  mtm(md.Br[l], xr, u9);
  for (int i = 0; i < 9; ++i) r9[i] = Lj[i] - t9[i] - u9[i];
  mm(f.Dinv[l], r9, xj);
  float JMJt[9];
  mm(md.R, xt, JMJt);
  mm(md.Af[l], xr, t9);
  for (int i = 0; i < 9; ++i) JMJt[i] += t9[i];
  mm(md.Qf[l], xj, t9);
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

__global__ void __launch_bounds__(kThreads)
tick_window_kernel(Args a, int batch, int steps, float dt, float alpha, Gains g) {
  __shared__ float cs[kNumConsts];
  for (int i = threadIdx.x; i < kNumConsts; i += blockDim.x) cs[i] = a.consts[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  // carried state and window inputs
  float q[19], dq[18], takeoff[4], p0[4][3], td[4][3], vfilt[6];
  int last_mask[4];
  for (int i = 0; i < 19; ++i) q[i] = a.q[19 * b + i];
  for (int i = 0; i < 18; ++i) dq[i] = a.dq[18 * b + i];
  for (int l = 0; l < 4; ++l) {
    last_mask[l] = a.last_mask[4 * b + l];
    takeoff[l] = a.takeoff[4 * b + l];
    for (int i = 0; i < 3; ++i) {
      p0[l][i] = a.swing_p0[12 * b + 3 * l + i];
      td[l][i] = a.swing_td[12 * b + 3 * l + i];
    }
  }
  for (int i = 0; i < 6; ++i) vfilt[i] = a.vfilt[6 * b + i];
  float yc = a.yaw_cont[b], yp = a.yaw_prev[b], t = a.t[b];
  float u0[4][3], pos_des[3], vel_des[3], phase[4];
  for (int l = 0; l < 4; ++l) {
    phase[l] = a.phase[4 * b + l];
    for (int i = 0; i < 3; ++i) u0[l][i] = a.u0[12 * b + 3 * l + i];
  }
  for (int i = 0; i < 3; ++i) {
    pos_des[i] = a.pos_des[3 * b + i];
    vel_des[i] = a.vel_des[3 * b + i];
  }
  const float yaw_rate = a.yaw_rate[b], period = a.period[b], duty = a.duty[b];
  const float swing_h = a.swing_h[b], td_z = a.td_z[b];
  const float kn = a.kn[b], dn = a.dn[b], mu = a.mu[b], vtol = a.vtol[b], gz = a.gz[b];
  const float fr = a.fr[b], arm = a.arm[b], jd = a.jd[b];
  const float mtot = cs[C_MTOT];

  const float t_swing = (1.0f - duty) * period;
  const float t_stance = duty * period;
  const float big_t = t_swing + 0.5f * t_stance;
  const float pred_time = big_t / 2.0f;
  const float safe_ts = (t_swing > 0.0f) ? t_swing : 1.0f;

  Model md;
  Arrow fac;
  for (int step = 0; step < steps; ++step) {
    // attitude and yaw unwrap (rotations.yaw_unwrap_step)
    float Rq[9];
    quat_to_R(q + 3, Rq);
    const float pitch = atan2f(-Rq[6], sqrtf(Rq[0] * Rq[0] + Rq[3] * Rq[3]));
    const float yaw_m = atan2f(Rq[3], Rq[0]);
    const float roll = atan2f(Rq[7], Rq[8]);
    yc = yc + (floor_mod(yaw_m - yp + kPi, kTwoPi) - kPi);
    yp = yaw_m;

    {
      Dual qD[19];
      float qdot[19];
      mv(Rq, dq, qdot);  // position rate R v
      const float om[4] = {dq[3], dq[4], dq[5], 0.0f};
      float qq[4];
      quat_mul(q + 3, om, qq);
      for (int i = 0; i < 4; ++i) qdot[3 + i] = 0.5f * qq[i];
      for (int i = 0; i < 12; ++i) qdot[7 + i] = dq[6 + i];
      for (int i = 0; i < 19; ++i) qD[i] = Dual(q[i], qdot[i]);
      model(cs, qD, dq, md);
    }

    // velocity estimator: raw6 = [vcom_world, omega_world]
    float raw6[6];
    for (int i = 0; i < 3; ++i) raw6[i] = md.vcom[i];
    mv(md.R, dq + 3, raw6 + 3);
    for (int i = 0; i < 6; ++i) vfilt[i] = vfilt[i] + alpha * (raw6[i] - vfilt[i]);

    // leg controller (leg.compute_torques)
    const float cy = cosf(yc), sy = sinf(yc);
    const float k_v_x = 0.4f * big_t, k_v_y = 0.2f * big_t;
    const float k_p_x = 0.1f, k_p_y = 0.05f;
    int mask[4];
    float p_des[4][3], v_des[4][3], a_des[4][3], t_since[4];
    for (int l = 0; l < 4; ++l) {
      mask[l] = floor_mod(phase[l] + t / period, 1.0f) < duty ? 1 : 0;
      const bool takeoff_now = (mask[l] != last_mask[l]) && (mask[l] == 0);
      const float hx = cs[C_HOX + l], hy = cs[C_HOY + l];
      const float hip_rel_x = cy * hx - sy * hy;
      const float hip_rel_y = sy * hx + cy * hy;
      if (takeoff_now) {
        takeoff[l] = t;
        for (int i = 0; i < 3; ++i) p0[l][i] = md.foot_pos[l][i];
        td[l][0] = q[0] + hip_rel_x + vel_des[0] * pred_time + k_p_x * (md.com[0] - pos_des[0]) +
                   k_v_x * (vfilt[0] - vel_des[0]) + (-(yaw_rate * pred_time)) * hip_rel_y;
        td[l][1] = q[1] + hip_rel_y + vel_des[1] * pred_time + k_p_y * (md.com[1] - pos_des[1]) +
                   k_v_y * (vfilt[1] - vel_des[1]) + (yaw_rate * pred_time) * hip_rel_x;
        td[l][2] = td_z;
      }
      // min-jerk swing (gait.swing_eval)
      t_since[l] = t - takeoff[l];
      const float s = (t_swing > 0.0f) ? clip(t_since[l] / safe_ts, 0.0f, 1.0f) : 1.0f;
      const float s2 = s * s, s3 = s2 * s, s4 = s3 * s, s5 = s4 * s, r = 1.0f - s;
      const float mj = 10.0f * s3 - 15.0f * s4 + 6.0f * s5;
      const float dmj = 30.0f * s2 - 60.0f * s3 + 30.0f * s4;
      const float d2mj = 60.0f * s - 180.0f * s2 + 120.0f * s3;
      for (int i = 0; i < 3; ++i) {
        const float dp = td[l][i] - p0[l][i];
        p_des[l][i] = p0[l][i] + dp * mj;
        v_des[l][i] = dp * dmj / safe_ts;
        a_des[l][i] = dp * d2mj / (safe_ts * safe_ts);
      }
      const float bump = 64.0f * s3 * (r * r * r);
      const float dbump = 192.0f * s2 * (r * r) * (1.0f - 2.0f * s);
      const float d2bump = 192.0f * (2.0f * s * (r * r) * (1.0f - 2.0f * s) -
                                     2.0f * s2 * r * (1.0f - 2.0f * s) - 2.0f * s2 * (r * r));
      p_des[l][2] += swing_h * bump;
      v_des[l][2] += swing_h * dbump / safe_ts;
      a_des[l][2] += swing_h * d2bump / (safe_ts * safe_ts);
    }

    // operational-space feedforward and the torques
    const float zero9[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    arrow_factor(mtot, zero9, md.Mtr, md.Mrr, md.Bt, md.Br, md.Dl, fac);
    float tau[4][3], pos_des_log[4][3];
    for (int l = 0; l < 4; ++l) {
      float lam[9], e[3], f_ff[3], force_sw[3], tau_sw[3], tau_st[3], tau_e[3], neg_u0[3];
      lambda_foot(fac, md, l, lam);
      for (int i = 0; i < 3; ++i) e[i] = a_des[l][i] - md.jdot[l][i];
      mv(lam, e, f_ff);
      for (int i = 0; i < 3; ++i) {
        force_sw[i] = g.kp * (p_des[l][i] - md.foot_pos[l][i]) +
                      g.kd * (v_des[l][i] - md.foot_vel[l][i]) + f_ff[i];
        neg_u0[i] = -u0[l][i];
      }
      mtv(md.Qf[l], force_sw, tau_sw);
      for (int i = 0; i < 3; ++i) tau_sw[i] += md.bias_j[l][i];
      mtv(md.Qf[l], neg_u0, tau_st);

      // early contact: divides by the raw swing time, as leg.compute_torques does
      const float s_phase = clip(t_since[l] / t_swing, 0.0f, 1.0f);
      const bool touching = md.foot_pos[l][2] - g.foot_radius <= g.touch_z;
      const bool early = (mask[l] == 0) && (s_phase > 0.5f) && touching;
      float fx = g.kp * (td[l][0] - md.foot_pos[l][0]) - g.kd * md.foot_vel[l][0];
      float fy = g.kp * (td[l][1] - md.foot_pos[l][1]) - g.kd * md.foot_vel[l][1];
      const float f_cap = 0.8f * g.early_fz;
      const float f_norm = sqrtf(fx * fx + fy * fy);
      const float k = fminf(1.0f, f_cap / fmaxf(f_norm, 1e-6f));
      const float f_early[3] = {fx * k, fy * k, -g.early_fz};
      mtv(md.Qf[l], f_early, tau_e);

      const bool swing = mask[l] == 0;
      for (int i = 0; i < 3; ++i) {
        const float lim = cs[C_LIM + 3 * l + i];
        tau[l][i] = clip(early ? tau_e[i] : (swing ? tau_sw[i] : tau_st[i]), -lim, lim);
        pos_des_log[l][i] = swing ? p_des[l][i] : md.foot_pos[l][i];
      }
    }

    // logs of this tick (q before the step)
    {
      const size_t bt = (size_t)b * steps + step;
      float* xv = a.x_vec + 12 * bt;
      for (int i = 0; i < 3; ++i) xv[i] = md.com[i];
      xv[3] = roll;
      xv[4] = pitch;
      xv[5] = yc;
      for (int i = 0; i < 6; ++i) xv[6 + i] = raw6[i];
      for (int i = 0; i < 19; ++i) a.q_log[19 * bt + i] = q[i];
      for (int l = 0; l < 4; ++l) {
        a.mask_log[4 * bt + l] = mask[l];
        for (int i = 0; i < 3; ++i) {
          a.tau_log[12 * bt + 3 * l + i] = tau[l][i];
          a.fpd_log[12 * bt + 3 * l + i] = pos_des_log[l][i];
          a.fpn_log[12 * bt + 3 * l + i] = md.foot_pos[l][i];
        }
      }
    }

    // plant step (physics.step, implicit contact damping)
    float f0z[4], Cd[4][3];
    for (int l = 0; l < 4; ++l) {
      const float pen = gz - (md.foot_pos[l][2] - fr);
      const bool active = pen > 0.0f;
      f0z[l] = active ? kn * pen : 0.0f;
      const float fz_est = fmaxf(active ? kn * pen - dn * md.foot_vel[l][2] : 0.0f, 0.0f);
      const float dn_eff = (active && fz_est > 0.0f) ? dn : 0.0f;
      const float vt = sqrtf(md.foot_vel[l][0] * md.foot_vel[l][0] +
                             md.foot_vel[l][1] * md.foot_vel[l][1]);
      const float ct = active ? mu * fz_est / fmaxf(vtol, vt) : 0.0f;
      Cd[l][0] = ct;
      Cd[l][1] = ct;
      Cd[l][2] = dn_eff;
    }
    const float* v = dq;
    const float* w = dq + 3;
    float rhs_t[3], rhs_r[3], rhs_j[4][3], t3[3], u3[3];
    {
      float sum_f0[3] = {0.0f, 0.0f, 0.0f}, Jf_r[3] = {0.0f, 0.0f, 0.0f};
      float Mv_t[3], Mv_r[3];
      mv(md.Mtr, w, Mv_t);
      mtv(md.Mtr, v, Mv_r);
      mv(md.Mrr, w, t3);
      for (int i = 0; i < 3; ++i) {
        Mv_t[i] += mtot * v[i];
        Mv_r[i] += t3[i];
      }
      for (int l = 0; l < 4; ++l) {
        const float* qdl = dq + 6 + 3 * l;
        const float f0[3] = {0.0f, 0.0f, f0z[l]};
        sum_f0[2] += f0z[l];
        mtv(md.Af[l], f0, t3);
        for (int i = 0; i < 3; ++i) Jf_r[i] += t3[i];
        mv(md.Bt[l], qdl, t3);
        mv(md.Br[l], qdl, u3);
        for (int i = 0; i < 3; ++i) {
          Mv_t[i] += t3[i];
          Mv_r[i] += u3[i];
        }
        float Mv_j[3], Jf_j[3];
        mtv(md.Bt[l], v, Mv_j);
        mtv(md.Br[l], w, t3);
        mv(md.Dl[l], qdl, u3);
        mtv(md.Qf[l], f0, Jf_j);
        for (int i = 0; i < 3; ++i) {
          Mv_j[i] += t3[i] + u3[i] + arm * qdl[i];
          rhs_j[l][i] = Mv_j[i] + dt * (tau[l][i] - md.bias_j[l][i] + Jf_j[i]);
        }
      }
      mtv(md.R, sum_f0, t3);
      for (int i = 0; i < 3; ++i) {
        rhs_t[i] = Mv_t[i] + dt * (-md.bias_t[i] + t3[i]);
        rhs_r[i] = Mv_r[i] + dt * (-md.bias_r[i] + Jf_r[i]);
      }
    }
    // A = M + diag(arm) + dt (J' C J + diag(jd)), arrow blocks
    {
      float Att[9], Atr[9], Arr[9], ABt[4][9], ABr[4][9], ADl[4][9];
      for (int i = 0; i < 9; ++i) {
        Att[i] = 0.0f;
        Atr[i] = md.Mtr[i];
        Arr[i] = md.Mrr[i];
      }
      for (int l = 0; l < 4; ++l) {
        float CR[9], CA[9], CQ[9], t9[9];
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) {
            CR[3 * i + j] = Cd[l][i] * md.R[3 * i + j];
            CA[3 * i + j] = Cd[l][i] * md.Af[l][3 * i + j];
            CQ[3 * i + j] = Cd[l][i] * md.Qf[l][3 * i + j];
          }
        mtm(md.R, CR, t9);
        for (int i = 0; i < 9; ++i) Att[i] += dt * t9[i];
        mtm(md.R, CA, t9);
        for (int i = 0; i < 9; ++i) Atr[i] += dt * t9[i];
        mtm(md.Af[l], CA, t9);
        for (int i = 0; i < 9; ++i) Arr[i] += dt * t9[i];
        mtm(md.R, CQ, t9);
        for (int i = 0; i < 9; ++i) ABt[l][i] = md.Bt[l][i] + dt * t9[i];
        mtm(md.Af[l], CQ, t9);
        for (int i = 0; i < 9; ++i) ABr[l][i] = md.Br[l][i] + dt * t9[i];
        mtm(md.Qf[l], CQ, t9);
        for (int i = 0; i < 9; ++i)
          ADl[l][i] = md.Dl[l][i] + ((i % 4 == 0) ? arm + dt * jd : 0.0f) + dt * t9[i];
      }
      arrow_factor(mtot, Att, Atr, Arr, ABt, ABr, ADl, fac);
      float xt[3], xr[3], xj[4][3];
      arrow_solve(fac, ABt, ABr, rhs_t, rhs_r, rhs_j, xt, xr, xj);

      // integrate: position in the world frame, quaternion by the body rate
      mv(md.R, xt, t3);
      for (int i = 0; i < 3; ++i) q[i] += dt * t3[i];
      {
        const float ang[3] = {xr[0] * dt, xr[1] * dt, xr[2] * dt};
        const float theta = sqrtf(ang[0] * ang[0] + ang[1] * ang[1] + ang[2] * ang[2]);
        const float half = 0.5f * theta;
        const bool small = theta < 1e-8f;
        const float k = small ? 0.5f : sinf(half) / theta;
        const float dquat[4] = {ang[0] * k, ang[1] * k, ang[2] * k, cosf(half)};
        float out[4];
        quat_mul(q + 3, dquat, out);
        const float nrm = sqrtf(out[0] * out[0] + out[1] * out[1] + out[2] * out[2] + out[3] * out[3]);
        for (int i = 0; i < 4; ++i) q[3 + i] = out[i] / nrm;
      }
      for (int l = 0; l < 4; ++l)
        for (int i = 0; i < 3; ++i) q[7 + 3 * l + i] += dt * xj[l][i];
      for (int i = 0; i < 3; ++i) {
        dq[i] = xt[i];
        dq[3 + i] = xr[i];
      }
      for (int l = 0; l < 4; ++l)
        for (int i = 0; i < 3; ++i) dq[6 + 3 * l + i] = xj[l][i];
    }
    for (int l = 0; l < 4; ++l) last_mask[l] = mask[l];
    t = t + dt;
  }

  for (int i = 0; i < 19; ++i) a.q_o[19 * b + i] = q[i];
  for (int i = 0; i < 18; ++i) a.dq_o[18 * b + i] = dq[i];
  for (int l = 0; l < 4; ++l) {
    a.last_mask_o[4 * b + l] = last_mask[l];
    a.takeoff_o[4 * b + l] = takeoff[l];
    for (int i = 0; i < 3; ++i) {
      a.swing_p0_o[12 * b + 3 * l + i] = p0[l][i];
      a.swing_td_o[12 * b + 3 * l + i] = td[l][i];
    }
  }
  for (int i = 0; i < 6; ++i) a.vfilt_o[6 * b + i] = vfilt[i];
  a.yaw_cont_o[b] = yc;
  a.yaw_prev_o[b] = yp;
  a.t_o[b] = t;
}

}  // namespace

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
  const int blocks = (batch + kThreads - 1) / kThreads;
  tick_window_kernel<<<blocks, kThreads, 0, stream>>>(a, batch, steps, dt, alpha, g);
  return (int)cudaGetLastError();
}
