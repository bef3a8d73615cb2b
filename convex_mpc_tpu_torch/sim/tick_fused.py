"""The fused 1 kHz tick window: a whole ``steps_per_mpc``-tick window in one launch.

Port of ``convex_mpc_tpu/sim/tick_fused.py``. The window re-expresses one
tick — ``dynamics.tick_model`` + ``leg.compute_torques`` + ``physics.step``
+ the estimator / yaw / log glue of ``engine._run_ticks`` — with the
Jacobians kept split in the free-flyer block structure [base_R | A | Q], so
the mass matrix is built directly in the arrow blocks the solves consume.

Two versions compute it:

- the plain version (:func:`run_window_soa`, the twin of the JAX
  ``run_window_soa_xla``): the same math in PyTorch in a batch-LAST layout,
  every tensor ``(small dims..., n)``. The JAX ``jax.linearize`` tangent is
  ``torch.func.jvp`` along ``_qdot_soa(q, dq)``, as ``dynamics.tick_model``
  does;
- the CUDA kernel ``csrc/tick_window.cu``: a group of four lanes runs each
  scenario's whole window from the batch-first tensors, lane l owning leg
  l, the trunk sums reduced across the group by warp shuffles, with the
  tangent written out as forward-mode arithmetic (design and bound in its
  header; :func:`tick_window_shape` reads back its launch).

:func:`run_ticks_fused` takes the batch-first inputs of ``engine._run_ticks``
and returns its outputs. It runs the plain version
(:func:`run_ticks_fused_plain`) for CPU tensors; a CUDA tensor launches the
kernel or raises. The JAX module's two differences from
``engine._run_ticks`` are not copied: ``s_phase`` divides by the raw swing
time, as ``leg.compute_torques`` does, and the controller gains and contact
geometry are read from ``control.leg``'s constants.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import F32
from convex_mpc_tpu_torch.control import leg as L
from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS
from convex_mpc_tpu_torch.utils import cuda_build

_G = -9.81  # world gravity z (models.dynamics._GRAVITY)


# ---------------------------------------------------------------------------
# batch-last small-matrix algebra (component axes lead, batch last)
# ---------------------------------------------------------------------------
def _m33(A, B):
    """(..., 3, 3, n) @ (..., 3, 3, n): sum_k A[i,k] B[k,j]."""
    return torch.sum(A[..., :, :, None, :] * B[..., None, :, :, :], dim=-3)


def _m33T(A, B):
    """A' @ B: sum_k A[k,i] B[k,j]."""
    return torch.sum(A[..., :, :, None, :] * B[..., :, None, :, :], dim=-4)


def _m3v(A, v):
    """(..., 3, 3, n) @ (..., 3, n)."""
    return torch.sum(A * v[..., None, :, :], dim=-2)


def _m3Tv(A, v):
    """A' @ v: sum_k A[k,i] v[k]."""
    return torch.sum(A * v[..., :, None, :], dim=-3)


def _t3(A):
    """Transpose of the (3, 3) matrix axes."""
    return A.transpose(-3, -2)


def _cross(a, b):
    """(..., 3, n) x (..., 3, n)."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2)


def _inv3(A):
    """Adjugate 3x3 inverse, (..., 3, 3, n)."""
    a, b, c = A[..., 0, 0, :], A[..., 0, 1, :], A[..., 0, 2, :]
    d, e, f = A[..., 1, 0, :], A[..., 1, 1, :], A[..., 1, 2, :]
    g, h, i = A[..., 2, 0, :], A[..., 2, 1, :], A[..., 2, 2, :]
    r0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-2)
    r1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-2)
    r2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-2)
    adj = torch.stack([r0, r1, r2], dim=-3)
    det = a * r0[..., 0, :] + b * r1[..., 0, :] + c * r2[..., 0, :]
    return adj / det[..., None, None, :]


def _quat_to_R(quat):
    """xyzw (4, n) -> (3, 3, n)."""
    x, y, z, w = quat[0], quat[1], quat[2], quat[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-2),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-2),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-2),
    ], dim=-3)


def _rpy_from_R(R):
    """(3, 3, n) -> roll, pitch, yaw (each (n,)), as rotations.rotmat_to_rpy."""
    pitch = torch.atan2(-R[2, 0], torch.sqrt(R[0, 0] * R[0, 0] + R[1, 0] * R[1, 0]))
    yaw = torch.atan2(R[1, 0], R[0, 0])
    roll = torch.atan2(R[2, 1], R[2, 2])
    return roll, pitch, yaw


def _quat_mul(q1, q2):
    """Hamilton product, xyzw (4, n)."""
    x1, y1, z1, w1 = q1[0], q1[1], q1[2], q1[3]
    x2, y2, z2, w2 = q2[0], q2[1], q2[2], q2[3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=0)


def _quat_integrate(quat, omega_body, dt):
    """(4, n), (3, n) -> (4, n), as rotations.quat_integrate."""
    ang = omega_body * dt
    theta = torch.sqrt(torch.sum(ang * ang, dim=0))
    half = 0.5 * theta
    small = theta < 1e-8
    k = torch.where(small, 0.5, torch.sin(half) / torch.where(small, 1.0, theta))
    dq = torch.cat([ang * k[None], torch.cos(half)[None]], dim=0)
    out = _quat_mul(quat, dq)
    return out / torch.sqrt(torch.sum(out * out, dim=0))[None]


def _rot_about(axis: int, a):
    """Elementary rotation about x (axis=0) or y (axis=1): (..., n) -> (..., 3, 3, n)."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    else:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


# ---------------------------------------------------------------------------
# constants and the window's state, batch-last
# ---------------------------------------------------------------------------
class TickConsts(NamedTuple):
    """Model constants shaped for the batch-last tick (no batch axis); the
    trailing unit axes broadcast against the batch axis."""

    hip_pos: torch.Tensor  # (4, 3, 1)
    thigh_pos: torch.Tensor  # (4, 3, 1)
    calf_pos: torch.Tensor  # (3, 1)
    foot_in_calf: torch.Tensor  # (3, 1)
    hip_off_x: torch.Tensor  # (4, 1) hip-offset x components
    hip_off_y: torch.Tensor  # (4, 1)
    m_trunk: torch.Tensor  # (1, 1)
    m_legs5: torch.Tensor  # (4, 3, 1, 1, 1)  [hip, thigh, calf] per leg
    m_legs4: torch.Tensor  # (4, 3, 1, 1)
    com_trunk: torch.Tensor  # (3, 1)
    com_legs: torch.Tensor  # (4, 3, 3, 1) body-frame link COMs
    I_trunk: torch.Tensor  # (3, 3, 1)
    I_legs: torch.Tensor  # (4, 3, 3, 3, 1)
    total_mass: torch.Tensor  # (1, 1)
    lim: torch.Tensor  # (4, 3, 1) per-joint torque limits (incl. tau_max cap)


def make_consts(dyn, tau_max: float) -> TickConsts:
    """TickConsts from a Go2Dyn, on the Go2Dyn's device."""
    dev = dyn.mass.device
    gp = DEFAULT_PARAMS
    lim = torch.clamp(torch.tensor(
        [gp.hip_torque_max, gp.thigh_torque_max, gp.calf_torque_max], dtype=F32, device=dev
    ).repeat(4).reshape(4, 3), max=tau_max)
    kin = dyn.kin
    m_legs = dyn.mass[1:].reshape(4, 3).to(F32)
    return TickConsts(
        hip_pos=kin.hip_pos.to(F32)[:, :, None],
        thigh_pos=kin.thigh_pos.to(F32)[:, :, None],
        calf_pos=kin.calf_pos.to(F32)[:, None],
        foot_in_calf=kin.foot_pos.to(F32)[:, None],
        hip_off_x=kin.hip_offset.to(F32)[:, 0:1],
        hip_off_y=kin.hip_offset.to(F32)[:, 1:2],
        m_trunk=dyn.mass[0].reshape(1, 1).to(F32),
        m_legs5=m_legs[:, :, None, None, None],
        m_legs4=m_legs[:, :, None, None],
        com_trunk=dyn.com[0].to(F32)[:, None],
        com_legs=dyn.com[1:].reshape(4, 3, 3).to(F32)[..., None],
        I_trunk=dyn.inertia[0].to(F32)[..., None],
        I_legs=dyn.inertia[1:].reshape(4, 3, 3, 3).to(F32)[..., None],
        total_mass=dyn.total_mass.reshape(1, 1).to(F32),
        lim=lim[..., None],
    )


class TickBatch(NamedTuple):
    """Per-scenario window inputs, batch-last."""

    u0: torch.Tensor  # (4, 3, n) MPC stance forces (first horizon step)
    pos_des: torch.Tensor  # (3, n) COM position target
    vel_des: torch.Tensor  # (3, n) commanded world velocity
    yaw_rate: torch.Tensor  # (n,)
    g_period: torch.Tensor  # (n,)
    g_duty: torch.Tensor  # (n,)
    g_phase: torch.Tensor  # (4, n)
    g_swing_h: torch.Tensor  # (n,)
    g_td_z: torch.Tensor  # (n,)
    c_kn: torch.Tensor  # (n,)
    c_dn: torch.Tensor  # (n,)
    c_mu: torch.Tensor  # (n,)
    c_vtol: torch.Tensor  # (n,)
    c_gz: torch.Tensor  # (n,)
    c_fr: torch.Tensor  # (n,)
    c_arm: torch.Tensor  # (n,)
    c_jd: torch.Tensor  # (n,)


class TickCarry(NamedTuple):
    """Loop-carried per-scenario state, batch-last."""

    q: torch.Tensor  # (19, n)
    dq: torch.Tensor  # (18, n)
    last_mask: torch.Tensor  # (4, n) int32
    takeoff_time: torch.Tensor  # (4, n)
    swing_p0: torch.Tensor  # (4, 3, n)
    swing_td: torch.Tensor  # (4, 3, n)
    yaw_cont: torch.Tensor  # (n,)
    yaw_prev: torch.Tensor  # (n,)
    vfilt: torch.Tensor  # (6, n)
    t: torch.Tensor  # (n,)


# ---------------------------------------------------------------------------
# the model: FK + split Jacobians + arrow-block M + bias (one tangent)
# ---------------------------------------------------------------------------
def _fk_soa(cst: TickConsts, q):
    """FK of the 13-body tree, batch-last: a dict of pose quantities."""
    base_p = q[0:3]  # (3, n)
    base_R = _quat_to_R(q[3:7])  # (3, 3, n)
    qj = q[7:19].reshape(4, 3, -1)  # (4, 3 joints, n)

    R_hip = _m33(base_R[None], _rot_about(0, qj[:, 0]))  # (4, 3, 3, n)
    p_hip = base_p[None] + _m3v(base_R[None], cst.hip_pos)  # (4, 3, n)
    R_thigh = _m33(R_hip, _rot_about(1, qj[:, 1]))
    p_thigh = p_hip + _m3v(R_hip, cst.thigh_pos)
    R_calf = _m33(R_thigh, _rot_about(1, qj[:, 2]))
    p_calf = p_thigh + _m3v(R_thigh, cst.calf_pos[None])
    foot_w = p_calf + _m3v(R_calf, cst.foot_in_calf[None])  # (4, 3, n)

    R_legs = torch.stack([R_hip, R_thigh, R_calf], dim=1)  # (4, 3b, 3, 3, n)
    p_legs = torch.stack([p_hip, p_thigh, p_calf], dim=1)  # (4, 3b, 3, n)
    ax_hip = base_R[:, 0].expand(4, 3, base_p.shape[-1])  # base x column
    ax_thigh = R_hip[..., :, 1, :]  # hip y column
    ax_calf = R_thigh[..., :, 1, :]
    axes = torch.stack([ax_hip, ax_thigh, ax_calf], dim=1)  # (4, 3j, 3, n)
    # joint j's origin is body j's frame origin
    return dict(base_p=base_p, base_R=base_R, R_legs=R_legs, p_legs=p_legs,
                foot_w=foot_w, axes=axes, origins=p_legs)


def _anc_mask(device):
    """(3 bodies, 1, 3 joints, 1): body b moves with joints j <= b."""
    r = torch.arange(3, device=device)
    return (r[None, :] <= r[:, None]).to(F32)[:, None, :, None]


def _split_jacobians(fkd, cst: TickConsts):
    """Split point/angular Jacobians for all body COMs and the feet.

    A point p on body b has world point Jacobian [base_R | A | Q] with
    A cols_j = cross(base_R[:, j], p - base_p) and Q the own-leg joint
    columns cross(axis_j, p - o_j); angular Jacobians are [0 | base_R | W].
    """
    base_p, base_R = fkd["base_p"], fkd["base_R"]
    axes, origins = fkd["axes"], fkd["origins"]

    com_tr = base_p + _m3v(base_R, cst.com_trunk)  # (3, n)
    com_legs = fkd["p_legs"] + _m3v(fkd["R_legs"], cst.com_legs)  # (4, 3b, 3, n)

    def A_of(pts):
        rel = pts - base_p
        cols = [_cross(base_R[..., :, j, :].expand_as(rel), rel) for j in range(3)]
        return torch.stack(cols, dim=-2)  # (..., 3, 3, n)

    def Q_of(pts):
        if pts.ndim == 4:  # body COMs: broadcast over the body axis
            cols = [_cross(axes[:, j][:, None].expand_as(pts), pts - origins[:, j][:, None])
                    for j in range(3)]
        else:  # feet
            cols = [_cross(axes[:, j].expand_as(pts), pts - origins[:, j]) for j in range(3)]
        return torch.stack(cols, dim=-2)  # (..., 3, 3j, n)

    anc = _anc_mask(base_p.device)
    A_tr = A_of(com_tr)
    A_legs = A_of(com_legs)  # (4, 3b, 3, 3, n)
    A_feet = A_of(fkd["foot_w"])  # (4, 3, 3, n)
    Q_legs = Q_of(com_legs) * anc  # (4, 3b, 3, 3j, n)
    Q_feet = Q_of(fkd["foot_w"])  # (4, 3, 3j, n): feet see all 3 joints
    axes_T = axes.transpose(-3, -2)  # (4, 3, 3j, n)
    W_legs = (axes_T[:, None] * anc).expand_as(Q_legs)

    I_tr = _m33(_m33(base_R, cst.I_trunk), _t3(base_R))
    I_legs = _m33(_m33(fkd["R_legs"], cst.I_legs), _t3(fkd["R_legs"]))
    return dict(com_tr=com_tr, com_legs=com_legs, A_tr=A_tr, A_legs=A_legs, A_feet=A_feet,
                Q_legs=Q_legs, Q_feet=Q_feet, W_legs=W_legs, I_tr=I_tr, I_legs=I_legs)


def _qdot_soa(q, dq):
    """(19, n) time derivative of q (kinematics.qdot, batch-last)."""
    R = _quat_to_R(q[3:7])
    pos_dot = _m3v(R, dq[0:3])
    omega_quat = torch.cat([dq[3:6], torch.zeros_like(q[0:1])], dim=0)
    quat_dot = 0.5 * _quat_mul(q[3:7], omega_quat)
    return torch.cat([pos_dot, quat_dot, dq[6:18]], dim=0)


class ModelSoa(NamedTuple):
    """Everything one tick consumes, arrow-block form, batch-last."""

    Mtt: torch.Tensor  # (3, 3, n) == m_tot * I
    Mtr: torch.Tensor  # (3, 3, n)
    Mrr: torch.Tensor  # (3, 3, n)
    Bt: torch.Tensor  # (4, 3, 3, n) base-lin x leg-joint couplings
    Br: torch.Tensor  # (4, 3, 3, n) base-ang x leg-joint couplings
    Dl: torch.Tensor  # (4, 3, 3, n) per-leg joint blocks
    bias_t: torch.Tensor  # (3, n)
    bias_r: torch.Tensor  # (3, n)
    bias_j: torch.Tensor  # (4, 3, n)
    A_feet: torch.Tensor  # (4, 3, 3, n)
    Q_feet: torch.Tensor  # (4, 3, 3, n)
    foot_pos: torch.Tensor  # (4, 3, n)
    foot_vel: torch.Tensor  # (4, 3, n)
    jdot_qd: torch.Tensor  # (4, 3, n)
    com: torch.Tensor  # (3, n)
    vcom: torch.Tensor  # (3, n)
    base_R: torch.Tensor  # (3, 3, n)


def _model_soa(cst: TickConsts, q, dq) -> ModelSoa:
    """All per-tick model quantities: one primal pass and one forward tangent
    along q̇ (v, w and q̇_joints held constant, as in dynamics.tick_model)."""
    v, w, qd = dq[0:3], dq[3:6], dq[6:18].reshape(4, 3, -1)

    def model_fn(qq):
        fkd = _fk_soa(cst, qq)
        sj = _split_jacobians(fkd, cst)
        Rv = _m3v(fkd["base_R"], v)  # common base-linear contribution
        Rw = _m3v(fkd["base_R"], w)
        v_tr = Rv + _m3v(sj["A_tr"], w)
        v_legs = (Rv[None, None] + _m3v(sj["A_legs"], w[None, None])
                  + _m3v(sj["Q_legs"], qd[:, None]))
        w_legs = Rw[None, None] + _m3v(sj["W_legs"], qd[:, None])
        fv = Rv[None] + _m3v(sj["A_feet"], w[None]) + _m3v(sj["Q_feet"], qd)
        return (v_tr, v_legs, Rw, w_legs, fv), (fkd, sj)

    vels, accs, (fkd, sj) = torch.func.jvp(model_fn, (q,), (_qdot_soa(q, dq),), has_aux=True)
    v_tr, v_legs, w_tr, w_legs, fv = vels
    a_tr, a_legs, alpha_tr, alpha_legs, jdot_qd = accs

    base_R = fkd["base_R"]
    ml = cst.m_legs5  # (4, 3b, 1, 1, 1)
    ml3 = cst.m_legs4  # (4, 3b, 1, 1)

    # mass matrix, arrow blocks
    eye = torch.eye(3, dtype=q.dtype, device=q.device)[..., None]
    mtot = cst.total_mass
    Mtt = mtot * eye
    SA = cst.m_trunk * sj["A_tr"] + torch.sum(ml * sj["A_legs"], dim=(0, 1))
    Mtr = _m33T(base_R, SA)
    SI = sj["I_tr"] + torch.sum(sj["I_legs"], dim=(0, 1))
    Mrr = (cst.m_trunk * _m33T(sj["A_tr"], sj["A_tr"])
           + torch.sum(ml * _m33T(sj["A_legs"], sj["A_legs"]), dim=(0, 1))
           + _m33T(base_R, _m33(SI, base_R)))
    SQ = torch.sum(ml * sj["Q_legs"], dim=1)  # (4, 3, 3, n)
    Bt = _m33T(base_R[None], SQ)
    SIW = torch.sum(_m33(sj["I_legs"], sj["W_legs"]), dim=1)
    Br = (torch.sum(ml * _m33T(sj["A_legs"], sj["Q_legs"]), dim=1)
          + _m33T(base_R[None], SIW))
    Dl = torch.sum(ml * _m33T(sj["Q_legs"], sj["Q_legs"])
                   + _m33T(sj["W_legs"], _m33(sj["I_legs"], sj["W_legs"])), dim=1)

    # bias (Newton-Euler, ddq = 0)
    grav = torch.zeros_like(a_tr)
    grav[2] = _G
    F_tr = cst.m_trunk * (a_tr - grav)
    F_legs = ml3 * (a_legs - grav[None, None])
    N_tr = _m3v(sj["I_tr"], alpha_tr) + _cross(w_tr, _m3v(sj["I_tr"], w_tr))
    N_legs = _m3v(sj["I_legs"], alpha_legs) + _cross(w_legs, _m3v(sj["I_legs"], w_legs))
    SF = F_tr + torch.sum(F_legs, dim=(0, 1))
    SN = N_tr + torch.sum(N_legs, dim=(0, 1))
    bias_t = _m3Tv(base_R, SF)
    bias_r = (_m3Tv(sj["A_tr"], F_tr) + torch.sum(_m3Tv(sj["A_legs"], F_legs), dim=(0, 1))
              + _m3Tv(base_R, SN))
    bias_j = torch.sum(_m3Tv(sj["Q_legs"], F_legs) + _m3Tv(sj["W_legs"], N_legs), dim=1)

    com = (cst.m_trunk * sj["com_tr"] + torch.sum(ml3 * sj["com_legs"], dim=(0, 1))) / mtot
    vcom = (cst.m_trunk * v_tr + torch.sum(ml3 * v_legs, dim=(0, 1))) / mtot
    return ModelSoa(Mtt=Mtt, Mtr=Mtr, Mrr=Mrr, Bt=Bt, Br=Br, Dl=Dl, bias_t=bias_t,
                    bias_r=bias_r, bias_j=bias_j, A_feet=sj["A_feet"], Q_feet=sj["Q_feet"],
                    foot_pos=fkd["foot_w"], foot_vel=fv, jdot_qd=jdot_qd, com=com,
                    vcom=vcom, base_R=base_R)


# ---------------------------------------------------------------------------
# arrow factorization and solves on block-form matrices
# ---------------------------------------------------------------------------
class ArrowSoa(NamedTuple):
    itt: torch.Tensor  # (3, 3, n) S^-1 blocks (S = 6x6 base Schur complement)
    itr: torch.Tensor
    irr: torch.Tensor
    Dinv: torch.Tensor  # (4, 3, 3, n)
    Bt: torch.Tensor  # (4, 3, 3, n)
    Br: torch.Tensor
    BDt: torch.Tensor  # (4, 3, 3, n)  Bt_l Dinv_l
    BDr: torch.Tensor


def _arrow_factor_soa(Mtt, Mtr, Mrr, Bt, Br, Dl) -> ArrowSoa:
    """Block twin of ops.linalg.arrow_factor + inv6_spd_block."""
    Dinv = _inv3(Dl)
    BDt = _m33(Bt, Dinv)
    BDr = _m33(Br, Dinv)
    Stt = Mtt - torch.sum(_m33(BDt, _t3(Bt)), dim=0)
    Str = Mtr - torch.sum(_m33(BDt, _t3(Br)), dim=0)
    Srr = Mrr - torch.sum(_m33(BDr, _t3(Br)), dim=0)
    Pi = _inv3(Stt)  # 6x6 SPD inverse via its 3x3 Schur complement
    W = _m33(Pi, Str)
    Ti = _inv3(Srr - _m33T(Str, W))
    WTi = _m33(W, Ti)
    return ArrowSoa(itt=Pi + _m33(WTi, _t3(W)), itr=-WTi, irr=Ti, Dinv=Dinv, Bt=Bt, Br=Br,
                    BDt=BDt, BDr=BDr)


def _arrow_solve_vec(fac: ArrowSoa, rt, rr, rj):
    """Solve A x = r, r = (rt (3, n), rr (3, n), rj (4, 3, n))."""
    ut = rt - torch.sum(_m3v(fac.BDt, rj), dim=0)
    ur = rr - torch.sum(_m3v(fac.BDr, rj), dim=0)
    xt = _m3v(fac.itt, ut) + _m3v(fac.itr, ur)
    xr = _m3Tv(fac.itr, ut) + _m3v(fac.irr, ur)
    xj = _m3v(fac.Dinv, rj - _m3Tv(fac.Bt, xt[None]) - _m3Tv(fac.Br, xr[None]))
    return xt, xr, xj


def _lambda_feet(fac: ArrowSoa, base_R, A_feet, Q_feet):
    """Per-foot operational-space inertia (J M^-1 J')^-1, (4, 3, 3, n).

    Foot f's Jacobian transpose has only leg f's joint block, so the arrow
    solve runs with 3 right-hand sides per foot and that leg's coupling."""
    Lt = _t3(base_R)[None]
    Lr = _t3(A_feet)
    Lj = _t3(Q_feet)
    ut = Lt - _m33(fac.BDt, Lj)
    ur = Lr - _m33(fac.BDr, Lj)
    xt = _m33(fac.itt[None], ut) + _m33(fac.itr[None], ur)
    xr = _m33T(fac.itr[None], ut) + _m33(fac.irr[None], ur)  # S^-1 is symmetric
    xj = _m33(fac.Dinv, Lj - _m33(_t3(fac.Bt), xt) - _m33(_t3(fac.Br), xr))
    return _inv3(_m33(base_R[None], xt) + _m33(A_feet, xr) + _m33(Q_feet, xj))


# ---------------------------------------------------------------------------
# one tick (engine._run_ticks' tick)
# ---------------------------------------------------------------------------
def _tick_soa(carry: TickCarry, tb: TickBatch, cst: TickConsts, sim_dt: float, alpha: float):
    kp, kd = L.KP, L.KD
    q, dq = carry.q, carry.dq

    roll, pitch, yaw_m = _rpy_from_R(_quat_to_R(q[3:7]))
    delta = torch.remainder(yaw_m - carry.yaw_prev + math.pi, 2.0 * math.pi) - math.pi
    yc = carry.yaw_cont + delta
    yp = yaw_m

    md = _model_soa(cst, q, dq)

    # velocity estimator: raw6 = [vcom_world, omega_world]
    omega_w = _m3v(md.base_R, dq[3:6])
    raw6 = torch.cat([md.vcom, omega_w], dim=0)
    vfilt = carry.vfilt + alpha * (raw6 - carry.vfilt)
    vcom_filt = vfilt[0:3]

    # leg controller (leg.compute_torques)
    t = carry.t
    phases = torch.remainder(tb.g_phase + t[None] / tb.g_period[None], 1.0)
    mask = (phases < tb.g_duty[None]).to(torch.int32)  # (4, n)
    takeoff = (mask != carry.last_mask) & (mask == 0)

    t_swing = (1.0 - tb.g_duty) * tb.g_period
    t_stance = tb.g_duty * tb.g_period
    big_t = t_swing + 0.5 * t_stance
    pred_time = big_t / 2.0

    # Raibert touchdown for all legs (gait.touchdown_raibert)
    cy, sy = torch.cos(yc), torch.sin(yc)
    hip_rel_x = cy[None] * cst.hip_off_x - sy[None] * cst.hip_off_y  # (4, n)
    hip_rel_y = sy[None] * cst.hip_off_x + cy[None] * cst.hip_off_y
    k_v_x, k_p_x = 0.4 * big_t, 0.1
    k_v_y, k_p_y = 0.2 * big_t, 0.05
    td_x = (q[0][None] + hip_rel_x + (tb.vel_des[0] * pred_time)[None]
            + k_p_x * (md.com[0] - tb.pos_des[0])[None]
            + (k_v_x * (vcom_filt[0] - tb.vel_des[0]))[None]
            + (-(tb.yaw_rate * pred_time))[None] * hip_rel_y)
    td_y = (q[1][None] + hip_rel_y + (tb.vel_des[1] * pred_time)[None]
            + k_p_y * (md.com[1] - tb.pos_des[1])[None]
            + (k_v_y * (vcom_filt[1] - tb.vel_des[1]))[None]
            + (tb.yaw_rate * pred_time)[None] * hip_rel_x)
    td_all = torch.stack([td_x, td_y, tb.g_td_z[None].expand_as(td_x)], dim=1)  # (4, 3, n)

    takeoff_time = torch.where(takeoff, t[None], carry.takeoff_time)
    swing_p0 = torch.where(takeoff[:, None], md.foot_pos, carry.swing_p0)
    swing_td = torch.where(takeoff[:, None], td_all, carry.swing_td)

    # min-jerk swing (gait.swing_eval)
    t_since = t[None] - takeoff_time  # (4, n)
    safe_ts = torch.where(t_swing > 0, t_swing, 1.0)[None]
    s = torch.where(t_swing[None] > 0, torch.clamp(t_since / safe_ts, 0.0, 1.0), 1.0)
    s1 = s[:, None]  # (4, 1, n)
    dp = swing_td - swing_p0
    mj = 10 * s1**3 - 15 * s1**4 + 6 * s1**5
    dmj = 30 * s1**2 - 60 * s1**3 + 30 * s1**4
    d2mj = 60 * s1 - 180 * s1**2 + 120 * s1**3
    ts1 = safe_ts[:, None]
    p_des = swing_p0 + dp * mj
    v_des = dp * dmj / ts1
    a_des = dp * d2mj / (ts1 * ts1)
    b_ = 64 * s**3 * (1 - s) ** 3
    db_ = 192 * s**2 * (1 - s) ** 2 * (1 - 2 * s)
    d2b_ = 192 * (2 * s * (1 - s) ** 2 * (1 - 2 * s) - 2 * s**2 * (1 - s) * (1 - 2 * s)
                  - 2 * s**2 * (1 - s) ** 2)
    h = tb.g_swing_h[None]
    zeros4 = torch.zeros_like(b_)

    def zb(x):  # (4, n) z-only bump -> (4, 3, n)
        return torch.stack([zeros4, zeros4, x], dim=1)

    p_des = p_des + zb(h * b_)
    v_des = v_des + zb(h * db_ / safe_ts)
    a_des = a_des + zb(h * d2b_ / (safe_ts * safe_ts))

    # operational-space feedforward
    fac = _arrow_factor_soa(md.Mtt, md.Mtr, md.Mrr, md.Bt, md.Br, md.Dl)
    lam = _lambda_feet(fac, md.base_R, md.A_feet, md.Q_feet)
    f_ff = _m3v(lam, a_des - md.jdot_qd)
    force_sw = kp * (p_des - md.foot_pos) + kd * (v_des - md.foot_vel) + f_ff

    J_leg = md.Q_feet  # own-leg joint block of the foot Jacobian
    tau_swing = _m3Tv(J_leg, force_sw) + md.bias_j
    tau_stance = _m3Tv(J_leg, -tb.u0)

    # early contact: divides by the raw swing time, as leg.compute_torques does
    s_phase = torch.clamp(t_since / t_swing[None], 0.0, 1.0)
    touching = md.foot_pos[:, 2] - L.FOOT_RADIUS <= L.GROUND_Z + 1e-3
    early = (mask == 0) & (s_phase > 0.5) & touching
    f_xy = kp * (swing_td[:, 0:2] - md.foot_pos[:, 0:2]) - kd * md.foot_vel[:, 0:2]
    f_cap = 0.8 * L.EARLY_CONTACT_FZ
    f_norm = torch.sqrt(torch.sum(f_xy * f_xy, dim=1, keepdim=True))
    f_xy = f_xy * torch.clamp(f_cap / torch.clamp(f_norm, min=1e-6), max=1.0)
    f_early = torch.cat([f_xy, torch.full_like(f_xy[:, 0:1], -L.EARLY_CONTACT_FZ)], dim=1)
    tau_early = _m3Tv(J_leg, f_early)

    in_swing = (mask == 0)[:, None]
    tau = torch.where(early[:, None], tau_early, torch.where(in_swing, tau_swing, tau_stance))
    tau = torch.clamp(tau, -cst.lim, cst.lim)
    pos_des_log = torch.where(in_swing, p_des, md.foot_pos)
    x_vec = torch.cat([md.com, torch.stack([roll, pitch, yc], dim=0), raw6], dim=0)  # (12, n)

    # plant step (physics.step, implicit contact damping)
    pen = tb.c_gz[None] - (md.foot_pos[:, 2] - tb.c_fr[None])
    active = pen > 0.0
    f_spring_z = torch.where(active, tb.c_kn[None] * pen, 0.0)
    fz_est = torch.clamp(torch.where(
        active, tb.c_kn[None] * pen - tb.c_dn[None] * md.foot_vel[:, 2], 0.0), min=0.0)
    dn_eff = torch.where(active & (fz_est > 0.0), tb.c_dn[None], 0.0)
    vt_mag = torch.sqrt(torch.sum(md.foot_vel[:, 0:2] ** 2, dim=1))
    ct = torch.where(active, tb.c_mu[None] * fz_est / torch.maximum(tb.c_vtol[None], vt_mag), 0.0)
    zero = torch.zeros_like(f_spring_z)
    f0 = torch.stack([zero, zero, f_spring_z], dim=1)  # (4, 3, n)
    Cd = torch.stack([ct, ct, dn_eff], dim=1)  # (4, 3, n) diagonal entries

    v, w, qd = dq[0:3], dq[3:6], dq[6:18].reshape(4, 3, -1)
    mtot = cst.total_mass
    # rhs = (M + diag(arm)) dq + dt (tau_gen - bias + J' f0)
    Jt_f0_t = _m3Tv(md.base_R, torch.sum(f0, dim=0))
    Jt_f0_r = torch.sum(_m3Tv(md.A_feet, f0), dim=0)
    Jt_f0_j = _m3Tv(md.Q_feet, f0)
    Mv_t = mtot * v + _m3v(md.Mtr, w) + torch.sum(_m3v(md.Bt, qd), dim=0)
    Mv_r = _m3Tv(md.Mtr, v) + _m3v(md.Mrr, w) + torch.sum(_m3v(md.Br, qd), dim=0)
    Mv_j = (_m3Tv(md.Bt, v[None]) + _m3Tv(md.Br, w[None]) + _m3v(md.Dl, qd)
            + tb.c_arm[None] * qd)
    rhs_t = Mv_t + sim_dt * (-md.bias_t + Jt_f0_t)
    rhs_r = Mv_r + sim_dt * (-md.bias_r + Jt_f0_r)
    rhs_j = Mv_j + sim_dt * (tau - md.bias_j + Jt_f0_j)

    # A = M + diag(arm) + dt (J' C J + diag(jd)) in arrow blocks
    eye = torch.eye(3, dtype=q.dtype, device=q.device)[..., None]
    CR = Cd[:, :, None] * md.base_R[None]  # diag(C) base_R
    CA = Cd[:, :, None] * md.A_feet
    CQ = Cd[:, :, None] * md.Q_feet
    Att = mtot * eye + sim_dt * torch.sum(_m33T(md.base_R[None], CR), dim=0)
    Atr = md.Mtr + sim_dt * torch.sum(_m33T(md.base_R[None], CA), dim=0)
    Arr = md.Mrr + sim_dt * torch.sum(_m33T(md.A_feet, CA), dim=0)
    ABt = md.Bt + sim_dt * _m33T(md.base_R[None], CQ)
    ABr = md.Br + sim_dt * _m33T(md.A_feet, CQ)
    ADl = (md.Dl + (tb.c_arm[None, None] + sim_dt * tb.c_jd[None, None]) * eye[None]
           + sim_dt * _m33T(md.Q_feet, CQ))
    xt, xr, xj = _arrow_solve_vec(_arrow_factor_soa(Att, Atr, Arr, ABt, ABr, ADl),
                                  rhs_t, rhs_r, rhs_j)
    xj = xj.reshape(12, -1)
    q_new = torch.cat([q[0:3] + sim_dt * _m3v(md.base_R, xt),
                       _quat_integrate(q[3:7], xr, sim_dt), q[7:19] + sim_dt * xj], dim=0)

    new_carry = TickCarry(q=q_new, dq=torch.cat([xt, xr, xj], dim=0), last_mask=mask,
                          takeoff_time=takeoff_time, swing_p0=swing_p0, swing_td=swing_td,
                          yaw_cont=yc, yaw_prev=yp, vfilt=vfilt, t=t + sim_dt)
    logs = dict(x_vec=x_vec, q=q, tau=tau, foot_pos_des=pos_des_log,
                foot_pos_now=md.foot_pos, contact_mask=mask)
    return new_carry, logs


_LOG_KEYS = ("x_vec", "q", "tau", "foot_pos_des", "foot_pos_now", "contact_mask")


def run_window_soa(carry: TickCarry, tb: TickBatch, cst: TickConsts, steps: int,
                   sim_dt: float, alpha: float):
    """The plain version of the window: ``steps`` ticks, batch-last. Returns
    (final carry, logs dict stacked (steps, ..., n))."""
    logs = []
    for _ in range(steps):
        carry, lg = _tick_soa(carry, tb, cst, sim_dt, alpha)
        logs.append(lg)
    return carry, {k: torch.stack([lg[k] for lg in logs], dim=0) for k in _LOG_KEYS}


# ---------------------------------------------------------------------------
# the entry point: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------
def _inputs(gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont, yaw_prev, vel_filt0, t0):
    """The window's batch-first operands as (carry fields, batch fields), each
    broadcast to its full (B, ...) shape; last_mask int32, the rest f32."""
    B = u0.shape[0]
    f = lambda x, *s: x.to(F32).expand(B, *s)  # noqa: E731
    carry = (f(plant0.q, 19), f(plant0.dq, 18), leg0.last_mask.to(torch.int32).expand(B, 4),
             f(leg0.takeoff_time, 4), f(leg0.swing_p0, 4, 3), f(leg0.swing_td, 4, 3),
             f(yaw_cont), f(yaw_prev), f(vel_filt0, 6), f(t0))
    batch = (f(u0, 4, 3), f(traj.pos_des_world, 3), f(traj.vel_des_world, 3), f(cmd.yaw_rate),
             f(gait.period), f(gait.duty), f(gait.phase_offset, 4), f(gait.swing_height),
             f(gait.touchdown_z), *(f(c) for c in contact))
    return carry, batch


def _plain(carry_bf, batch_bf, cst, steps, sim_dt, alpha):
    bl = lambda x: torch.movedim(x, 0, -1)  # noqa: E731  batch-first -> batch-last
    bf = lambda x: torch.movedim(x, -1, 0)  # noqa: E731
    carry = TickCarry(*(bl(x) for x in carry_bf))
    fin, logs = run_window_soa(carry, TickBatch(*(bl(x) for x in batch_bf)), cst, steps,
                               sim_dt, alpha)
    # logs (steps, ..., n) -> (n, steps, ...)
    return [bf(x) for x in fin], [torch.movedim(logs[k], -1, 0) for k in _LOG_KEYS]


_N_PTRS = 44
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("tick_window")
        lib.tick_window_f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_float] * 7 + [ctypes.c_void_p]
        lib.tick_window_f32.restype = ctypes.c_int
        lib.tick_window_shape.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.tick_window_shape.restype = ctypes.c_int
        _lib = lib
    return _lib


def tick_window_shape(B: int) -> tuple[int, int, int]:
    """The launch ``csrc/tick_window.cu`` makes for B scenarios on the current
    card: (threads per block, blocks, blocks resident per SM). A block is
    one scenario's four lanes."""
    threads, blocks, resident = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(_library().tick_window_shape(B, ctypes.byref(threads), ctypes.byref(blocks),
                                                  ctypes.byref(resident)), "tick_window shape")
    return threads.value, blocks.value, resident.value


def _launch(carry_bf, batch_bf, cst, steps, sim_dt, alpha):
    carry_bf = [x.contiguous() for x in carry_bf]
    batch_bf = [x.contiguous() for x in batch_bf]
    consts = torch.cat([x.reshape(-1) for f, x in zip(TickConsts._fields, cst)
                        if f != "m_legs4"]).contiguous()
    ints = [carry_bf[2]]
    cuda_build.require_cuda("run_ticks_fused", *carry_bf[:2], *carry_bf[3:], *batch_bf, consts,
                            ints=ints)
    B = carry_bf[0].shape[0]
    dev = carry_bf[0].device
    out_carry = [torch.empty_like(x) for x in carry_bf]
    e = lambda *s, dt=F32: torch.empty((B, steps) + s, dtype=dt, device=dev)  # noqa: E731
    logs = [e(12), e(19), e(4, 3), e(4, 3), e(4, 3), e(4, dt=torch.int32)]
    tensors = [*carry_bf, *batch_bf, consts, *out_carry, *logs]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(*[x.data_ptr() for x in tensors])
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().tick_window_f32(
        ctypes.cast(ptrs, ctypes.c_void_p), B, steps, f32(sim_dt), f32(alpha), f32(L.KP),
        f32(L.KD), f32(L.GROUND_Z + 1e-3), f32(L.FOOT_RADIUS), f32(L.EARLY_CONTACT_FZ), stream)
    cuda_build.check(err, "run_ticks_fused")
    return out_carry, logs


def _window(dyn, gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont, yaw_prev, vel_filt0,
            t0, steps_per_mpc, tau_max, sim_dt, vel_filter_hz, run):
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    carry_bf, batch_bf = _inputs(gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont,
                                 yaw_prev, vel_filt0, t0)
    cst = make_consts(dyn, tau_max)
    if any(x.device != u0.device for x in (*carry_bf, *batch_bf, cst.lim)):
        raise ValueError("run_ticks_fused: all operands on one device")
    fin, logs = run(carry_bf, batch_bf, cst, steps_per_mpc, sim_dt,
                    E._filter_alpha(vel_filter_hz, sim_dt))
    q, dq, last_mask, takeoff_time, swing_p0, swing_td, yc, yp, vfilt, t = fin
    x_vec, q_log, tau, fpd, fpn, cm = logs
    force = batch_bf[0][:, None].expand(u0.shape[0], steps_per_mpc, 4, 3)
    ticks = E.TickLog(x_vec=x_vec, q=q_log, tau=tau, force=force, foot_pos_des=fpd,
                      foot_pos_now=fpn, contact_mask=cm)
    leg = L.LegControlState(last_mask=last_mask, takeoff_time=takeoff_time,
                            swing_p0=swing_p0, swing_td=swing_td)
    return (P.PlantState(q=q, dq=dq), leg, yc, yp, vfilt, t), ticks


def run_ticks_fused_plain(*args):
    """The plain version of :func:`run_ticks_fused` (same arguments and
    outputs), on the device of its inputs."""
    return _window(*args, run=_plain)


def run_ticks_fused(dyn, gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont, yaw_prev,
                    vel_filt0, t0, steps_per_mpc: int, tau_max: float, sim_dt: float,
                    vel_filter_hz: float):
    """Drop-in for ``engine._run_ticks``: the same batch-first inputs and the
    same outputs ``((plant, leg, yaw_cont, yaw_prev, vel_filt, t), TickLog)``
    with the logs (B, steps, ...), computed in one window: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    args = (dyn, gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont, yaw_prev, vel_filt0, t0,
            steps_per_mpc, tau_max, sim_dt, vel_filter_hz)
    if u0.device.type == "cpu":
        return run_ticks_fused_plain(*args)
    if u0.device.type != "cuda":
        raise ValueError(f"run_ticks_fused runs on CPU or CUDA tensors, got {u0.device}")
    out = _window(*args, run=_launch)
    run_ticks_fused.launches += 1
    return out


run_ticks_fused.launches = 0
