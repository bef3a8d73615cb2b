"""Analytic Go2 kinematics: FK, world Jacobians and velocities, batched.

A frozen plain copy of the system's kinematics. Conventions:

- q (B, 19): [base_pos_world(3), base_quat xyzw(4), 12 joint angles], joint
  order [FL, FR, RL, RR] x [hip(x-axis), thigh(y-axis), calf(y-axis)];
- dq (B, 18): [v_base BODY(3), omega_base BODY(3), 12 joint velocities];
- body index order: 0 = trunk; leg l: hip = 1+3l, thigh = 2+3l, calf = 3+3l.

Every function takes an explicit leading batch axis on q/dq.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.go2_params import DEFAULT_PARAMS, Go2Params
from benchmark.reference.rotations import hat, quat_mul, quat_to_rotmat

NQ = 19
NV = 18
NUM_BODIES = 13


class Go2Kin(NamedTuple):
    """Baked kinematic constants (unbatched)."""

    hip_pos: torch.Tensor  # (4, 3) trunk -> hip joint origin
    thigh_pos: torch.Tensor  # (4, 3) hip -> thigh joint origin
    calf_pos: torch.Tensor  # (3,) thigh -> calf joint origin
    foot_pos: torch.Tensor  # (3,) calf -> foot center
    hip_offset: torch.Tensor  # (4, 3) trunk -> thigh joint


def build_kin(params: Go2Params = DEFAULT_PARAMS, device="cpu", dtype=torch.float64) -> Go2Kin:
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return Go2Kin(
        hip_pos=t(np.stack([params.hip_joint_pos(l) for l in range(4)])),
        thigh_pos=t(np.stack([params.thigh_joint_pos(l) for l in range(4)])),
        calf_pos=t(params.calf_joint_pos()),
        foot_pos=t(params.foot_pos_in_calf()),
        hip_offset=t(np.stack([params.hip_offset(l) for l in range(4)])),
    )


def hip_offsets(device, dtype) -> torch.Tensor:
    """(4, 3) body-frame hip offsets (Raibert placement)."""
    return build_kin(device=device, dtype=dtype).hip_offset


def _rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1), torch.stack([z, s, c], -1)],
        -2,
    )


def _rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)],
        -2,
    )


class Poses(NamedTuple):
    """World poses of all bodies + derived joint/foot frames (batched)."""

    R: torch.Tensor  # (B, 13, 3, 3) body -> world
    p: torch.Tensor  # (B, 13, 3)
    foot_w: torch.Tensor  # (B, 4, 3)
    joint_origin_w: torch.Tensor  # (B, 12, 3)
    joint_axis_w: torch.Tensor  # (B, 12, 3)


def fk(kin: Go2Kin, q: torch.Tensor) -> Poses:
    """Forward kinematics of the full tree, q (B, 19)."""
    B = q.shape[0]
    base_p = q[:, 0:3]
    base_R = quat_to_rotmat(q[:, 3:7])  # (B, 3, 3)
    qj = q[:, 7:19].reshape(B, 4, 3)

    R_hip = torch.matmul(base_R[:, None], _rot_x(qj[:, :, 0]))  # (B, 4, 3, 3)
    p_hip = base_p[:, None] + torch.einsum("bij,lj->bli", base_R, kin.hip_pos)
    R_thigh = torch.matmul(R_hip, _rot_y(qj[:, :, 1]))
    p_thigh = p_hip + torch.einsum("blij,lj->bli", R_hip, kin.thigh_pos)
    R_calf = torch.matmul(R_thigh, _rot_y(qj[:, :, 2]))
    p_calf = p_thigh + torch.einsum("blij,j->bli", R_thigh, kin.calf_pos)
    foot_w = p_calf + torch.einsum("blij,j->bli", R_calf, kin.foot_pos)

    R = torch.cat(
        [base_R[:, None], torch.stack([R_hip, R_thigh, R_calf], dim=2).reshape(B, 12, 3, 3)],
        dim=1,
    )
    p = torch.cat(
        [base_p[:, None], torch.stack([p_hip, p_thigh, p_calf], dim=2).reshape(B, 12, 3)],
        dim=1,
    )
    ax_hip = base_R[:, None, :, 0].expand(B, 4, 3)
    ax_thigh = R_hip[:, :, :, 1]
    ax_calf = R_thigh[:, :, :, 1]
    joint_axis_w = torch.stack([ax_hip, ax_thigh, ax_calf], dim=2).reshape(B, 12, 3)
    joint_origin_w = torch.stack([p_hip, p_thigh, p_calf], dim=2).reshape(B, 12, 3)
    return Poses(R=R, p=p, foot_w=foot_w, joint_origin_w=joint_origin_w,
                 joint_axis_w=joint_axis_w)


# body index -> ancestor joints among the 12 revolute joints
_BODY_JOINTS = [[]] + [[3 * l, 3 * l + 1][: k + 1] + ([3 * l + 2] if k == 2 else [])
                       for l in range(4) for k in range(3)]
_JOINT_MASK = np.zeros((NUM_BODIES, 12), dtype=bool)
for _b, _js in enumerate(_BODY_JOINTS):
    for _j in _js:
        _JOINT_MASK[_b, _j] = True

FOOT_BODIES = np.array([3, 6, 9, 12])  # calf body of each leg


def _mask(bodies, device):
    return torch.as_tensor(_JOINT_MASK[np.asarray(bodies)], device=device)


def point_jacobians(poses: Poses, points_w: torch.Tensor, bodies: np.ndarray) -> torch.Tensor:
    """Point Jacobians: (B, K, 3) points on static body ids -> (B, K, 3, 18)."""
    B, K_ = points_w.shape[0], points_w.shape[1]
    base_R = poses.R[:, 0]
    rel = points_w - poses.p[:, 0][:, None, :]
    J_base_lin = base_R[:, None].expand(B, K_, 3, 3)
    J_base_ang = torch.matmul(-hat(rel), base_R[:, None])
    arm = points_w[:, :, None, :] - poses.joint_origin_w[:, None]  # (B, K, 12, 3)
    cols = torch.linalg.cross(poses.joint_axis_w[:, None].expand_as(arm), arm, dim=-1)
    mask = _mask(bodies, points_w.device)[None, :, :, None]
    J_joints = torch.where(mask, cols, 0.0).transpose(-1, -2)  # (B, K, 3, 12)
    return torch.cat([J_base_lin, J_base_ang, J_joints], dim=-1)


def angular_jacobians(poses: Poses, bodies: np.ndarray) -> torch.Tensor:
    """Angular Jacobians for static body ids -> (B, K, 3, 18)."""
    B = poses.R.shape[0]
    K_ = len(bodies)
    base_R = poses.R[:, 0]
    zeros = torch.zeros((B, K_, 3, 3), dtype=poses.R.dtype, device=poses.R.device)
    mask = _mask(bodies, poses.R.device)[None, :, :, None]
    J_joints = torch.where(mask, poses.joint_axis_w[:, None], 0.0).transpose(-1, -2)
    return torch.cat([zeros, base_R[:, None].expand(B, K_, 3, 3), J_joints], dim=-1)


def qdot(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Time derivative of q (B, 19) given dq (B, 18)."""
    R = quat_to_rotmat(q[:, 3:7])
    pos_dot = torch.einsum("bij,bj->bi", R, dq[:, 0:3])
    omega_quat = torch.cat([dq[:, 3:6], torch.zeros_like(dq[:, :1])], dim=-1)
    quat_dot = 0.5 * quat_mul(q[:, 3:7], omega_quat)
    return torch.cat([pos_dot, quat_dot, dq[:, 6:18]], dim=-1)
