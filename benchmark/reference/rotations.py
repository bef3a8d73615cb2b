"""Rotation utilities (quaternions, ZYX Euler, axis rotations).

Conventions as in the JAX package: quaternions are ``[x, y, z, w]`` and map
BODY -> WORLD; Euler angles are ZYX (``R = Rz(yaw) Ry(pitch) Rx(roll)``).
Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v (..., 3) -> (..., 3, 3); hat(v) w = v x w."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_to_rotmat(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [x,y,z,w] (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q_xyzw[..., 0], q_xyzw[..., 1], q_xyzw[..., 2], q_xyzw[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> ZYX Euler [roll, pitch, yaw] (..., 3)."""
    pitch = torch.atan2(
        -R[..., 2, 0], torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    )
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rpy(q_xyzw: torch.Tensor) -> torch.Tensor:
    return rotmat_to_rpy(quat_to_rotmat(q_xyzw))


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw-only rotation matrix (...,) -> (..., 3, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero], dim=-1),
            torch.stack([s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of xyzw quaternions: rotation q1 applied after q2."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_integrate(q_xyzw: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """q' = q * exp(omega_body dt / 2), renormalized."""
    ang = omega_body * dt
    theta = torch.linalg.norm(ang, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-8
    k = torch.where(
        small, 0.5, torch.sin(half) / torch.where(small, 1.0, theta)
    )
    dq = torch.cat([ang * k, torch.cos(half)], dim=-1)
    out = quat_mul(q_xyzw, dq)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def yaw_unwrap_step(yaw_meas, yaw_prev_meas, yaw_cont):
    """One continuous-yaw unwrap step -> (new_yaw_cont, new_yaw_prev_meas).

    ``jnp.mod`` is floor-mod: ``torch.remainder``, never ``torch.fmod``.
    """
    delta = torch.remainder(yaw_meas - yaw_prev_meas + math.pi, 2.0 * math.pi) - math.pi
    return yaw_cont + delta, yaw_meas
