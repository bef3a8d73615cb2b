"""Gait scheduling, Raibert foot placement and min-jerk swing trajectories.

Port of ``convex_mpc_tpu/control/gait.py``. ``GaitParams`` fields carry a
leading batch axis (period (B,), phase_offset (B, 4), ...); every function
broadcasts the per-scenario gait fields against its other arguments, whose
first axis is the batch. Leg order everywhere: [FL, FR, RL, RR].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from convex_mpc_tpu_torch._device import F32, as_f32, const, default_device
from convex_mpc_tpu_torch.ops.rotations import rot_z


class GaitParams(NamedTuple):
    period: torch.Tensor  # (B,) gait period, s
    duty: torch.Tensor  # (B,) stance fraction
    phase_offset: torch.Tensor  # (B, 4) per-leg phase offsets
    swing_height: torch.Tensor  # (B,) swing apex height, m
    touchdown_z: torch.Tensor  # (B,) nominal touchdown height, m

    @property
    def stance_time(self) -> torch.Tensor:
        return self.duty * self.period

    @property
    def swing_time(self) -> torch.Tensor:
        return (1.0 - self.duty) * self.period


def make_gait_params(
    frequency_hz: float = 3.0,
    duty: float = 0.6,
    phase_offset=(0.5, 0.0, 0.0, 0.5),
    swing_height: float = 0.1,
    touchdown_z: float = 0.02,
    device=None,
) -> GaitParams:
    """Unbatched GaitParams from plain floats (tile with engine.broadcast_batch)."""
    device = default_device(device)
    return GaitParams(
        period=as_f32(1.0 / frequency_hz, device),
        duty=as_f32(duty, device),
        phase_offset=as_f32(phase_offset, device),
        swing_height=as_f32(swing_height, device),
        touchdown_z=as_f32(touchdown_z, device),
    )


def _bc(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Right-pad x's shape with unit axes so its batch axis lines up with like's."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def step_rows(dt, axes: int):
    """An MPC step ``dt`` to broadcast against batch-first tensors: a float
    stays as it is; a (B,) tensor, each scenario's step, gains ``axes``
    trailing unit axes."""
    if not torch.is_tensor(dt):
        return dt
    return dt.reshape((-1,) + (1,) * axes)


def contact_table(gait: GaitParams, t0, dt, n: int) -> torch.Tensor:
    """Contact schedule (B, 4, n) int32, 1 = stance; midpoint sampling.
    ``dt``: a float, or a (B,) tensor of each scenario's step."""
    k = torch.arange(n, dtype=F32, device=t0.device)
    t = t0[:, None] + k * step_rows(dt, 1) + step_rows(dt / 2.0, 1)  # (B, n)
    phases = torch.remainder(
        gait.phase_offset[:, :, None] + t[:, None, :] / gait.period[:, None, None], 1.0
    )
    return (phases < gait.duty[:, None, None]).to(torch.int32)


def current_mask(gait: GaitParams, t) -> torch.Tensor:
    """Instantaneous contact mask at time t (B,) -> (B, 4) int32."""
    return contact_table(gait, t, 0.0, 1)[:, :, 0]


def leg_phase(gait: GaitParams, t) -> torch.Tensor:
    return torch.remainder(gait.phase_offset + t[:, None] / gait.period[:, None], 1.0)


def _stack3(a, b, c):
    """Stack three broadcast-compatible components on a new last axis."""
    return torch.stack(torch.broadcast_tensors(a, b, c), dim=-1)


def _rotation_correction(hip_xy_rel, yaw_rate, pred_time):
    dtheta = yaw_rate * pred_time
    return _stack3(-dtheta * hip_xy_rel[..., 1], dtheta * hip_xy_rel[..., 0],
                   torch.zeros_like(dtheta))


def _rotate_hip(yaw, hip_offset):
    return torch.einsum("...ij,...j->...i", rot_z(yaw), hip_offset)


def touchdown_nominal(gait, base_pos, base_vel_xy, yaw, yaw_rate_des, hip_offset):
    """Feedback-free touchdown prediction (..., 3); ``yaw`` (B, ...) sets the
    broadcast shape of the gait fields."""
    t_swing = _bc(gait.swing_time, yaw)
    t_stance = _bc(gait.stance_time, yaw)
    big_t = t_swing + 0.5 * t_stance
    pred_time = big_t / 2.0

    hip_rel = _rotate_hip(yaw, hip_offset)
    nominal = _stack3(base_pos[..., 0] + hip_rel[..., 0], base_pos[..., 1] + hip_rel[..., 1],
                      _bc(gait.touchdown_z, yaw) + 0.0 * base_pos[..., 2])
    drift = _stack3(base_vel_xy[..., 0] * pred_time, base_vel_xy[..., 1] * pred_time,
                    torch.zeros_like(pred_time))
    rot_corr = _rotation_correction(hip_rel[..., :2], yaw_rate_des, pred_time)
    return nominal + drift + rot_corr


def touchdown_raibert(gait, base_pos, pos_com_world, vel_com_world, yaw, yaw_rate_des,
                      vel_des_world_xy, pos_des_world_xy, hip_offset,
                      clamp_correction: float | None = None):
    """Full Raibert touchdown with position/velocity feedback (..., 3)."""
    t_swing = _bc(gait.swing_time, yaw)
    t_stance = _bc(gait.stance_time, yaw)
    big_t = t_swing + 0.5 * t_stance
    pred_time = big_t / 2.0
    k_v_x = 0.4 * big_t
    k_p_x = 0.1
    k_v_y = 0.2 * big_t
    k_p_y = 0.05

    hip_rel = _rotate_hip(yaw, hip_offset)
    zero = torch.zeros_like(pred_time)
    nominal = _stack3(base_pos[..., 0] + hip_rel[..., 0], base_pos[..., 1] + hip_rel[..., 1],
                      _bc(gait.touchdown_z, yaw) + 0.0 * base_pos[..., 2])
    drift = _stack3(vel_des_world_xy[..., 0] * pred_time,
                    vel_des_world_xy[..., 1] * pred_time, zero)
    pos_corr = _stack3(k_p_x * (pos_com_world[..., 0] - pos_des_world_xy[..., 0]),
                       k_p_y * (pos_com_world[..., 1] - pos_des_world_xy[..., 1]), zero)
    vel_corr = _stack3(k_v_x * (vel_com_world[..., 0] - vel_des_world_xy[..., 0]),
                       k_v_y * (vel_com_world[..., 1] - vel_des_world_xy[..., 1]), zero)
    rot_corr = _rotation_correction(hip_rel[..., :2], yaw_rate_des, pred_time)
    correction = pos_corr + vel_corr
    if clamp_correction is not None:
        mag = torch.linalg.norm(correction[..., 0:2], dim=-1, keepdim=True)
        correction = correction * torch.clamp(
            clamp_correction / torch.clamp(mag, min=1e-9), max=1.0)
    return nominal + drift + correction + rot_corr


def swing_eval(p0, pf, t, t_swing, swing_height):
    """Min-jerk swing trajectory at time-since-takeoff t -> (p, v, a), each
    (..., 3); t, t_swing and swing_height broadcast against p0[..., 0]."""
    t_swing = torch.as_tensor(t_swing, dtype=t.dtype, device=t.device)
    safe_t_swing = torch.where(t_swing > 0, t_swing, 1.0)
    s = torch.where(t_swing > 0, torch.clamp(t / safe_t_swing, 0.0, 1.0), 1.0)
    s = s[..., None]
    t_swing = safe_t_swing
    dp = pf - p0

    mj = 10 * s**3 - 15 * s**4 + 6 * s**5
    dmj = 30 * s**2 - 60 * s**3 + 30 * s**4
    d2mj = 60 * s - 180 * s**2 + 120 * s**3

    t_swing = t_swing[..., None]
    p = p0 + dp * mj
    v = dp * dmj / t_swing
    a = dp * d2mj / (t_swing**2)

    b = 64 * s**3 * (1 - s) ** 3
    db = 192 * s**2 * (1 - s) ** 2 * (1 - 2 * s)
    d2b = 192 * (
        2 * s * (1 - s) ** 2 * (1 - 2 * s)
        - 2 * s**2 * (1 - s) * (1 - 2 * s)
        - 2 * s**2 * (1 - s) ** 2
    )

    h = torch.as_tensor(swing_height, dtype=t.dtype, device=t.device)[..., None]
    zhat = const("zhat", t.device, lambda d: torch.tensor([0.0, 0.0, 1.0], dtype=F32, device=d))
    p = p + h * b * zhat
    v = v + h * db / t_swing * zhat
    a = a + h * d2b / (t_swing**2) * zhat
    return p, v, a
