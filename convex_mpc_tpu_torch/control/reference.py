"""COM reference trajectory + predicted foot lever arms for the MPC horizon.

Port of ``convex_mpc_tpu/control/reference.py`` with an explicit batch
axis. The horizon ``lax.scan`` of the foot-lever prediction becomes a
Python loop over the N steps on (B, 4, 3) tensors. Reference quirks are
kept as spec (mask_previous = [2,2,2,2] on the first step; the drift term
is fed the body-frame velocity components).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from convex_mpc_tpu_torch._device import F32, const
from convex_mpc_tpu_torch.control import gait as G
from convex_mpc_tpu_torch.control.srb import SrbDynamics, discretize
from convex_mpc_tpu_torch.models.kinematics import hip_offsets as _hip_offsets
from convex_mpc_tpu_torch.ops.rotations import rot_z


class CentroidalObs(NamedTuple):
    x_vec: torch.Tensor  # (B, 12) [p_com, rpy(cont. yaw), v_com, omega_world]
    R_body_to_world: torch.Tensor  # (B, 3, 3)
    foot_levers: torch.Tensor  # (B, 4, 3) COM -> foot, world
    mass: torch.Tensor  # () or (B,)
    inertia_world: torch.Tensor  # (B, 3, 3)


class BodyCommand(NamedTuple):
    vx: torch.Tensor  # (B,)
    vy: torch.Tensor  # (B,)
    z_pos: torch.Tensor  # (B,)
    yaw_rate: torch.Tensor  # (B,)


class RefGenState(NamedTuple):
    pos_des_world: torch.Tensor  # (B, 3) persistent COM position target
    vel_cmd: torch.Tensor  # (B, 3) braking-limited (vx, vy, yaw_rate)


class ReferenceTraj(NamedTuple):
    x0: torch.Tensor  # (B, 12)
    x_ref: torch.Tensor  # (B, N, 12)
    contact: torch.Tensor  # (B, 4, N)
    r_feet: torch.Tensor  # (B, N, 4, 3)
    dyn: SrbDynamics
    pos_des_world: torch.Tensor  # (B, 3)
    vel_des_world: torch.Tensor  # (B, 3)


def init_state(x_vec: torch.Tensor) -> RefGenState:
    """Initial target = current COM position; x_vec (..., 12)."""
    return RefGenState(pos_des_world=x_vec[..., 0:3],
                       vel_cmd=torch.zeros_like(x_vec[..., 0:3]))


def generate(
    state: RefGenState,
    gait: G.GaitParams,
    obs: CentroidalObs,
    cmd: BodyCommand,
    time_now,
    dt,
    n: int,
    max_pos_error: float = 0.1,
    brake_accel: float = 0.0,
    brake_alpha: float = 0.0,
) -> tuple[ReferenceTraj, RefGenState]:
    """One MPC-rate reference generation for a batch (time_now (B,))."""
    x0 = obs.x_vec
    B = x0.shape[0]
    dev = x0.device
    p0 = x0[:, 0:3]
    yaw = x0[:, 5]

    v_tgt = torch.stack([cmd.vx, cmd.vy, cmd.yaw_rate], dim=-1)
    if brake_accel > 0.0 or brake_alpha > 0.0:
        rate = const(("brake_rate", brake_accel, brake_alpha), dev, lambda d: torch.tensor(
            [brake_accel or math.inf, brake_accel or math.inf, brake_alpha or math.inf],
            dtype=F32, device=d))
        braking = torch.abs(v_tgt) < torch.abs(state.vel_cmd)
        lim = rate * dt
        dv = torch.clamp(v_tgt - state.vel_cmd, -lim, lim)
        v_cmd = torch.where(braking, state.vel_cmd + dv, v_tgt)
    else:
        v_cmd = v_tgt
    cmd = cmd._replace(vx=v_cmd[:, 0], vy=v_cmd[:, 1], yaw_rate=v_cmd[:, 2])

    pos_des = state.pos_des_world
    pos_des_xy = torch.clamp(
        pos_des[:, 0:2], p0[:, 0:2] - max_pos_error, p0[:, 0:2] + max_pos_error
    )
    pos_des = torch.cat([pos_des_xy, cmd.z_pos[:, None]], dim=-1)

    vel_des_world = torch.einsum(
        "bij,bj->bi", rot_z(yaw),
        torch.stack([cmd.vx, cmd.vy, torch.zeros_like(cmd.vx)], dim=-1))

    t_vec = (torch.arange(n, device=dev) + 1).to(F32) * dt  # (N,)
    pos_traj = pos_des[:, :, None] + vel_des_world[:, :, None] * t_vec  # (B, 3, N)
    vel_traj = vel_des_world[:, :, None].expand(B, 3, n)
    yaw_traj = yaw[:, None] + cmd.yaw_rate[:, None] * t_vec  # (B, N)
    zeros = torch.zeros((B, n), dtype=F32, device=dev)
    rpy_traj = torch.stack([zeros, zeros, yaw_traj], dim=1)
    omega_traj = torch.stack([zeros, zeros, cmd.yaw_rate[:, None].expand(B, n)], dim=1)

    contact = G.contact_table(gait, time_now, dt, n)  # (B, 4, N)

    v_body = torch.einsum("bji,bj->bi", obs.R_body_to_world, vel_des_world)
    hip_offsets = _hip_offsets(dev)  # (4, 3)

    pos_traj_t = pos_traj.transpose(1, 2)  # (B, N, 3)
    td_all = G.touchdown_nominal(
        gait, pos_traj_t[:, :, None, :], v_body[:, None, None, 0:2],
        yaw_traj[:, :, None], cmd.yaw_rate[:, None, None], hip_offsets,
    )  # (B, N, 4, 3)
    r_td_all = td_all - pos_traj_t[:, :, None, :]

    # masks at the exact times t + i dt (not midpoints)
    k = torch.arange(n, device=dev).to(F32) * dt
    t_i = time_now[:, None] + k  # (B, N)
    phases = torch.remainder(
        gait.phase_offset[:, None, :] + t_i[:, :, None] / gait.period[:, None, None], 1.0
    )
    masks = (phases < gait.duty[:, None, None]).to(torch.int32)  # (B, N, 4)

    mask_prev = torch.full((B, 4), 2, dtype=torch.int32, device=dev)
    r_prev = torch.zeros((B, 4, 3), dtype=F32, device=dev)
    r_next_td = obs.foot_levers
    r_list = []
    for i in range(n):
        mask_i = masks[:, i]
        edge = mask_i != mask_prev
        takeoff = (edge & (mask_i == 0))[:, :, None]
        touchdown = (edge & (mask_i == 1))[:, :, None]
        r_next_td = torch.where(takeoff, r_td_all[:, i], r_next_td)
        r_prev = torch.where(takeoff, 0.0, torch.where(touchdown, r_next_td, r_prev))
        mask_prev = mask_i
        r_list.append(r_prev)
    r_feet = torch.stack(r_list, dim=1)  # (B, N, 4, 3)

    x_ref = torch.cat([pos_traj, rpy_traj, vel_traj, omega_traj], dim=1).transpose(1, 2)

    yaw_avg = torch.mean(yaw_traj, dim=-1)
    dyn = discretize(yaw_avg, r_feet, obs.mass, obs.inertia_world, dt)

    traj = ReferenceTraj(
        x0=x0, x_ref=x_ref.contiguous(), contact=contact, r_feet=r_feet, dyn=dyn,
        pos_des_world=pos_des, vel_des_world=vel_des_world,
    )
    return traj, RefGenState(pos_des_world=pos_des, vel_cmd=v_cmd)
