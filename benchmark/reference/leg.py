"""Swing/stance leg controller: per-leg joint torques at the 1 kHz rate.

A frozen plain copy of the system's leg controller with an explicit batch axis: the
takeoff latches are carried in ``LegControlState`` and updated with
``torch.where``; swing legs track a min-jerk trajectory with Cartesian PD +
operational-space feedforward, stance legs map the MPC force through J'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import dynamics as D
from benchmark.reference import gait as G
from benchmark.reference import kinematics as K
from benchmark.reference import linalg as lx

# controller gains and contact geometry, named once: compute_torques' defaults
# and the fused tick window (sim/tick_fused.py) both read these
KP = 500.0
KD = 200.0
GROUND_Z = 0.0
FOOT_RADIUS = 0.022
EARLY_CONTACT_FZ = 15.0


class LegObs(NamedTuple):
    J_feet: torch.Tensor  # (B, 4, 3, 18)
    M: torch.Tensor  # (B, 18, 18)
    bias: torch.Tensor  # (B, 18)
    jdot_qd: torch.Tensor  # (B, 4, 3)
    foot_pos: torch.Tensor  # (B, 4, 3)
    foot_vel: torch.Tensor  # (B, 4, 3)
    base_pos: torch.Tensor  # (B, 3)
    pos_com_world: torch.Tensor  # (B, 3)
    vel_com_world: torch.Tensor  # (B, 3)
    yaw: torch.Tensor  # (B,) continuous yaw
    base_R: torch.Tensor  # (B, 3, 3)


class LegControlState(NamedTuple):
    last_mask: torch.Tensor  # (B, 4) int32; init 2
    takeoff_time: torch.Tensor  # (B, 4)
    swing_p0: torch.Tensor  # (B, 4, 3)
    swing_td: torch.Tensor  # (B, 4, 3)


class LegOutput(NamedTuple):
    tau: torch.Tensor  # (B, 4, 3)
    pos_des: torch.Tensor
    pos_now: torch.Tensor
    vel_des: torch.Tensor
    vel_now: torch.Tensor


def init_state(device, dtype=torch.float64) -> LegControlState:
    """Unbatched initial controller state."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return LegControlState(
        last_mask=torch.full((4,), 2, dtype=torch.int32, device=device),
        takeoff_time=z(4), swing_p0=z(4, 3), swing_td=z(4, 3),
    )


def make_leg_obs(dyn: D.Go2Dyn, q, dq, yaw) -> LegObs:
    """All controller inputs from one ``tick_model`` evaluation."""
    tm = D.tick_model(dyn, q, dq)
    return LegObs(
        J_feet=tm.J_feet, M=tm.M, bias=tm.bias, jdot_qd=tm.jdot_qd,
        foot_pos=tm.foot_pos, foot_vel=tm.foot_vel, base_pos=q[:, 0:3],
        pos_com_world=tm.com, vel_com_world=tm.vcom, yaw=yaw, base_R=tm.base_R,
    )


def compute_torques(
    state: LegControlState,
    gait: G.GaitParams,
    obs: LegObs,
    contact_force,  # (B, 4, 3)
    pos_des_world,  # (B, 3)
    vel_des_world,  # (B, 3)
    yaw_rate_des,  # (B,)
    t,  # (B,)
    kp: float = KP,
    kd: float = KD,
    ground_z: float = GROUND_Z,
    foot_radius: float = FOOT_RADIUS,
    early_contact_fz: float = EARLY_CONTACT_FZ,
    raibert_clamp: float | None = None,
) -> tuple[LegOutput, LegControlState]:
    """One 1 kHz controller tick for all four legs of every scenario."""
    B = t.shape[0]
    mask = G.current_mask(gait, t)  # (B, 4)
    edge = mask != state.last_mask
    takeoff = edge & (mask == 0)

    hip = K.hip_offsets(t.device, t.dtype)
    td_all = G.touchdown_raibert(
        gait, obs.base_pos[:, None], obs.pos_com_world[:, None],
        obs.vel_com_world[:, None], obs.yaw[:, None].expand(B, 4),
        yaw_rate_des[:, None], vel_des_world[:, None, 0:2],
        pos_des_world[:, None, 0:2], hip, clamp_correction=raibert_clamp,
    )  # (B, 4, 3)

    takeoff_time = torch.where(takeoff, t[:, None], state.takeoff_time)
    swing_p0 = torch.where(takeoff[..., None], obs.foot_pos, state.swing_p0)
    swing_td = torch.where(takeoff[..., None], td_all, state.swing_td)

    t_since = t[:, None] - takeoff_time  # (B, 4)
    p_des, v_des, a_des = G.swing_eval(
        swing_p0, swing_td, t_since, gait.swing_time[:, None], gait.swing_height[:, None]
    )

    fac = lx.arrow_factor(obs.M)
    X = lx.arrow_solve(fac, obs.J_feet.reshape(B, 12, 18).transpose(1, 2))  # (B, 18, 12)
    Minv_Jt = torch.movedim(X.reshape(B, 18, 4, 3), 1, 2)  # (B, 4, 18, 3)
    JMJt = torch.einsum("blij,bljk->blik", obs.J_feet, Minv_Jt)
    lam = lx.inv3(JMJt)
    f_ff = torch.einsum("blij,blj->bli", lam, a_des - obs.jdot_qd)

    force_sw = kp * (p_des - obs.foot_pos) + kd * (v_des - obs.foot_vel) + f_ff

    J_leg = torch.stack(
        [obs.J_feet[:, l, :, 6 + 3 * l : 9 + 3 * l] for l in range(4)], dim=1
    )  # (B, 4, 3, 3)
    bias_leg = obs.bias[:, 6:18].reshape(B, 4, 3)

    tau_swing = torch.einsum("blji,blj->bli", J_leg, force_sw) + bias_leg
    tau_stance = torch.einsum("blji,blj->bli", J_leg, -contact_force)

    # early contact: divides by the raw swing time, as the JAX controller does
    s_phase = torch.clamp(t_since / gait.swing_time[:, None], 0.0, 1.0)
    touching = obs.foot_pos[..., 2] - foot_radius <= ground_z + 1e-3
    early = (mask == 0) & (s_phase > 0.5) & touching
    f_xy = kp * (swing_td[..., 0:2] - obs.foot_pos[..., 0:2]) - kd * obs.foot_vel[..., 0:2]
    f_cap = 0.8 * early_contact_fz
    f_norm = torch.linalg.norm(f_xy, dim=-1, keepdim=True)
    f_xy = f_xy * torch.clamp(f_cap / torch.clamp(f_norm, min=1e-6), max=1.0)
    f_early = torch.cat([f_xy, torch.full_like(f_xy[..., :1], -early_contact_fz)], dim=-1)
    tau_early = torch.einsum("blji,blj->bli", J_leg, f_early)

    in_swing = (mask == 0)[..., None]
    tau = torch.where(early[..., None], tau_early, torch.where(in_swing, tau_swing, tau_stance))
    out = LegOutput(
        tau=tau,
        pos_des=torch.where(in_swing, p_des, obs.foot_pos),
        pos_now=obs.foot_pos,
        vel_des=torch.where(in_swing, v_des, obs.foot_vel),
        vel_now=obs.foot_vel,
    )
    new_state = LegControlState(
        last_mask=mask, takeoff_time=takeoff_time, swing_p0=swing_p0, swing_td=swing_td,
    )
    return out, new_state
