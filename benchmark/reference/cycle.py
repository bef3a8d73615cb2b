"""One MPC period of the Go2 controller, written plainly: the reference the
benchmark holds the system's cycle against.

A cycle has three stages, as the system's ``mpc_cycle_batch`` has them:

- ``update``: the command in effect, the centroidal observation, the COM
  reference and the foot levers over the horizon, and the condensed QP in
  the frame of the current COM (``condensed.build``);
- the solve of that QP (``qp.solve``, an interior-point method run to its
  optimum, where the system runs a batch-global ADMM with a polish);
- ``apply``: ``steps`` ticks of 1 kHz leg control and the penalty-contact
  plant under the first step's forces.

Every function works in the dtype of its inputs and on a batch axis. The
state is a plain dict of tensors, keyed as the system's ``EngineState``
names its fields (plant ``q``/``dq``, leg ``last_mask``/``takeoff_time``/
``swing_p0``/``swing_td``, refgen ``pos_des_world``/``vel_cmd``,
``yaw_cont``, ``yaw_prev``, ``u0``, ``t``, ``vel_filt``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import condensed
from benchmark.reference import dynamics as D
from benchmark.reference import gait as G
from benchmark.reference import kinematics as K
from benchmark.reference import leg as L
from benchmark.reference import physics as P
from benchmark.reference import refgen as R
from benchmark.reference.go2_params import DEFAULT_PARAMS
from benchmark.reference.rotations import quat_to_rpy, yaw_unwrap_step

STATE_KEYS = ("q", "dq", "last_mask", "takeoff_time", "swing_p0", "swing_td", "pos_des_world",
              "vel_cmd", "yaw_cont", "yaw_prev", "u0", "t", "vel_filt")


class Setting:
    """What a deployment fixes: the model in ``dtype`` on ``device``, each
    scenario's gait and MPC step, the contact, each scenario's command, and
    the MPC's settings. ``mpc_dt`` is a float where every scenario's gait
    period is the same, else a (B,) float64 tensor."""

    def __init__(self, cfg: dict, gait: dict, commands, kn, dn, mu, device, dtype):
        """``cfg``: the configuration's ``mpc``/``sim`` settings; ``gait``:
        each scenario's ``frequency_hz``, ``duty``, ``swing_height``,
        ``touchdown_z`` and ``gait_period`` (B,) and ``phase_offset`` (B, 4),
        float64; ``commands`` (B, 3) [vx, vy, wz]; ``kn``, ``dn``, ``mu``
        (B,) or scalars."""
        self.cfg = cfg
        self.dyn = D.build_dyn(device=device, dtype=dtype)
        B = commands.shape[0]
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
        vec = lambda v: t(v).expand(B).clone()  # noqa: E731
        self.gait = G.GaitParams(
            period=t(1.0 / np.asarray(gait["frequency_hz"], np.float64)), duty=t(gait["duty"]),
            phase_offset=t(gait["phase_offset"]), swing_height=t(gait["swing_height"]),
            touchdown_z=t(gait["touchdown_z"]))
        step = np.asarray(gait["gait_period"], np.float64) / cfg["horizon"]
        self.mpc_dt = (float(step[0]) if (step == step[0]).all() else
                       torch.as_tensor(step, dtype=torch.float64, device=device))
        base = P.default_contact(device=device, dtype=dtype)
        self.contact = P.ContactParams(
            kn=vec(kn), dn=vec(dn), mu=vec(mu), vtol=vec(base.vtol), ground_z=vec(0.0),
            foot_radius=vec(base.foot_radius), armature=vec(base.armature),
            joint_damping=vec(base.joint_damping))
        c = t(commands)
        self.cmd = R.BodyCommand(vx=c[:, 0], vy=c[:, 1], z_pos=vec(cfg["z_des"]),
                                 yaw_rate=c[:, 2])

    def rows(self, idx) -> "Setting":
        """The same setting for the scenarios ``idx`` alone."""
        out = object.__new__(Setting)
        out.cfg, out.dyn = self.cfg, self.dyn
        out.gait = G.GaitParams(*(v[idx] for v in self.gait))
        out.mpc_dt = self.mpc_dt[idx] if torch.is_tensor(self.mpc_dt) else self.mpc_dt
        out.contact = P.ContactParams(*(v[idx] for v in self.contact))
        out.cmd = R.BodyCommand(*(v[idx] for v in self.cmd))
        return out


def init_state(st: Setting, x_offset) -> dict:
    """The start of every scenario: standing at rest with the feet at the
    equilibrium of the default contact springs, the body shifted by
    ``x_offset`` (B,) along x; the COM target is the unshifted stance's."""
    dyn = st.dyn
    dtype, dev = dyn.mass.dtype, dyn.mass.device
    x_offset = torch.as_tensor(x_offset, dtype=dtype, device=dev)
    B = x_offset.shape[0]
    plant = P.init_plant(dyn)
    dq = torch.zeros((B, 18), dtype=dtype, device=dev)
    com, _ = D.com_state(dyn, plant.q.expand(B, -1), dq)
    q = plant.q.expand(B, -1).clone()
    q[:, 0] += x_offset
    z = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=dev)  # noqa: E731
    return dict(q=q, dq=dq, last_mask=torch.full((B, 4), 2, dtype=torch.int32, device=dev),
                takeoff_time=z(4), swing_p0=z(4, 3), swing_td=z(4, 3), pos_des_world=com,
                vel_cmd=z(3), yaw_cont=z(), yaw_prev=z(), u0=z(4, 3), t=z(), vel_filt=z(6))


def observe(dyn, q, dq, yaw_cont, yaw_prev, vel_filt):
    """(CentroidalObs, yaw_cont, yaw_prev): the filtered velocity stands in
    for the raw one, as in the system."""
    rpy = quat_to_rpy(q[:, 3:7])
    cont, prev = yaw_unwrap_step(rpy[:, 2], yaw_prev, yaw_cont)
    poses = K.fk(dyn.kin, q)
    com, _ = D.com_state(dyn, q, dq)
    x_vec = torch.cat([com, torch.stack([rpy[:, 0], rpy[:, 1], cont], -1), vel_filt], -1)
    obs = R.CentroidalObs(x_vec=x_vec, R_body_to_world=poses.R[:, 0],
                          foot_levers=poses.foot_w - com[:, None, :], mass=dyn.total_mass,
                          inertia_world=D.centroidal_inertia(dyn, q))
    return obs, cont, prev


def update(st: Setting, s: dict):
    """The update stage -> (QP, reference trajectory, its refgen state,
    yaw_cont, yaw_prev). The command schedule is constant in time."""
    cfg = st.cfg
    obs, yc, yp = observe(st.dyn, s["q"], s["dq"], s["yaw_cont"], s["yaw_prev"], s["vel_filt"])
    rg = R.RefGenState(pos_des_world=s["pos_des_world"], vel_cmd=s["vel_cmd"])
    traj, rg_new = R.generate(rg, st.gait, obs, st.cmd, s["t"], st.mpc_dt, cfg["horizon"],
                              max_pos_error=cfg["max_pos_error"])
    p0 = traj.x0[:, 0:3]
    x0 = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], -1)
    x_ref = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]], -1)
    qp = condensed.build(traj.dyn, x0, x_ref, traj.contact, cfg["q_diag"], cfg["r_value"],
                         cfg["mu_mpc"], cfg["fz_min"])
    return qp, traj, rg_new, yc, yp


def torque_limits(tau_max: float, dtype, device) -> torch.Tensor:
    p = DEFAULT_PARAMS
    lim = torch.tensor([p.hip_torque_max, p.thigh_torque_max, p.calf_torque_max],
                       dtype=dtype, device=device).repeat(4).reshape(4, 3)
    return torch.clamp(lim, max=tau_max)


def apply(st: Setting, s: dict, traj, rg_new, yc, yp, u0) -> dict:
    """The apply stage: ``steps`` ticks under the forces ``u0`` (B, 4, 3)
    -> the next cycle's state."""
    cfg, dyn = st.cfg, st.dyn
    B = u0.shape[0]
    dt = cfg["sim_dt"]
    alpha = 1.0 - math.exp(-2.0 * math.pi * cfg["vel_filter_hz"] * dt)
    lim = torque_limits(cfg["tau_max"], u0.dtype, u0.device)
    plant = P.PlantState(q=s["q"], dq=s["dq"])
    leg = L.LegControlState(last_mask=s["last_mask"], takeoff_time=s["takeoff_time"],
                            swing_p0=s["swing_p0"], swing_td=s["swing_td"])
    vf, t = s["vel_filt"], s["t"]
    for _ in range(cfg["steps_per_mpc"]):
        rpy = quat_to_rpy(plant.q[:, 3:7])
        yc, yp = yaw_unwrap_step(rpy[:, 2], yp, yc)
        obs = L.make_leg_obs(dyn, plant.q, plant.dq, yc)
        omega_w = torch.einsum("bij,bj->bi", obs.base_R, plant.dq[:, 3:6])
        vf = vf + alpha * (torch.cat([obs.vel_com_world, omega_w], -1) - vf)
        obs = obs._replace(vel_com_world=vf[:, 0:3])
        out, leg = L.compute_torques(leg, st.gait, obs, u0, traj.pos_des_world,
                                     traj.vel_des_world, st.cmd.yaw_rate, t)
        tau = torch.clamp(out.tau, -lim, lim)
        plant = P.step(dyn, st.contact, plant, tau.reshape(B, 12), dt, J=obs.J_feet, M=obs.M,
                       bias=obs.bias, base_R=obs.base_R, foot_pos=obs.foot_pos,
                       foot_vel=obs.foot_vel)
        t = (t.to(G.CLOCK) + dt).to(t.dtype)  # the float32 clock
    return dict(q=plant.q, dq=plant.dq, last_mask=leg.last_mask,
                takeoff_time=leg.takeoff_time, swing_p0=leg.swing_p0, swing_td=leg.swing_td,
                pos_des_world=rg_new.pos_des_world, vel_cmd=rg_new.vel_cmd, yaw_cont=yc,
                yaw_prev=yp, u0=u0, t=t, vel_filt=vf)
