"""Batched rigid-body physics plant for the Go2 (penalty contact, 1 kHz).

Port of ``convex_mpc_tpu/sim/physics.py``: semi-implicit Euler on
M ddq = tau - b + J' f with every contact damping term folded into the
velocity solve,

    (M + dt J' C J + dt D) dq_new = M dq + dt (tau - bias + J' f_spring),

solved with the arrow (Schur-complement) factorization. ``ContactParams``
fields carry a leading batch axis inside the engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import F32, as_f32, default_device
from convex_mpc_tpu_torch.models import dynamics as D
from convex_mpc_tpu_torch.models import kinematics as K
from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS
from convex_mpc_tpu_torch.ops import linalg as lx
from convex_mpc_tpu_torch.ops.rotations import quat_integrate


class ContactParams(NamedTuple):
    kn: torch.Tensor  # normal stiffness, N/m
    dn: torch.Tensor  # normal damping, N/(m/s)
    mu: torch.Tensor  # Coulomb friction coefficient
    vtol: torch.Tensor  # tangential regularization velocity, m/s
    ground_z: torch.Tensor  # ground height, m
    foot_radius: torch.Tensor
    armature: torch.Tensor  # reflected rotor inertia per joint, kg m^2
    joint_damping: torch.Tensor  # viscous joint damping, Nm/(rad/s)


def default_contact(
    kn: float = 30000.0,
    dn: float = 1000.0,
    mu: float = 0.8,
    vtol: float = 0.05,
    ground_z: float = 0.0,
    foot_radius: float = 0.022,
    armature: float = 0.01,
    joint_damping: float = 0.1,
    device=None,
) -> ContactParams:
    """Unbatched contact parameters (tile with engine.broadcast_batch)."""
    device = default_device(device)
    f = lambda v: as_f32(v, device)
    return ContactParams(
        kn=f(kn), dn=f(dn), mu=f(mu), vtol=f(vtol), ground_z=f(ground_z),
        foot_radius=f(foot_radius), armature=f(armature), joint_damping=f(joint_damping),
    )


class PlantState(NamedTuple):
    q: torch.Tensor  # (..., 19) [pos, quat xyzw, joints]
    dq: torch.Tensor  # (..., 18) [v body, w body, joint vels]


def init_plant(dyn: D.Go2Dyn, x=0.0, y=0.0, z=None,
               contact: ContactParams | None = None) -> PlantState:
    """Unbatched standing configuration; unless ``z`` is given the feet sit
    at the contact springs' equilibrium penetration."""
    device = dyn.mass.device
    q = np.asarray(DEFAULT_PARAMS.default_q()).copy()
    q[0], q[1] = x, y
    if z is not None:
        q[2] = z
    else:
        c = contact if contact is not None else default_contact(device=device)
        poses = K.fk(dyn.kin, torch.as_tensor(q, dtype=F32, device=device)[None])
        foot_center_z = float(poses.foot_w[0, 0, 2])
        pen_eq = float(dyn.total_mass) * 9.81 / (4.0 * float(c.kn))
        target = float(c.ground_z) + float(c.foot_radius) - pen_eq
        q[2] += target - foot_center_z
    return PlantState(q=torch.as_tensor(q, dtype=F32, device=device),
                      dq=torch.zeros(18, dtype=F32, device=device))


def _contact_terms(contact: ContactParams, foot_pos, foot_vel):
    """Per-foot spring force f0 (B,4,3), implicit damping diagonal C (B,4,3)
    and the estimated normal force (B,4)."""
    c = lambda v: v[:, None]  # per-scenario scalar against the leg axis
    lowest = foot_pos[..., 2] - c(contact.foot_radius)
    pen = c(contact.ground_z) - lowest
    active = pen > 0.0
    f_spring_z = torch.where(active, c(contact.kn) * pen, 0.0)
    fz_est = torch.clamp(
        torch.where(active, c(contact.kn) * pen - c(contact.dn) * foot_vel[..., 2], 0.0),
        min=0.0,
    )
    pushing = fz_est > 0.0
    dn = torch.where(active & pushing, c(contact.dn), 0.0)
    vt_mag = torch.sqrt(torch.sum(foot_vel[..., 0:2] ** 2, dim=-1))
    ct = torch.where(
        active, c(contact.mu) * fz_est / torch.maximum(c(contact.vtol), vt_mag), 0.0
    )
    zero = torch.zeros_like(f_spring_z)
    f0 = torch.stack([zero, zero, f_spring_z], dim=-1)
    C = torch.stack([ct, ct, dn], dim=-1)
    return f0, C, fz_est


def contact_forces(contact: ContactParams, foot_pos, foot_vel):
    """(B, 4, 3) world contact forces (diagnostics)."""
    f0, C, _ = _contact_terms(contact, foot_pos, foot_vel)
    return f0 - C * foot_vel


def step(dyn: D.Go2Dyn, contact: ContactParams, state: PlantState, tau_joints, dt,
         *, J=None, M=None, bias=None, base_R=None, foot_pos=None, foot_vel=None
         ) -> PlantState:
    """One semi-implicit Euler step with implicit contact damping (batched)."""
    q, dq = state.q, state.dq
    B = q.shape[0]
    if J is None or base_R is None or foot_pos is None:
        poses = K.fk(dyn.kin, q)
        base_R = poses.R[:, 0]
        foot_pos = poses.foot_w
        J = K.point_jacobians(poses, poses.foot_w, K.FOOT_BODIES)
    if foot_vel is None:
        foot_vel = torch.einsum("blij,bj->bli", J, dq)

    f0, C, _ = _contact_terms(contact, foot_pos, foot_vel)

    if M is None:
        M = D.mass_matrix(dyn, q)
    zeros6 = torch.zeros((B, 6), dtype=q.dtype, device=q.device)
    arm = torch.cat([zeros6, contact.armature[:, None].expand(B, 12)], dim=-1)
    M = M + torch.diag_embed(arm)
    if bias is None:
        bias = D.bias_forces(dyn, q, dq)
    tau_gen = torch.cat([zeros6, tau_joints], dim=-1)

    rhs = torch.einsum("bij,bj->bi", M, dq) + dt * (
        tau_gen - bias + torch.einsum("blij,bli->bj", J, f0))
    jd = torch.cat([zeros6, contact.joint_damping[:, None].expand(B, 12)], dim=-1)
    A = M + dt * torch.einsum("blij,bli,blik->bjk", J, C, J) + dt * torch.diag_embed(jd)
    dq_new = lx.arrow_solve(lx.arrow_factor(A), rhs[..., None])[..., 0]

    pos_new = q[:, 0:3] + dt * torch.einsum("bij,bj->bi", base_R, dq_new[:, 0:3])
    quat_new = quat_integrate(q[:, 3:7], dq_new[:, 3:6], dt)
    joints_new = q[:, 7:19] + dt * dq_new[:, 6:18]
    return PlantState(q=torch.cat([pos_new, quat_new, joints_new], dim=-1), dq=dq_new)
