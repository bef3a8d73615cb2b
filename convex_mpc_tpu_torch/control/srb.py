"""Single-rigid-body centroidal dynamics, exact closed-form ZOH (batched).

Port of ``convex_mpc_tpu/control/srb.py``. State x = [p, rpy, v, omega]
(12,), input u = four world contact forces (12,). The continuous A is
nilpotent (A^2 = 0), so Ad = I + A dt and Bd = (I dt + A dt^2/2) Bc exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from convex_mpc_tpu_torch.control.gait import step_rows
from convex_mpc_tpu_torch.ops.rotations import hat, rot_z

GRAVITY = 9.81
NX = 12
NU = 12


class SrbDynamics(NamedTuple):
    Ad: torch.Tensor  # (B, 12, 12)
    Bd: torch.Tensor  # (B, N, 12, 12)
    gd: torch.Tensor  # (B, 12)


def continuous_A(yaw_avg: torch.Tensor) -> torch.Tensor:
    """Continuous-time A(yaw_avg) (B, 12, 12)."""
    B = yaw_avg.shape[0]
    A = torch.zeros((B, NX, NX), dtype=yaw_avg.dtype, device=yaw_avg.device)
    A[:, 0:3, 6:9] = torch.eye(3, dtype=yaw_avg.dtype, device=yaw_avg.device)
    A[:, 3:6, 9:12] = rot_z(yaw_avg).transpose(-1, -2)
    return A


def continuous_B(r_feet_world: torch.Tensor, mass, inertia_world: torch.Tensor) -> torch.Tensor:
    """Continuous-time input map Bc for one horizon step (B, 12, 12).

    r_feet_world (B, 4, 3) COM->foot levers in world axes, order [FL, FR,
    RL, RR]; mass (B,) or (); inertia_world (B, 3, 3).
    """
    B = r_feet_world.shape[0]
    dtype, device = r_feet_world.dtype, r_feet_world.device
    I_inv = torch.linalg.inv(inertia_world)
    ang = torch.einsum("bij,bfjk->bifk", I_inv, hat(r_feet_world)).reshape(B, 3, NU)
    m = torch.as_tensor(mass, dtype=dtype, device=device).reshape(-1, 1, 1)
    lin = (torch.eye(3, dtype=dtype, device=device) / m).repeat(1, 1, 4).expand(B, 3, NU)
    return torch.cat([torch.zeros((B, 6, NU), dtype=dtype, device=device), lin, ang], dim=1)


def continuous_g(B: int, dtype, device) -> torch.Tensor:
    g = torch.zeros((B, NX), dtype=dtype, device=device)
    g[:, 8] = -GRAVITY
    return g


def discretize(yaw_avg, r_feet_world, mass, inertia_world, dt) -> SrbDynamics:
    """Exact ZOH discretization over the horizon.

    yaw_avg (B,), r_feet_world (B, N, 4, 3), mass (B,) or (), inertia_world
    (B, 3, 3), dt a float or a (B,) tensor of each scenario's step.
    """
    B, n = r_feet_world.shape[0], r_feet_world.shape[1]
    dtype, device = r_feet_world.dtype, r_feet_world.device
    eye = torch.eye(NX, dtype=dtype, device=device)
    Ac = continuous_A(yaw_avg)
    h = step_rows(dt, 2)
    E = eye * h + Ac * step_rows(dt * dt / 2.0, 2)
    Ad = eye + Ac * h

    I_inv = torch.linalg.inv(inertia_world)  # (B, 3, 3)
    ang = torch.einsum("bij,bnfjk->bnfik", I_inv, hat(r_feet_world))  # (B, N, 4, 3, 3)
    ang = ang.permute(0, 1, 3, 2, 4).reshape(B, n, 3, NU)
    m = torch.as_tensor(mass, dtype=dtype, device=device).reshape(-1, 1, 1, 1)
    lin = (torch.eye(3, dtype=dtype, device=device) / m).repeat(1, 1, 1, 4)
    lin = lin.expand(B, n, 3, NU)
    Bc = torch.cat(
        [torch.zeros((B, n, 6, NU), dtype=dtype, device=device), lin, ang], dim=2
    )
    Bd = torch.einsum("bij,bnjk->bnik", E, Bc)
    gd = torch.einsum("bij,bj->bi", E, continuous_g(B, dtype, device))
    return SrbDynamics(Ad=Ad, Bd=Bd, gd=gd)


def rollout(dyn: SrbDynamics, x0: torch.Tensor, u_seq: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout x_{k+1} = Ad x_k + Bd_k u_k + gd from x0 (B, 12)
    under u_seq (B, N, 12) -> (B, N + 1, 12), x0 first."""
    xs = [x0]
    for k in range(u_seq.shape[1]):
        xs.append(torch.einsum("bij,bj->bi", dyn.Ad, xs[-1])
                  + torch.einsum("bij,bj->bi", dyn.Bd[:, k], u_seq[:, k]) + dyn.gd)
    return torch.stack(xs, dim=1)
