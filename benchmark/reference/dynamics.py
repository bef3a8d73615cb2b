"""Go2 rigid-body dynamics: M, bias, COM, centroidal inertia (batched).

A frozen plain copy of the system's rigid-body dynamics: the mass matrix as a sum of
per-body COM/angular Jacobian Grams, the bias ``C dq + g`` by Newton-Euler
with zero joint acceleration (velocity-product accelerations from one
forward-mode tangent along q̇), COM state and the centroidal inertia.
Inputs carry a leading batch axis; the constants in ``Go2Dyn`` do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import kinematics as K
from benchmark.reference.go2_params import DEFAULT_PARAMS, Go2Params

NV = 18
NUM_BODIES = 13
_GRAVITY = (0.0, 0.0, -9.81)


class Go2Dyn(NamedTuple):
    """Baked inertial constants + kinematic constants (unbatched)."""

    kin: K.Go2Kin
    mass: torch.Tensor  # (13,)
    com: torch.Tensor  # (13, 3) link COM in link frame
    inertia: torch.Tensor  # (13, 3, 3) about link COM, link frame
    total_mass: torch.Tensor  # ()


def build_dyn(params: Go2Params = DEFAULT_PARAMS, device="cpu", dtype=torch.float64) -> Go2Dyn:
    """Model constants on ``device`` in ``dtype``."""
    masses, coms, inertias = [], [], []
    links = [params.trunk]
    for leg in range(4):
        links += [params.link_inertia(b, leg) for b in ("hip", "thigh", "calf")]
    for link in links:
        masses.append(link.mass)
        coms.append(link.com)
        inertias.append(link.inertia_matrix())
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return Go2Dyn(
        kin=K.build_kin(params, device=device, dtype=dtype),
        mass=t(masses),
        com=t(np.array(coms)),
        inertia=t(np.stack(inertias)),
        total_mass=t(sum(masses)),
    )


def _gravity(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_GRAVITY, dtype=like.dtype, device=like.device)


def _body_jacobians(poses: K.Poses, dyn: Go2Dyn):
    """World COMs (B,13,3), COM linear Jacobians (B,13,3,18), angular
    Jacobians (B,13,3,18), world inertias (B,13,3,3)."""
    com_w = poses.p + torch.einsum("bkij,kj->bki", poses.R, dyn.com)
    bodies = np.arange(NUM_BODIES)
    Jc = K.point_jacobians(poses, com_w, bodies)
    Jw = K.angular_jacobians(poses, bodies)
    I_w = torch.einsum("bkij,kjl,bkml->bkim", poses.R, dyn.inertia, poses.R)
    return com_w, Jc, Jw, I_w


def mass_matrix(dyn: Go2Dyn, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix M(q) (B, 18, 18)."""
    poses = K.fk(dyn.kin, q)
    _, Jc, Jw, I_w = _body_jacobians(poses, dyn)
    M = torch.einsum("k,bkil,bkim->blm", dyn.mass, Jc, Jc)
    return M + torch.einsum("bkil,bkij,bkjm->blm", Jw, I_w, Jw)


def _body_velocities(dyn: Go2Dyn, q, dq):
    poses = K.fk(dyn.kin, q)
    _, Jc, Jw, _ = _body_jacobians(poses, dyn)
    return torch.einsum("bkij,bj->bki", Jw, dq), torch.einsum("bkij,bj->bki", Jc, dq)


def bias_forces(dyn: Go2Dyn, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Nonlinear effects b(q, dq) = C(q, dq) dq + g(q) (B, 18)."""
    poses = K.fk(dyn.kin, q)
    _, Jc, Jw, I_w = _body_jacobians(poses, dyn)
    (omega, _v), (alpha, a_com) = torch.func.jvp(
        lambda qq: _body_velocities(dyn, qq, dq), (q,), (K.qdot(q, dq),)
    )
    F = dyn.mass[:, None] * (a_com - _gravity(q))
    Iw_omega = torch.einsum("bkij,bkj->bki", I_w, omega)
    N = torch.einsum("bkij,bkj->bki", I_w, alpha) + torch.linalg.cross(omega, Iw_omega, dim=-1)
    return torch.einsum("bkij,bki->bj", Jc, F) + torch.einsum("bkij,bki->bj", Jw, N)


def com_state(dyn: Go2Dyn, q: torch.Tensor, dq: torch.Tensor):
    """(com_world (B, 3), vcom_world (B, 3))."""
    poses = K.fk(dyn.kin, q)
    com_w, Jc, _, _ = _body_jacobians(poses, dyn)
    com = torch.einsum("k,bki->bi", dyn.mass, com_w) / dyn.total_mass
    vcom = torch.einsum("k,bkij,bj->bi", dyn.mass, Jc, dq) / dyn.total_mass
    return com, vcom


def centroidal_inertia(dyn: Go2Dyn, q: torch.Tensor) -> torch.Tensor:
    """Centroidal rotational inertia I_g (B, 3, 3), world axes, about the COM."""
    poses = K.fk(dyn.kin, q)
    com_w, _, _, I_w = _body_jacobians(poses, dyn)
    com = torch.einsum("k,bki->bi", dyn.mass, com_w) / dyn.total_mass
    d = com_w - com[:, None, :]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    shift = dyn.mass[:, None, None] * (
        torch.einsum("bki,bki->bk", d, d)[..., None, None] * eye
        - torch.einsum("bki,bkj->bkij", d, d)
    )
    return torch.sum(I_w + shift, dim=1)


class TickModel(NamedTuple):
    """Every model quantity the 1 kHz controller/plant tick consumes."""

    foot_pos: torch.Tensor  # (B, 4, 3)
    foot_vel: torch.Tensor  # (B, 4, 3)
    J_feet: torch.Tensor  # (B, 4, 3, 18)
    M: torch.Tensor  # (B, 18, 18) mass matrix (no armature)
    bias: torch.Tensor  # (B, 18)
    jdot_qd: torch.Tensor  # (B, 4, 3)
    com: torch.Tensor  # (B, 3)
    vcom: torch.Tensor  # (B, 3)
    base_R: torch.Tensor  # (B, 3, 3)


_TICK_BODIES = np.concatenate([np.arange(NUM_BODIES), K.FOOT_BODIES])


def tick_model(dyn: Go2Dyn, q: torch.Tensor, dq: torch.Tensor) -> TickModel:
    """All per-tick model quantities from ONE primal pass + ONE tangent.

    ``torch.func.jvp`` evaluates the batched model once and carries one
    forward-mode tangent along q̇, which yields the velocity-product
    accelerations (for the bias) and the foot J̇·dq together — the
    counterpart of the JAX package's single ``jax.linearize``.
    """
    kin = dyn.kin
    bodies = np.arange(NUM_BODIES)

    def model_fn(qq):
        poses = K.fk(kin, qq)
        com_w = poses.p + torch.einsum("bkij,kj->bki", poses.R, dyn.com)
        pts = torch.cat([com_w, poses.foot_w], dim=1)  # (B, 17, 3)
        Jpts = K.point_jacobians(poses, pts, _TICK_BODIES)
        Jc, J_feet = Jpts[:, :NUM_BODIES], Jpts[:, NUM_BODIES:]
        Jw = K.angular_jacobians(poses, bodies)
        I_w = torch.einsum("bkij,kjl,bkml->bkim", poses.R, dyn.inertia, poses.R)
        v_b = torch.einsum("bkij,bj->bki", Jc, dq)
        w_b = torch.einsum("bkij,bj->bki", Jw, dq)
        fv = torch.einsum("blij,bj->bli", J_feet, dq)
        return (v_b, w_b, fv), (poses.foot_w, J_feet, Jc, Jw, I_w, com_w, poses.R[:, 0])

    vels, (a_com, alpha, jdot_qd), extras = torch.func.jvp(
        model_fn, (q,), (K.qdot(q, dq),), has_aux=True
    )
    v_bodies, w_bodies, foot_vel = vels
    foot_pos, J_feet, Jc, Jw, I_w, com_w, base_R = extras

    M = torch.einsum("k,bkil,bkim->blm", dyn.mass, Jc, Jc) + torch.einsum(
        "bkil,bkij,bkjm->blm", Jw, I_w, Jw
    )
    F = dyn.mass[:, None] * (a_com - _gravity(q))
    Iw_omega = torch.einsum("bkij,bkj->bki", I_w, w_bodies)
    N = torch.einsum("bkij,bkj->bki", I_w, alpha) + torch.linalg.cross(w_bodies, Iw_omega, dim=-1)
    bias = torch.einsum("bkij,bki->bj", Jc, F) + torch.einsum("bkij,bki->bj", Jw, N)
    com = torch.einsum("k,bki->bi", dyn.mass, com_w) / dyn.total_mass
    vcom = torch.einsum("k,bki->bi", dyn.mass, v_bodies) / dyn.total_mass
    return TickModel(
        foot_pos=foot_pos, foot_vel=foot_vel, J_feet=J_feet, M=M, bias=bias,
        jdot_qd=jdot_qd, com=com, vcom=vcom, base_R=base_R,
    )
