"""Centroidal MPC QP assembly: the full form and the layout shared with the condensed form.

Port of ``convex_mpc_tpu/mpc/qp.py``, batched over a leading axis B. The
decision variable is z = [X; U] (N stacked 12-states after each step, then
N stacked 12-vectors of world contact forces). Constraint rows, in order:

- [0, 12N): dynamics equalities x_k - Ad x_{k-1} - Bd_k u_k = rhs_k (the x_0
  term moves to the right side of the first step);
- [12N, 28N): the friction pyramid, 4 faces per leg per step, upper bound 0
  for stance legs and +inf for swing legs;
- [28N, 40N): force boxes (identity on U): swing legs pinned to 0, stance
  legs fz >= fz_min.

Cost (1/2) z'Pz + q'z with P = diag(2Q ... 2R ...) and q_x = -2 Q x_ref.
The nonzero placements of A are static: one table of flat indices per
(N, device), built once through ``_device.const``, and A is one scatter of
the values into zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import F32, const, default_device

NX = 12
NU = 12
FRICTION_FACES = 16  # 4 faces x 4 legs per step


class QpData(NamedTuple):
    """Dense QP: min 1/2 z'Pz + q'z  s.t.  l <= A z <= u.

    P is diagonal for the full form (``p_dense`` None); the condensed form
    carries a dense P in ``p_dense`` (``p_diag`` then holds its diagonal).
    """

    p_diag: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    p_dense: torch.Tensor | None = None


def n_vars(n: int) -> int:
    return n * (NX + NU)


def n_rows(n: int) -> int:
    return n * NX + n * FRICTION_FACES + n * NU


def cost_diag(n: int, q_diag, r_value, device=None) -> torch.Tensor:
    """P's diagonal (nz,): [2 Q] N times, then [2 R] N times; on q_diag's
    device when it is a tensor, else on ``device``."""
    if not isinstance(q_diag, torch.Tensor):
        q_diag = torch.as_tensor(q_diag, dtype=F32, device=default_device(device))
    qd = q_diag.to(F32)
    rr = torch.full((n * NU,), 2.0 * r_value, dtype=F32, device=qd.device)
    return torch.cat([(2.0 * qd).repeat(n), rr])


def _friction_face_matrix(mu: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) pyramid faces [fx - mu fz, -fx - mu fz, fy - mu fz, -fy - mu fz]."""
    one = torch.ones_like(mu)
    zero = torch.zeros_like(mu)
    return torch.stack(
        [
            torch.stack([one, zero, -mu], dim=-1),
            torch.stack([-one, zero, -mu], dim=-1),
            torch.stack([zero, one, -mu], dim=-1),
            torch.stack([zero, -one, -mu], dim=-1),
        ],
        dim=-2,
    )


def _placements(n: int) -> np.ndarray:
    """Flat indices into A (m, nz) of the values ``build_qp`` scatters, in
    the order it concatenates them: I on the state block, -Ad on its first
    block subdiagonal, -Bd_k on the force block diagonal, the per-step
    friction block, I on the force box rows."""
    nz, m_eq, m_fr = n_vars(n), n * NX, n * FRICTION_FACES
    u0 = n * NX  # first force column
    k = np.arange(n)[:, None, None]
    a = np.arange(NX)[None, :, None]
    c = np.arange(NU)[None, None, :]
    f = np.arange(FRICTION_FACES)[None, :, None]
    j = np.arange(n * NU)
    eye_x = np.arange(m_eq) * nz + np.arange(m_eq)
    sub = ((k[1:] * NX + a) * nz + (k[:-1] * NX + c)).reshape(-1)
    bd = ((k * NX + a) * nz + (u0 + k * NU + c)).reshape(-1)
    fr = ((m_eq + k * FRICTION_FACES + f) * nz + (u0 + k * NU + c)).reshape(-1)
    box = (m_eq + m_fr + j) * nz + (u0 + j)
    return np.concatenate([eye_x, sub, bd, fr, box])


def build_qp(dyn, x0, x_ref, contact, q_diag, r_value, mu, fz_min) -> QpData:
    """The full-form QP of a batch.

    dyn: SrbDynamics (Ad (B, 12, 12), Bd (B, N, 12, 12), gd (B, 12)); x0
    (B, 12); x_ref (B, N, 12); contact (B, 4, N), 1 = stance; q_diag (12,);
    r_value, mu, fz_min floats (mu may also be a (B,) tensor).
    """
    B, n = x_ref.shape[0], x_ref.shape[1]
    nz, m = n_vars(n), n_rows(n)
    dtype, dev = x_ref.dtype, x_ref.device
    qd = torch.as_tensor(q_diag, dtype=dtype, device=dev)

    p_diag = cost_diag(n, qd, r_value).expand(B, nz)
    q_x = ((-2.0 * qd)[None, None, :] * x_ref).reshape(B, n * NX)
    q_vec = torch.cat([q_x, torch.zeros((B, n * NU), dtype=dtype, device=dev)], dim=-1)

    faces = _friction_face_matrix(torch.as_tensor(mu, dtype=dtype, device=dev).expand(B))
    leg_block = torch.zeros((B, FRICTION_FACES, NU), dtype=dtype, device=dev)
    for leg in range(4):
        leg_block[:, 4 * leg:4 * leg + 4, 3 * leg:3 * leg + 3] = faces
    vals = torch.cat([
        torch.ones((B, n * NX), dtype=dtype, device=dev),
        (-dyn.Ad.to(dtype))[:, None].expand(B, n - 1, NX, NX).reshape(B, -1),
        (-dyn.Bd.to(dtype)).reshape(B, -1),
        leg_block[:, None].expand(B, n, FRICTION_FACES, NU).reshape(B, -1),
        torch.ones((B, n * NU), dtype=dtype, device=dev),
    ], dim=-1)
    idx = const(("full_qp_placements", n), dev,
                lambda d: torch.as_tensor(_placements(n), dtype=torch.long, device=d))
    A = torch.zeros((B, m * nz), dtype=dtype, device=dev)
    A[:, idx] = vals
    A = A.reshape(B, m, nz)

    rhs = dyn.gd.to(dtype)[:, None, :].repeat(1, n, 1)
    rhs[:, 0] = rhs[:, 0] + torch.einsum("bij,bj->bi", dyn.Ad.to(dtype), x0.to(dtype))
    beq = rhs.reshape(B, n * NX)

    inf = float("inf")
    stance = contact.to(torch.bool).transpose(1, 2)  # (B, N, 4)
    stance_faces = stance.repeat_interleave(4, dim=2).reshape(B, n * FRICTION_FACES)
    u_fr = torch.where(stance_faces, 0.0, inf).to(dtype)
    l_fr = torch.full((B, n * FRICTION_FACES), -inf, dtype=dtype, device=dev)
    swing_xyz = (~stance).repeat_interleave(3, dim=2).reshape(B, n * NU)
    is_fz = const(("full_qp_is_fz", n), dev, lambda d: torch.as_tensor(
        np.tile([False, False, True] * 4, n), device=d))
    stance_fz = (~swing_xyz) & is_fz
    l_box = torch.where(swing_xyz, 0.0, torch.where(stance_fz, float(fz_min), -inf)).to(dtype)
    u_box = torch.where(swing_xyz, 0.0, inf).to(dtype)

    return QpData(p_diag=p_diag, q=q_vec, A=A,
                  l=torch.cat([beq, l_fr, l_box], dim=-1),
                  u=torch.cat([beq, u_fr, u_box], dim=-1))


def split_solution(z: torch.Tensor, n: int):
    """z (..., nz) -> (X (..., N, 12), U (..., N, 12)); U[..., 0, :] is the
    force command applied to the plant."""
    x = z[..., : n * NX].reshape(*z.shape[:-1], n, NX)
    u = z[..., n * NX:].reshape(*z.shape[:-1], n, NU)
    return x, u
