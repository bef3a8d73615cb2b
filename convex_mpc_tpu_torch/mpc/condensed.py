"""Condensed centroidal MPC QP: states eliminated, forces only (batched).

Port of ``convex_mpc_tpu/mpc/condensed.py``. The cost

    P = 2 (Su' Qbar Su + Rbar),  q = 2 Su' Qbar (Sx x0 + Sg - Xref)

has two assemblies:

- the block form (:func:`build_condensed_structured`, the production
  cycle): suffix recursions over (B, 12, 12) blocks (the three ``scan``s of
  the JAX code become Python loops over the horizon), so Su is never
  materialized, and the constraint matrix stays in its analytic block form:
  the (nb, 4, 3) friction-pyramid blocks plus implicit identity box rows;
- the dense form (:func:`build_condensed`, the legacy fixed-segment
  solver): the prediction operators Sx, Su, Sg built from powers of Ad, and
  the dense constraint matrix A = [friction rows; identity box rows].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import const
from convex_mpc_tpu_torch.control.srb import SrbDynamics
from convex_mpc_tpu_torch.mpc.qp import QpData, _friction_face_matrix

NX = 12
NU = 12
FRICTION_FACES = 16


class CondensedAux(NamedTuple):
    """Recovery operators (batched): X = Sx x0 + Su U + Sg."""

    Sx: torch.Tensor  # (B, N, 12, 12) = Ad^(k+1)
    Su: torch.Tensor  # (B, N, N, 12, 12) block (k, j) = Ad^(k-j) Bd_j (j <= k)
    Sg: torch.Tensor  # (B, N, 12)


class StructuredQp(NamedTuple):
    """Condensed QP with the constraint matrix in block form (batched).

    Row order of l/u: [N*16 friction rows, N*12 box rows], as the dense
    condensed form of the JAX package.
    """

    p_diag: torch.Tensor  # (B, nz)
    q: torch.Tensor  # (B, nz)
    C: torch.Tensor  # (B, nb, 4, 3) friction block coefficients
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    p_dense: torch.Tensor  # (B, nz, nz)


def n_vars(n: int) -> int:
    return n * NU


def n_rows(n: int) -> int:
    return n * FRICTION_FACES + n * NU


def _prediction_operators(dyn: SrbDynamics, n: int) -> CondensedAux:
    """Sx, Su, Sg from (Ad (B, 12, 12), Bd (B, n, 12, 12), gd (B, 12))."""
    Ad, Bd, gd = dyn.Ad, dyn.Bd, dyn.gd
    B = Ad.shape[0]
    P = torch.eye(NX, dtype=Ad.dtype, device=Ad.device).expand(B, NX, NX)
    pows = [P]
    for _ in range(n):
        P = torch.matmul(Ad, P)
        pows.append(P)
    powers = torch.stack(pows, dim=1)  # (B, n + 1, 12, 12): Ad^k
    Sx = powers[:, 1:]
    idx = np.arange(n)[:, None] - np.arange(n)[None, :]  # k - j
    valid = torch.as_tensor(idx >= 0, device=Ad.device)
    P_kj = powers[:, np.where(idx >= 0, idx, 0)]  # (B, n, n, 12, 12) = Ad^(k-j)
    Su = torch.where(valid[:, :, None, None],
                     torch.einsum("zkjab,zjbc->zkjac", P_kj, Bd), 0.0)
    g_kj = torch.einsum("zkjab,zb->zkja", P_kj, gd)
    Sg = torch.sum(torch.where(valid[:, :, None], g_kj, 0.0), dim=2)
    return CondensedAux(Sx=Sx, Su=Su, Sg=Sg)


def _su_flat(aux: CondensedAux) -> torch.Tensor:
    """Su as the (B, n*12, n*12) map from U to X."""
    B, n = aux.Su.shape[0], aux.Su.shape[1]
    return aux.Su.permute(0, 1, 3, 2, 4).reshape(B, n * NX, n * NU)


def _friction_and_bounds(contact, mu, fz_min, n, dtype):
    """Friction blocks C (B, nb, 4, 3) and bounds l, u (B, m); contact (B, 4, n)."""
    B = contact.shape[0]
    dev = contact.device
    if isinstance(mu, torch.Tensor):
        mu_nl = torch.broadcast_to(mu.to(dtype), (n, 4)) if mu.ndim < 3 else mu
    else:
        mu_nl = torch.full((n, 4), float(mu), dtype=dtype, device=dev)
    C = _friction_face_matrix(mu_nl).reshape(-1, n * 4, 4, 3).expand(B, n * 4, 4, 3)

    stance = contact.to(torch.bool).transpose(1, 2)  # (B, n, 4)
    stance_faces = stance.repeat_interleave(4, dim=2).reshape(B, -1)
    u_fr = torch.where(stance_faces, 0.0, math.inf).to(dtype)
    l_fr = torch.full((B, n * FRICTION_FACES), -math.inf, dtype=dtype, device=dev)

    swing_xyz = (~stance).repeat_interleave(3, dim=2).reshape(B, -1)
    is_fz = const(("is_fz", n), dev,
                  lambda d: torch.as_tensor(np.tile([False, False, True] * 4, n), device=d))
    stance_fz = (~swing_xyz) & is_fz
    l_box = torch.where(
        swing_xyz, 0.0,
        torch.where(stance_fz, torch.full_like(u_fr[:, :1], float(fz_min)), -math.inf),
    ).to(dtype)
    u_box = torch.where(swing_xyz, 0.0, math.inf).to(dtype)
    return C, torch.cat([l_fr, l_box], dim=-1), torch.cat([u_fr, u_box], dim=-1)


def _cost_suffix_recursion(dyn: SrbDynamics, x0, x_ref, q_diag, r_value):
    """(P (B, nz, nz), q (B, nz)) by suffix recursions over 12x12 blocks.

        P[j, i] (j <= i) = 2 Bd_j' (Ad^(i-j))' W_{n-i} Bd_i,
            W_{m+1} = Q + Ad' W_m Ad,  W_1 = Q
        q[j] = 2 Bd_j' s_j,   s_j = Q e_j + Ad' s_{j+1}
        e_k  = f_k - x_ref_k, f_0 = Ad x0 + gd, f_{k+1} = Ad f_k + gd
    """
    B, n = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device
    Ad, Bd, gd = dyn.Ad, dyn.Bd, dyn.gd
    Q = torch.diag(torch.as_tensor(q_diag, dtype=dtype, device=dev))
    AdT = Ad.transpose(1, 2)

    f = x0
    e_list = []
    for k in range(n):
        f = torch.einsum("bij,bj->bi", Ad, f) + gd
        e_list.append(f - x_ref[:, k])
    e = torch.stack(e_list, dim=1)  # (B, n, 12)
    Qe = torch.einsum("ab,zkb->zka", Q, e)

    s = torch.zeros((B, NX), dtype=dtype, device=dev)
    q_rows = [None] * n
    for j in reversed(range(n)):
        s = Qe[:, j] + torch.einsum("bij,bj->bi", AdT, s)
        q_rows[j] = 2.0 * torch.einsum("bji,bj->bi", Bd[:, j], s)
    q = torch.stack(q_rows, dim=1).reshape(B, n * NU)

    W = Q.expand(B, NX, NX)
    T = [None] * n
    for i in reversed(range(n)):
        T[i] = torch.matmul(W, Bd[:, i])
        W = Q + torch.matmul(AdT, torch.matmul(W, Ad))

    V = torch.zeros((B, n, NX, NU), dtype=dtype, device=dev)
    rows = [None] * n
    for j in reversed(range(n)):
        V = torch.einsum("zab,ziac->zibc", Ad, V)  # Ad' @ each block
        V = V.clone()
        V[:, j] = V[:, j] + T[j]
        rows[j] = 2.0 * torch.einsum("zab,ziac->zbic", Bd[:, j], V)
    U = torch.stack(rows, dim=1).reshape(B, n * NU, n * NU)
    blk = torch.arange(n, device=dev).repeat_interleave(NU)
    on_diag_blk = blk[:, None] == blk[None, :]
    P = U + U.transpose(1, 2) - torch.where(on_diag_blk, U, 0.0)
    P = P + 2.0 * r_value * torch.eye(n * NU, dtype=dtype, device=dev)
    return P, q


def _cost_and_bounds(dyn: SrbDynamics, x0, x_ref, contact, q_diag, r_value, mu, fz_min):
    """Dense cost (P, q) through Su, friction blocks C, bounds (l, u), aux."""
    B, n = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device
    aux = _prediction_operators(dyn, n)
    qt = torch.as_tensor(q_diag, dtype=dtype, device=dev).repeat(n)  # per-step state weights
    # free response error: e = Sx x0 + Sg - Xref, (B, n, 12)
    e = torch.einsum("zkab,zb->zka", aux.Sx, x0) + aux.Sg - x_ref
    Su_flat = _su_flat(aux)
    SuT = Su_flat.transpose(1, 2)
    eye = torch.eye(n * NU, dtype=dtype, device=dev)
    P = 2.0 * (torch.matmul(SuT, qt[:, None] * Su_flat) + r_value * eye)
    q = 2.0 * torch.einsum("zij,zj->zi", SuT, qt * e.reshape(B, -1))
    C, l, u = _friction_and_bounds(contact, mu, fz_min, n, dtype)
    return P, q, C, l, u, aux


def build_condensed(dyn: SrbDynamics, x0, x_ref, contact, q_diag, r_value, mu, fz_min
                    ) -> tuple[QpData, CondensedAux]:
    """Assemble the batched condensed QP with a dense A (B, n*28, n*12):
    friction rows scattered from the (step, leg) blocks, then identity box
    rows, in the row order of :class:`StructuredQp`."""
    B, n = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device
    P, q, C, l, u, aux = _cost_and_bounds(dyn, x0, x_ref, contact, q_diag, r_value, mu, fz_min)
    nb = n * 4
    blk = np.arange(nb)[:, None, None]
    rows = np.broadcast_to(blk * 4 + np.arange(4)[None, :, None], (nb, 4, 3))
    cols = np.broadcast_to((blk // 4) * NU + (blk % 4) * 3 + np.arange(3)[None, None, :],
                           (nb, 4, 3))
    A_fr = torch.zeros((B, n * FRICTION_FACES, n * NU), dtype=dtype, device=dev)
    A_fr[:, torch.as_tensor(rows.copy(), device=dev), torch.as_tensor(cols.copy(), device=dev)] = C
    eye = torch.eye(n * NU, dtype=dtype, device=dev).expand(B, n * NU, n * NU)
    A = torch.cat([A_fr, eye], dim=1)
    data = QpData(p_diag=torch.diagonal(P, dim1=-2, dim2=-1), q=q, A=A, l=l, u=u, p_dense=P)
    return data, aux


def recover_states(aux: CondensedAux, x0, u_flat) -> torch.Tensor:
    """X (B, N, 12) from the optimal forces u_flat (B, N*12)."""
    B, n = aux.Sx.shape[0], aux.Sx.shape[1]
    su_u = torch.einsum("zij,zj->zi", _su_flat(aux), u_flat).reshape(B, n, NX)
    return torch.einsum("zkab,zb->zka", aux.Sx, x0) + aux.Sg + su_u


def build_condensed_structured(dyn: SrbDynamics, x0, x_ref, contact, q_diag, r_value,
                               mu, fz_min) -> tuple[StructuredQp, None]:
    """Assemble the batched condensed QP in block form (no dense A)."""
    n = x_ref.shape[1]
    dtype = x_ref.dtype
    P, q = _cost_suffix_recursion(dyn, x0, x_ref, q_diag, r_value)
    C, l, u = _friction_and_bounds(contact, mu, fz_min, n, dtype)
    data = StructuredQp(
        p_diag=torch.diagonal(P, dim1=-2, dim2=-1), q=q, C=C.contiguous(), l=l, u=u,
        p_dense=P,
    )
    return data, None
