"""The condensed MPC QP, written out densely through the prediction operators.

    X = Sx x0 + Su U + Sg,   P = 2 (Su' Qbar Su + r I),   q = 2 Su' Qbar (Sx x0 + Sg - Xref)

with the friction pyramid of each (step, leg) block and the box rows (swing
forces pinned to 0, stance normal force at least ``fz_min``). The system
assembles P by a suffix recursion over 12 x 12 blocks; this plain form
builds Su itself, so the two share no arithmetic.

Row order of l / u: the n * 16 friction rows, then the n * 12 box rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.srb import SrbDynamics

NX = 12
NU = 12
FACES = 16


class CondensedQp(NamedTuple):
    P: torch.Tensor  # (B, nz, nz)
    q: torch.Tensor  # (B, nz)
    C: torch.Tensor  # (B, n * 4, 4, 3) friction faces of each (step, leg) block
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)


def prediction_operators(dyn: SrbDynamics, n: int):
    """(Sx (B, n, 12, 12), Su (B, n*12, n*12), Sg (B, n, 12))."""
    Ad, Bd, gd = dyn.Ad, dyn.Bd, dyn.gd
    B = Ad.shape[0]
    Su = torch.zeros((B, n * NX, n * NU), dtype=Ad.dtype, device=Ad.device)
    Sx, Sg = [], []
    x_pow = torch.eye(NX, dtype=Ad.dtype, device=Ad.device).expand(B, NX, NX)
    g = torch.zeros_like(gd)
    for k in range(n):
        x_pow = Ad @ x_pow
        g = torch.einsum("bij,bj->bi", Ad, g) + gd
        Sx.append(x_pow)
        Sg.append(g)
        # row block k: Ad^(k-j) Bd_j for j <= k, built from row block k - 1
        if k > 0:
            Su[:, k * NX:(k + 1) * NX, :k * NU] = Ad @ Su[:, (k - 1) * NX:k * NX, :k * NU]
        Su[:, k * NX:(k + 1) * NX, k * NU:(k + 1) * NU] = Bd[:, k]
    return torch.stack(Sx, 1), Su, torch.stack(Sg, 1)


def friction_faces(mu: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) faces [fx - mu fz, -fx - mu fz, fy - mu fz, -fy - mu fz]."""
    one, zero = torch.ones_like(mu), torch.zeros_like(mu)
    return torch.stack([torch.stack([one, zero, -mu], -1), torch.stack([-one, zero, -mu], -1),
                        torch.stack([zero, one, -mu], -1), torch.stack([zero, -one, -mu], -1)],
                       -2)


def build(dyn: SrbDynamics, x0, x_ref, contact, q_diag, r_value: float, mu: float,
          fz_min: float) -> CondensedQp:
    """The QP of a batch: x0 (B, 12), x_ref (B, n, 12), contact (B, 4, n)."""
    B, n = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device
    Sx, Su, Sg = prediction_operators(dyn, n)
    qbar = torch.as_tensor(q_diag, dtype=dtype, device=dev).repeat(n)
    e = (torch.einsum("bkij,bj->bki", Sx, x0) + Sg - x_ref).reshape(B, n * NX)
    SuT = Su.transpose(1, 2)
    P = 2.0 * (SuT @ (qbar[:, None] * Su)
               + r_value * torch.eye(n * NU, dtype=dtype, device=dev))
    q = 2.0 * torch.einsum("bij,bj->bi", SuT, qbar * e)

    stance = contact.to(torch.bool).transpose(1, 2)  # (B, n, 4)
    C = friction_faces(torch.full((B, n * 4), float(mu), dtype=dtype, device=dev))
    inf = torch.full((B, n, 4, 4), math.inf, dtype=dtype, device=dev)
    u_fr = torch.where(stance[..., None], 0.0, inf).reshape(B, n * FACES)
    l_fr = torch.full_like(u_fr, -math.inf)
    swing3 = (~stance)[..., None].expand(B, n, 4, 3)
    is_fz = torch.tensor([False, False, True], device=dev).expand(B, n, 4, 3)
    l_box = torch.where(swing3, 0.0, torch.where(is_fz, float(fz_min), -math.inf))
    u_box = torch.where(swing3, 0.0, math.inf)
    l = torch.cat([l_fr, l_box.reshape(B, n * NU).to(dtype)], -1)
    u = torch.cat([u_fr, u_box.reshape(B, n * NU).to(dtype)], -1)
    return CondensedQp(P=P, q=q, C=C, l=l, u=u)


def constraint_matrix(qp: CondensedQp) -> torch.Tensor:
    """The dense A (B, m, nz): the friction blocks on their rows and columns,
    then the identity box rows."""
    B, nz = qp.q.shape
    nb = nz // 3
    A_fr = torch.zeros((B, nb, 4, nb, 3), dtype=qp.q.dtype, device=qp.q.device)
    idx = torch.arange(nb, device=qp.q.device)
    A_fr[:, idx, :, idx, :] = qp.C.transpose(0, 1)
    eye = torch.eye(nz, dtype=qp.q.dtype, device=qp.q.device).expand(B, nz, nz)
    return torch.cat([A_fr.reshape(B, nb * 4, nz), eye], 1)
