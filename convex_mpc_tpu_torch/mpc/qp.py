"""Centroidal MPC QP layout shared by the condensed form and the solver.

Port of the part of ``convex_mpc_tpu/mpc/qp.py`` that ``condensed`` and
``admm`` use: the dense ``QpData`` container, the friction-pyramid face
matrix and the full form's sizes. ``build_qp`` / ``split_solution`` are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NX = 12
NU = 12
FRICTION_FACES = 16  # 4 faces x 4 legs per step


class QpData(NamedTuple):
    """Dense QP: min 1/2 z'Pz + q'z  s.t.  l <= A z <= u."""

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
