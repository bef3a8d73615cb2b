"""Small-matrix linear algebra of the control stack, in full f32.

Port of ``convex_mpc_tpu/ops/linalg.py``. Its precision-pinned ``mm``/``ein``
helpers have no counterpart: the port pins f32 once for every contraction
(``convex_mpc_tpu_torch._device``) and calls ``torch.matmul``/``einsum``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def inv3(A):
    """Closed-form inverse of a (..., 3, 3) matrix (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    r0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    r1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    r2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    adj = torch.stack([r0, r1, r2], dim=-2)
    det = a * r0[..., 0] + b * r1[..., 0] + c * r2[..., 0]
    return adj / det[..., None, None]


def inv_small_unrolled(A):
    """Unrolled SPD inverse of a small (..., n, n) batch: unrolled Cholesky,
    unrolled triangular inverse, Gram.

    A non-positive pivot yields NaN (the non-SPD signal the polish
    certificate rejects explicitly), never a silent sqrt of a negative.
    """
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    for k in range(n):
        pivot = A[..., k, k]
        lkk = torch.where(pivot > 0, torch.sqrt(torch.clamp(pivot, min=0.0)), float("nan"))
        col = A[..., :, k] / lkk[..., None]
        col = torch.where(idx >= k, col, 0.0)
        L[..., :, k] = col
        A = A - col[..., :, None] * col[..., None, :]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    X = torch.zeros_like(L)
    for k in range(n):
        s = torch.einsum("...j,...jc->...c", L[..., k, :], X)
        row = (eye[k] - s) / L[..., k, k][..., None]
        X[..., k, :] = row
    return torch.einsum("...ki,...kj->...ij", X, X)


def inv6_spd_block(S):
    """Closed-form inverse of a (..., 6, 6) SPD matrix via 3x3-block Schur."""
    P, Q = S[..., :3, :3], S[..., :3, 3:]
    R = S[..., 3:, 3:]
    Pi = inv3(P)
    W = torch.einsum("...ij,...jk->...ik", Pi, Q)
    T = R - torch.einsum("...ji,...jk->...ik", Q, W)
    Ti = inv3(T)
    WTi = torch.einsum("...ij,...jk->...ik", W, Ti)
    top_left = Pi + torch.einsum("...ij,...kj->...ik", WTi, W)
    top = torch.cat([top_left, -WTi], dim=-1)
    bot = torch.cat([-WTi.transpose(-1, -2), Ti], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse_recursive(M):
    """SPD inverse of (..., n, n) by recursive 2x2 block-Schur elimination.

    Batched-matmul form: at every level the work is a handful of large
    batched matmuls plus concatenates, with no serialized per-column
    factorization.

        S = [[P, Q], [Q', R]]:  S^-1 from P^-1 and the Schur complement
        T = R - Q' P^-1 Q (recursively), leaves via the closed-form
        3x3 / 6x6 adjugate inverses.

    STABILITY LIMIT (do not use for ADMM KKT systems): unlike sqrt-pivot
    Cholesky, the explicit-inverse sandwich T = R - Q' P^-1 Q accumulates
    f32 formation error ~eps * |Q|^2 * |P^-1| at every level; on matrices
    mixing stiff and nearly-flat directions (the Ruiz-scaled condensed MPC
    KKT at attractor rho, the flat R = 1e-5 force directions) a deep Schur
    block is driven indefinite and the adjugate leaf explodes (the JAX
    package measured resid 7e10 where blocked Cholesky gives 1.4e-4, with
    cond(M) only ~6e3). Fine for uniformly conditioned SPD batches (robot
    mass matrices, covariances); the production KKT path stays on
    ``ops.chol_kernel.spd_inverse``. Any n: uneven splits are fine; small
    leaves other than 3 and 6 use the unrolled Cholesky.
    """
    n = M.shape[-1]
    if n == 3:
        return inv3(M)
    if n == 6:
        return inv6_spd_block(M)
    if n <= 8:
        return inv_small_unrolled(M)
    h = n // 2
    P, Q = M[..., :h, :h], M[..., :h, h:]
    R = M[..., h:, h:]
    Pi = spd_inverse_recursive(P)
    W = torch.matmul(Pi, Q)
    T = R - torch.matmul(Q.transpose(-1, -2), W)
    Ti = spd_inverse_recursive(T)
    WTi = torch.matmul(W, Ti)
    TL = Pi + torch.matmul(WTi, W.transpose(-1, -2))
    top = torch.cat([TL, -WTi], dim=-1)
    bot = torch.cat([-WTi.transpose(-1, -2), Ti], dim=-1)
    return torch.cat([top, bot], dim=-2)


class ArrowFactor(NamedTuple):
    """Factorization of an 18x18 SPD matrix with the Go2 'arrow' structure:
    dense 6x6 base block, 6x3 base-leg couplings, per-leg 3x3 diagonal
    blocks and exact zeros between legs."""

    S_inv: torch.Tensor  # (..., 6, 6) inverse of the base Schur complement
    Dinv: torch.Tensor  # (..., 4, 3, 3) per-leg joint-block inverses
    B: torch.Tensor  # (..., 4, 6, 3) base-leg coupling blocks
    BDinv: torch.Tensor  # (..., 4, 6, 3) B_l D_l^-1


def arrow_factor(A) -> ArrowFactor:
    """Factor a (..., 18, 18) SPD matrix with the Go2 arrow structure.

    The 6x6 Schur complement is inverted by ``inv6_spd_block``, as the JAX
    code does (its docstring names another function; the code is ported).
    """
    A_bb = A[..., :6, :6]
    B_flat = A[..., :6, 6:]
    batch = A.shape[:-2]
    B = torch.movedim(B_flat.reshape(*batch, 6, 4, 3), -2, -3)
    Dblk = torch.stack(
        [A[..., 6 + 3 * l : 9 + 3 * l, 6 + 3 * l : 9 + 3 * l] for l in range(4)],
        dim=-3,
    )
    Dinv = inv3(Dblk)
    BDinv = torch.einsum("...lij,...ljk->...lik", B, Dinv)
    S = A_bb - torch.einsum("...lik,...ljk->...ij", BDinv, B)
    return ArrowFactor(S_inv=inv6_spd_block(S), Dinv=Dinv, B=B, BDinv=BDinv)


def arrow_solve(fac: ArrowFactor, r):
    """Solve A x = r for (..., 18, k) right-hand sides."""
    batch = r.shape[:-2]
    k = r.shape[-1]
    r_b = r[..., :6, :]
    r_j = r[..., 6:, :].reshape(*batch, 4, 3, k)
    rhs_b = r_b - torch.einsum("...lij,...ljk->...ik", fac.BDinv, r_j)
    x_b = torch.einsum("...ij,...jk->...ik", fac.S_inv, rhs_b)
    Bt_xb = torch.einsum("...lji,...jk->...lik", fac.B, x_b)
    x_j = torch.einsum("...lij,...ljk->...lik", fac.Dinv, r_j - Bt_xb)
    return torch.cat([x_b, x_j.reshape(*batch, 12, k)], dim=-2)
