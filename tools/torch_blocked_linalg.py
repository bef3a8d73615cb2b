"""Bench-only blocked Cholesky / triangular inverse in plain PyTorch (the port's copy).

The port's counterpart of ``tools/blocked_linalg.py``: the same block
recurrences, every panel and trailing update a batched ``torch.matmul`` in
full f32 (the port pins TF32 off, ``convex_mpc_tpu_torch/_device.py``).
Kept for the ``tools/torch_kkt_microbench.py`` comparison grid only: the
engine forms the KKT inverse with ``spd_inverse`` (``csrc/spd_inverse.cu``).
"""

from __future__ import annotations

import torch


def blocked_cholesky(A: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Right-looking blocked Cholesky factorization (lower) of (..., n, n).

    The serial column loop runs only inside ``block``-sized diagonal
    blocks; every panel and trailing update is a batched matmul:

        L_kk       = chol(A_kk - sum_j L_kj L_kj')
        L_ik       = (A_ik - sum_j L_ij L_kj') L_kk^-T,   i > k

    Requires n to be a multiple of ``block``.
    """
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"n = {n} is not a multiple of block = {block}")
    nb = n // block
    eye = torch.eye(block, dtype=A.dtype, device=A.device)

    def blk(i, j):
        return A[..., i * block:(i + 1) * block, j * block:(j + 1) * block]

    L = [[None] * nb for _ in range(nb)]
    for k in range(nb):
        Akk = blk(k, k)
        for j in range(k):
            Akk = Akk - torch.matmul(L[k][j], L[k][j].transpose(-1, -2))
        Lkk = torch.linalg.cholesky(Akk)
        L[k][k] = Lkk
        if k + 1 < nb:
            Lkk_invT = torch.linalg.solve_triangular(Lkk, eye.expand_as(Lkk),
                                                     upper=False).transpose(-1, -2)
        for i in range(k + 1, nb):
            Aik = blk(i, k)
            for j in range(k):
                Aik = Aik - torch.matmul(L[i][j], L[k][j].transpose(-1, -2))
            L[i][k] = torch.matmul(Aik, Lkk_invT)

    zero = torch.zeros_like(L[0][0])
    return torch.cat([torch.cat([L[i][j] if j <= i else zero for j in range(nb)], dim=-1)
                      for i in range(nb)], dim=-2)


def blocked_tri_inverse(L: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Inverse of a lower-triangular (..., n, n) by block back-substitution.

    Only the diagonal blocks need triangular solves (with ``block``
    right-hand sides); every off-diagonal block is a matmul chain:

        X_ii = L_ii^-1
        X_ij = -X_ii (sum_k L_ik X_kj),   i > j

    Requires n to be a multiple of ``block``.
    """
    n = L.shape[-1]
    if n % block:
        raise ValueError(f"n = {n} is not a multiple of block = {block}")
    nb = n // block

    def blk(i, j):
        return L[..., i * block:(i + 1) * block, j * block:(j + 1) * block]

    eye = torch.eye(block, dtype=L.dtype, device=L.device)
    diag_inv = [torch.linalg.solve_triangular(blk(i, i), eye.expand_as(blk(i, i)), upper=False)
                for i in range(nb)]

    X = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        X[i][i] = diag_inv[i]
        for j in range(i - 1, -1, -1):
            acc = torch.matmul(blk(i, j), X[j][j])
            for k in range(j + 1, i):
                acc = acc + torch.matmul(blk(i, k), X[k][j])
            X[i][j] = -torch.matmul(diag_inv[i], acc)

    zero = torch.zeros_like(diag_inv[0])
    return torch.cat([torch.cat([X[i][j] if j <= i else zero for j in range(nb)], dim=-1)
                      for i in range(nb)], dim=-2)
