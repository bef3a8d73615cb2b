"""A plain interior-point solver for a batch of convex QPs

    minimize 1/2 x'Px + q'x   subject to   l <= A x <= u,

run to the optimum (Mehrotra's predictor-corrector on the inequalities, in
the dtype of its inputs). Equality rows (l == u) must be single-variable
rows, as the condensed MPC QP's box rows are: their variable is fixed and
taken out of the other rows. Infinite bounds are no rows.
"""

from __future__ import annotations

import torch


def _fix_equalities(P, q, A, l, u):
    """Fix the variables of the equality rows -> (P', q', A', l', u', eq):
    each fixed variable is decoupled with the cost 1/2 (x - c)^2, and its
    column is moved into the bounds."""
    eq = torch.isfinite(l) & torch.isfinite(u) & (l == u)
    nnz = (A != 0).sum(-1)
    if bool((eq & (nnz != 1)).any()):
        raise ValueError("qp.solve: an equality row couples several variables")
    # each equality row's variable and the value it fixes
    col = torch.argmax((A != 0).to(torch.int8), dim=-1)  # (S, m)
    coef = torch.gather(A, 2, col[..., None])[..., 0]
    S, nz = q.shape
    val = torch.where(eq, l / torch.where(eq, coef, 1.0), 0.0)
    c = torch.zeros((S, nz), dtype=q.dtype, device=q.device).scatter_add(1, col, val)
    fixed = torch.zeros((S, nz), dtype=torch.int32, device=q.device).scatter_add(
        1, col, eq.to(torch.int32)) > 0
    free = ~fixed
    q2 = torch.where(free, q + torch.einsum("bij,bj->bi", P, c), -c)
    keep = free[:, :, None] & free[:, None, :]
    eye = torch.eye(nz, dtype=q.dtype, device=q.device)
    P2 = torch.where(keep, P, 0.0) + torch.where(fixed[:, :, None], eye, 0.0)
    shift = torch.einsum("bmn,bn->bm", A, c)
    A2 = torch.where(fixed[:, None, :], 0.0, A)
    return P2, q2, A2, l - shift, u - shift, eq


def solve(P, q, A, l, u, tol: float = 1e-10, max_iter: int = 80) -> torch.Tensor:
    """The optimum x (S, nz) of each QP; P (S, nz, nz), A (S, m, nz)."""
    P2, q2, A2, lo, hi, eq = _fix_equalities(P, q, A, l, u)
    S, nz = q.shape
    # inequalities G x <= h: the rows with a finite upper bound, then the
    # negated rows with a finite lower bound; dead rows are 0 <= 1
    live = torch.cat([torch.isfinite(hi) & ~eq, torch.isfinite(lo) & ~eq], -1)
    G = torch.cat([A2, -A2], 1) * live[..., None]
    h = torch.where(live, torch.cat([hi, -lo], -1), 1.0)
    n_live = live.sum(-1).clamp(min=1)

    tiny = torch.finfo(q.dtype).tiny
    x = torch.zeros_like(q)
    s = torch.where(live, torch.clamp(h, min=1.0), 1.0)
    z = live.to(q.dtype)
    scale_d = 1.0 + torch.amax(torch.abs(q2), -1)
    scale_p = 1.0 + torch.amax(torch.where(live, torch.abs(h), 0.0), -1)

    def newton(W, r_d, r_p, r_c, L):
        rhs = -r_d - torch.einsum("bmn,bm->bn", G, W * r_p - r_c / s)
        dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        dz = W * (torch.einsum("bmn,bn->bm", G, dx) + r_p) - r_c / s
        dz = torch.where(live, dz, 0.0)
        ds = torch.where(live, (-r_c - s * dz) / z.clamp(min=tiny), 0.0)
        return dx, ds, dz

    def max_step(v, dv):
        ratio = torch.where(live & (dv < 0), -v / torch.where(dv < 0, dv, -1.0), float("inf"))
        return torch.clamp(torch.amin(ratio, -1), max=1.0)

    for _ in range(max_iter):
        r_d = torch.einsum("bij,bj->bi", P2, x) + q2 + torch.einsum("bmn,bm->bn", G, z)
        r_p = torch.where(live, torch.einsum("bmn,bn->bm", G, x) + s - h, 0.0)
        mu = torch.sum(torch.where(live, s * z, 0.0), -1) / n_live
        done = ((torch.amax(torch.abs(r_d), -1) <= tol * scale_d)
                & (torch.amax(torch.abs(r_p), -1) <= tol * scale_p) & (mu <= tol * scale_d))
        if bool(done.all()):
            break
        W = torch.where(live, z / s, 0.0)
        M = P2 + torch.einsum("bmi,bm,bmj->bij", G, W, G)
        L, info = torch.linalg.cholesky_ex(M)
        if bool((info != 0).any()):
            break
        # predictor
        r_c = torch.where(live, s * z, 0.0)
        dx, ds, dz = newton(W, r_d, r_p, r_c, L)
        a = torch.minimum(max_step(s, ds), max_step(z, dz))
        mu_a = torch.sum(torch.where(live, (s + a[:, None] * ds) * (z + a[:, None] * dz), 0.0),
                         -1) / n_live
        sigma = (mu_a / mu.clamp(min=tiny)) ** 3
        # corrector
        r_c = torch.where(live, s * z + ds * dz - (sigma * mu)[:, None], 0.0)
        dx, ds, dz = newton(W, r_d, r_p, r_c, L)
        a = 0.99 * torch.minimum(max_step(s, ds), max_step(z, dz))
        a = torch.where(done, 0.0, torch.clamp(a, max=1.0))[:, None]
        x = x + a * dx
        s = torch.where(live, s + a * ds, 1.0)
        z = torch.where(live, z + a * dz, 0.0)
    return x
