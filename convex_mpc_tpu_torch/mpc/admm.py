"""OSQP-style ADMM for the condensed MPC QP: the adaptive and the fixed-segment solver.

Port of ``convex_mpc_tpu/mpc/admm.py``:

- ``solve_adaptive`` (``StructuredQp`` input, or a dense ``QpData`` whose A
  has the condensed block structure, its blocks extracted once): Ruiz
  equilibration, the KKT inverse by ``spd_inverse``, 25-iteration chunks of
  the structured ADMM kernel, per-scenario residual / stall / small-force
  accepts, the bounded rho descent with rescue and gate steps,
  refactor-on-demand, and the certified active-set polish ladder, with the
  optional snap-first proposal that sends only the scenarios it cannot
  certify through a compacted ladder (``snap_first``) and the ``debug``
  prints. The JAX ``lax.while_loop`` / ``lax.cond`` predicates are
  batch-global, so here they are host reads: whether to polish and whether
  to refactor/continue are read once per chunk, the ladder's round
  condition once per round, and the snap failures' count once per polish;
- the legacy fixed-segment ``solve`` / ``solve_batch`` on a dense
  ``QpData``: Ruiz scaling, ``SEGMENTS`` equal iteration segments with a
  Cholesky refactorization and a per-scenario rho update between them, the
  iterations by the dense ADMM kernel (``kernels.admm_iterations``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import const
from convex_mpc_tpu_torch.mpc import kernels
from convex_mpc_tpu_torch.mpc.condensed import StructuredQp
from convex_mpc_tpu_torch.mpc.qp import QpData
from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse, spd_inverse_plain
from convex_mpc_tpu_torch.ops.linalg import inv_small_unrolled
from convex_mpc_tpu_torch.utils.interop import tree_map


class AdmmState(NamedTuple):
    """Carried solver state (warm start between MPC steps). Unscaled."""

    x: torch.Tensor  # (B, nz)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)
    rho: torch.Tensor  # (B,)


class AdmmSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    iters: torch.Tensor  # (B,) int32
    state: AdmmState


class ScaledStructuredQp(NamedTuple):
    p_diag: torch.Tensor  # (B, nz)
    p_dense: torch.Tensor  # (B, nz, nz)
    q: torch.Tensor  # (B, nz)
    C: torch.Tensor  # (B, nb, 4, 3)
    box_diag: torch.Tensor  # (B, nz)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    d: torch.Tensor  # (B, nz)
    e: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B,)


def _isfinite_or(x, scale):
    return torch.where(torch.isfinite(x), scale, 1.0)


def ruiz_equilibrate_structured(p_dense, q, C, box_diag, l, u, iters: int = 10
                                ) -> ScaledStructuredQp:
    """Ruiz + OSQP cost normalization on the block-form condensed QP
    (deferred scaling: the sweeps carry only d, e, c)."""
    B, nz = q.shape
    nb = C.shape[1]
    m_fr = 4 * nb
    dtype, dev = q.dtype, q.device
    P0a = torch.abs(p_dense)
    C0a = torch.abs(C)
    q0a = torch.abs(q)
    b0a = torch.abs(box_diag)

    d = torch.ones((B, nz), dtype=dtype, device=dev)
    e_fr = torch.ones((B, nb, 4), dtype=dtype, device=dev)
    e_box = torch.ones((B, nz), dtype=dtype, device=dev)
    c = torch.ones((B,), dtype=dtype, device=dev)

    def colP_at(d, c):
        return c[:, None] * d * torch.amax(d[:, :, None] * P0a, dim=-2)

    def inv_sqrt_clip(v):
        return torch.clamp(1.0 / torch.sqrt(torch.clamp(v, min=1e-12)), 1e-6, 1e6)

    for _ in range(iters):
        colC = d * torch.amax(e_fr[:, :, :, None] * C0a, dim=-2).reshape(B, nz)
        box_s = e_box * b0a * d
        col_norm = torch.maximum(torch.maximum(colC, box_s), colP_at(d, c))
        d = d * inv_sqrt_clip(col_norm)
        d_blk = d.reshape(B, nb, 1, 3)
        row_fr = torch.amax(e_fr[:, :, :, None] * C0a * d_blk, dim=-1)
        row_box = e_box * b0a * d
        e_fr = e_fr * inv_sqrt_clip(row_fr)
        e_box = e_box * inv_sqrt_clip(row_box)
        gamma = 1.0 / torch.clamp(
            torch.maximum(torch.mean(colP_at(d, c), dim=-1),
                          c * torch.amax(d * q0a, dim=-1)),
            min=1e-12,
        )
        c = c * torch.clamp(gamma, 1e-6, 1e6)

    p = (c[:, None, None] * d[:, :, None] * d[:, None, :]) * p_dense
    q_s = c[:, None] * d * q
    C_s = e_fr[:, :, :, None] * C * d.reshape(B, nb, 1, 3)
    box_s = e_box * box_diag * d
    e = torch.cat([e_fr.reshape(B, m_fr), e_box], dim=-1)
    return ScaledStructuredQp(
        p_diag=torch.diagonal(p, dim1=-2, dim2=-1), p_dense=p, q=q_s, C=C_s,
        box_diag=box_s, l=l * _isfinite_or(l, e), u=u * _isfinite_or(u, e),
        d=d, e=e, c=c,
    )


# ---------------------------------------------------------------------------
# Certified active-set polish
# ---------------------------------------------------------------------------
class PolishOps(NamedTuple):
    """Per-scenario operands of the polish (RAW, unscaled problem)."""

    p_dense: torch.Tensor  # (B, nz, nz)
    q: torch.Tensor  # (B, nz)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    is_eq: torch.Tensor  # (B, m)
    C: torch.Tensor  # (B, nb, 4, 3)
    box: torch.Tensor  # (B, nz)
    x_it: torch.Tensor  # (B, nz) raw-space iterate
    o_x: torch.Tensor  # (B,) iterate objective
    v_x: torch.Tensor  # (B,) iterate max constraint violation


def _bmv(M, v):
    return torch.einsum("bnm,bm->bn", M, v)


def _polish_ax(o: PolishOps, xc):
    B, nz = o.q.shape
    nb = nz // 3
    fr = torch.einsum("bnfr,bnr->bnf", o.C, xc.reshape(B, nb, 3)).reshape(B, 4 * nb)
    return torch.cat([fr, o.box * xc], dim=-1)


def _polish_viol(o: PolishOps, xc):
    ax = _polish_ax(o, xc)
    v = torch.maximum(o.l - ax, ax - o.u)
    return torch.amax(torch.clamp(v, min=0.0), dim=-1)


def _polish_obj(o: PolishOps, xc):
    return 0.5 * torch.sum(xc * _bmv(o.p_dense, xc), -1) + torch.sum(o.q * xc, -1)


def _polish_core(o: PolishOps, a_lo, a_hi, reduced: bool):
    """Project the iterate onto the active manifold; least-squares duals.

    Returns (x_pol, y_rows, stat_res). ``reduced=True`` solves the reduced
    equality-constrained subproblem exactly (nz x nz formation + SPD
    inverse); ``reduced=False`` keeps the iterate's null-space component.
    """
    B, nz = o.q.shape
    nb = nz // 3
    m_fr = 4 * nb
    dtype, dev = o.q.dtype, o.q.device
    face_rows = const(("face_rows", nb), dev,
                      lambda d: torch.arange(m_fr, device=d).reshape(nb, 4))
    blk_cols = const(("blk_cols", nb), dev, lambda d: torch.arange(nz, device=d).reshape(nb, 3))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye = torch.eye(nz, dtype=dtype, device=dev)

    act = a_lo | a_hi
    t_all = torch.where(a_lo, o.l, torch.where(a_hi, o.u, 0.0))
    m_face = act[:, :m_fr][:, face_rows]
    t_face = t_all[:, :m_fr][:, face_rows] * m_face
    m_pin = act[:, m_fr:][:, blk_cols]
    t_pin = t_all[:, m_fr:][:, blk_cols] * m_pin
    coef_pin = o.box[:, blk_cols]
    Cm = torch.cat(
        [o.C * m_face[..., None], eye3 * (coef_pin * m_pin)[..., :, None]], dim=2
    )  # (B, nb, 7, 3)
    b7 = torch.cat([t_face, t_pin], dim=2)  # (B, nb, 7)
    CC = torch.einsum("bnkr,bnlr->bnkl", Cm, Cm)
    trace = torch.diagonal(CC, dim1=-2, dim2=-1).sum(-1)
    ridge = 1e-7 * torch.clamp(trace[..., None, None], min=1e-2)
    CCi = inv_small_unrolled(CC + ridge * torch.eye(7, dtype=dtype, device=dev))

    def cc_solve(v):
        return torch.einsum("bnkl,bnl->bnk", CCi, v)

    x_p = torch.einsum("bnkr,bnk->bnr", Cm, cc_solve(b7)).reshape(B, nz)
    Pi_b = eye3 - torch.einsum("bnkr,bnkl,bnls->bnrs", Cm, CCi, Cm)
    if reduced:
        Pi = torch.zeros((B, nz, nz), dtype=dtype, device=dev)
        Pi[:, blk_cols[:, :, None], blk_cols[:, None, :]] = Pi_b
        PPi = torch.matmul(o.p_dense, Pi)
        H = torch.matmul(Pi, PPi) + (eye - Pi)
        rhs_r = -torch.einsum("bnm,bn->bm", Pi, o.q + _bmv(o.p_dense, x_p))
        djr = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-30))
        Hn = H / (djr[:, :, None] * djr[:, None, :]) + 1e-6 * eye
        if nz % 32 == 0:
            Hinv = spd_inverse(Hn)
        else:
            Hinv = spd_inverse_plain(Hn)
        zr = torch.einsum("bnm,bn->bm", Hinv, rhs_r / djr) / djr
        x_pol = x_p + torch.einsum("bmn,bn->bm", Pi, zr)
    else:
        x_pol = x_p + torch.einsum(
            "bnrs,bns->bnr", Pi_b, o.x_it.reshape(B, nb, 3)).reshape(B, nz)
    g_b = -(_bmv(o.p_dense, x_pol) + o.q).reshape(B, nb, 3)
    y7 = cc_solve(torch.einsum("bnkr,bnr->bnk", Cm, g_b))
    stat = torch.einsum("bnkr,bnk->bnr", Cm, y7) - g_b
    stat_res = torch.amax(torch.abs(stat), dim=(-2, -1))
    y_rows = torch.cat(
        [y7[..., :4].reshape(B, m_fr), y7[..., 4:].reshape(B, nz)], dim=-1
    ) * act
    return x_pol, y_rows, stat_res


def _polish_refine(o: PolishOps, a_lo, a_hi, x_r, y_r):
    """Add violated rows, drop wrong-sign-multiplier rows."""
    fin_l = torch.isfinite(o.l)
    fin_u = torch.isfinite(o.u)
    ax_r = _polish_ax(o, x_r)
    add_lo = fin_l & (o.l - ax_r > 1e-6)
    add_hi = fin_u & (ax_r - o.u > 1e-6)
    ysc = 1e-3 * torch.clamp(torch.amax(torch.abs(y_r), -1, keepdim=True), min=1.0)
    drop = (a_lo & ~o.is_eq & (y_r > ysc)) | (a_hi & (y_r < -ysc))
    n_lo = (a_lo | add_lo) & ~drop
    n_hi = ((a_hi | add_hi) & ~drop) & ~n_lo
    return n_lo, n_hi


def _polish_certify(o: PolishOps, a_lo, a_hi, x_c, y_c, stat_c, eps_abs):
    feas = (_polish_viol(o, x_c) <= o.v_x + eps_abs) & torch.isfinite(x_c).all(-1)
    ysc = 1e-3 * torch.clamp(torch.amax(torch.abs(y_c), -1, keepdim=True), min=1.0)
    sign_ok = torch.where(
        a_lo & ~o.is_eq, y_c <= ysc, torch.where(a_hi, y_c >= -ysc, True)
    ).all(-1)
    stat_ok = stat_c <= 0.05 * torch.clamp(torch.amax(torch.abs(o.q), -1), min=1.0)
    o_ok = _polish_obj(o, x_c) <= o.o_x + 1e-3 * torch.abs(o.o_x) + 1e-6
    return feas & sign_ok & stat_ok & o_ok


def _polish_ladder(o: PolishOps, act_lo, act_hi, polish_rounds: int, eps_abs):
    """Reduced-solve refinement ladder: round 1, then rounds while any
    scenario is uncertified (one host read per round). Returns
    (x_pol_raw, ok_pol)."""
    B = o.q.shape[0]
    big = torch.finfo(o.q.dtype).max
    a_lo, a_hi = act_lo, act_hi
    x_pol_raw = torch.zeros_like(o.x_it)
    best_obj = torch.full((B,), big, dtype=o.q.dtype, device=o.q.device)
    ok_pol = torch.zeros((B,), dtype=torch.bool, device=o.q.device)
    r = 0
    while True:
        x_k, y_k, st_k = _polish_core(o, a_lo, a_hi, reduced=True)
        ok_k = _polish_certify(o, a_lo, a_hi, x_k, y_k, st_k, eps_abs)
        o_k = torch.where(ok_k, _polish_obj(o, x_k), big)
        # a certified scenario keeps its point through later rounds
        take = (o_k < best_obj) & ~ok_pol
        x_pol_raw = torch.where(take[:, None], x_k, x_pol_raw)
        best_obj = torch.where(take, o_k, best_obj)
        ok_pol = ok_pol | ok_k
        a_lo, a_hi = _polish_refine(o, a_lo, a_hi, x_k, y_k)
        r += 1
        if r >= polish_rounds or bool(ok_pol.all()):
            break
    return x_pol_raw, ok_pol


# ---------------------------------------------------------------------------
# KKT system
# ---------------------------------------------------------------------------
class KktSetup(NamedTuple):
    """The Ruiz-scaled problem and the rho-independent parts of
    M(rho) = P + sigma I + rho (K + diag(K_box))."""

    s: ScaledStructuredQp
    is_eq: torch.Tensor  # (B, m) equality rows
    w_vec: torch.Tensor  # (B, m) per-row rho weights (eq_scale on equality rows)
    P_mat: torch.Tensor  # (B, nz, nz)
    K: torch.Tensor  # (B, nz, nz) block-diagonal friction Gram
    K_box_diag: torch.Tensor  # (B, nz)


def kkt_setup(p_dense, q, C, box_diag, l, u, sigma: float, eq_scale: float,
              scaling_iters: int) -> KktSetup:
    """The KKT pieces of the block-form QP (raw friction blocks ``C``, raw
    box diagonal ``box_diag``)."""
    B, nz = q.shape
    nb = nz // 3
    m_fr = 4 * nb
    dtype, dev = q.dtype, q.device
    s = ruiz_equilibrate_structured(p_dense, q, C, box_diag, l, u, iters=scaling_iters)
    is_eq = (u - l) < 1e-9
    w_vec = torch.where(is_eq, eq_scale, 1.0).to(dtype)
    w_fr, w_box = w_vec[:, :m_fr], w_vec[:, m_fr:]
    P_mat = s.p_dense + sigma * torch.eye(nz, dtype=dtype, device=dev)
    K_blocks = torch.einsum("bnfr,bnf,bnfs->bnrs", s.C, w_fr.reshape(B, nb, 4), s.C)
    eye_nb = torch.eye(nb, dtype=dtype, device=dev)
    K = (K_blocks[:, :, :, None, :] * eye_nb[None, :, None, :, None]).reshape(B, nz, nz)
    return KktSetup(s=s, is_eq=is_eq, w_vec=w_vec, P_mat=P_mat, K=K,
                    K_box_diag=w_box * s.box_diag * s.box_diag)


def kkt_matrix(setup: KktSetup, rho) -> torch.Tensor:
    """M(rho) (B, nz, nz), rho (B,)."""
    nz = setup.K.shape[-1]
    eye = torch.eye(nz, dtype=setup.K.dtype, device=setup.K.device)
    return (setup.P_mat + rho[:, None, None] * setup.K
            + (rho[:, None] * setup.K_box_diag)[:, :, None] * eye)


def kkt_at_rho(qp: StructuredQp, rho, sigma: float = 1e-6, eq_scale: float = 1e3,
               scaling_iters: int = 5) -> torch.Tensor:
    """The solver's Ruiz-scaled KKT matrix of ``qp`` at penalty ``rho`` (B,) —
    the matrix ``solve_adaptive`` hands to ``spd_inverse``."""
    box = torch.ones_like(qp.q)
    return kkt_matrix(kkt_setup(qp.p_dense, qp.q, qp.C, box, qp.l, qp.u, sigma, eq_scale,
                                scaling_iters), rho)


def _factorize(setup: KktSetup, rho) -> torch.Tensor:
    M = kkt_matrix(setup, rho)
    if M.shape[-1] % 32 == 0:
        return spd_inverse(M)
    return spd_inverse_plain(M)


# ---------------------------------------------------------------------------
# Batch-global adaptive solver
# ---------------------------------------------------------------------------
def solve_adaptive(
    qp: StructuredQp,
    state: AdmmState,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eq_scale: float = 1e3,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-4,
    max_iter: int = 600,
    check_every: int = 25,
    scaling_iters: int = 5,
    box_tail: int = 0,
    rho_refactor_ratio: float = 5.0,
    stall_tol: float = 0.02,
    stall_dual_cap: float = 2.5,
    rho_accept_max: float = 5e-4,
    debug: bool = False,
    polish: bool = True,
    polish_rounds: int = 3,
    nu: int = 12,
    small_force_scale: float = 50.0,
    return_polished: bool = True,
    snap_first: bool = False,
    polish_cap_div: int = 4,
) -> AdmmSolution:
    """Batched adaptive-iteration ADMM with refactor-on-demand (see module doc).

    Every leaf of ``qp``/``state`` carries a leading batch axis. ``qp`` is a
    ``StructuredQp`` or a dense ``QpData`` with a dense P whose A holds the
    condensed block structure: friction rows local to one (step, leg)
    3-column block, then a diagonal box tail. Off-block entries of such an A
    are dropped (``debug`` prints their largest magnitude). ``snap_first``:
    propose the snapped point for the whole batch first and run the reduced
    ladder only for the scenarios it does not certify, compacted into
    ``max(B // polish_cap_div, 8)`` rows when B >= 16 and they fit.
    Returns a per-scenario :class:`AdmmSolution`.
    """
    dtype, dev = qp.q.dtype, qp.q.device
    B, nz = qp.q.shape
    m = qp.l.shape[-1]
    m_fr = m - box_tail
    if box_tail <= 0:
        raise ValueError("solve_adaptive requires the condensed box_tail form")
    nb = nz // 3
    if m_fr != 4 * nb or nz % nu != 0:
        raise ValueError("condensed layout: 4 pyramid rows per block, nu | nz")
    first_step_vars = nu

    if isinstance(qp, StructuredQp):
        C_raw = qp.C
        box_diag_raw = torch.ones((B, nz), dtype=dtype, device=dev)
    else:
        if qp.p_dense is None:
            raise ValueError("solve_adaptive takes a dense-P QP (the condensed form)")
        face_rows = const(("face_rows", nb), dev,
                          lambda d: torch.arange(m_fr, device=d).reshape(nb, 4))
        blk_cols = const(("blk_cols", nb), dev,
                         lambda d: torch.arange(nz, device=d).reshape(nb, 3))
        C_raw = qp.A[:, face_rows[:, :, None], blk_cols[:, None, :]]
        box_diag_raw = torch.diagonal(qp.A[:, m_fr:, :], dim1=-2, dim2=-1)
        if debug:
            A_rec = torch.zeros_like(qp.A)
            A_rec[:, face_rows[:, :, None], blk_cols[:, None, :]] = C_raw
            A_rec[:, m_fr:, :] = torch.diag_embed(box_diag_raw)
            off_block = (qp.A - A_rec).abs().max().item()
            print(f"solve_adaptive dense-A off-block max |a| = {off_block} "
                  f"(must be 0: off-block entries are dropped)")
    setup = kkt_setup(qp.p_dense, qp.q, C_raw, box_diag_raw, qp.l, qp.u, sigma, eq_scale,
                      scaling_iters)
    s, is_eq, w_vec = setup.s, setup.is_eq, setup.w_vec

    x = state.x / s.d
    z = torch.clamp(state.z * s.e, s.l, s.u)
    y = s.c[:, None] * state.y / s.e
    rho = torch.clamp(state.rho, 1e-6, 1e6)
    if rho.ndim == 0:
        rho = rho.expand(B).clone()

    box_diag = s.box_diag

    def mv_A(v):
        fr = torch.einsum("bnfr,bnr->bnf", s.C, v.reshape(B, nb, 3)).reshape(B, m_fr)
        return torch.cat([fr, box_diag * v], dim=-1)

    def mv_AT(w):
        fr = torch.einsum("bnfr,bnf->bnr", s.C, w[:, :m_fr].reshape(B, nb, 4)).reshape(B, nz)
        return fr + box_diag * w[:, m_fr:]

    def residuals(x, z, y):
        ax = mv_A(x)
        aty = mv_AT(y)
        px = _bmv(s.p_dense, x)
        rp = torch.amax(torch.abs(ax - z), dim=-1)
        ep = eps_abs + eps_rel * torch.maximum(
            torch.amax(torch.abs(ax), dim=-1), torch.amax(torch.abs(z), dim=-1))
        rd = torch.amax(torch.abs(px + s.q + aty), dim=-1)
        ed = eps_abs + eps_rel * torch.maximum(
            torch.amax(torch.abs(px), dim=-1),
            torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                          torch.amax(torch.abs(s.q), dim=-1)))
        return rp / ep, rd / ed

    def chunk_iters(x, z, y, rho, Minv):
        rho_vec = rho[:, None] * w_vec
        return kernels.admm_iterations_structured(
            s.C, box_diag, Minv, s.q, s.l, s.u, rho_vec, x, z, y,
            iters=check_every, sigma=sigma, alpha=alpha)

    def attempt_polish(x, y, step):
        """Certified accept: the snap proposal (``snap_first``), then the
        reduced ladder for the scenarios it did not certify: none, a
        compacted sub-batch of ``cap`` rows, or the whole batch."""
        fin_l = torch.isfinite(qp.l)
        fin_u = torch.isfinite(qp.u)
        y_raw = s.e * y / s.c[:, None]
        y_tol = 1e-3 * torch.amax(torch.abs(y_raw), dim=-1, keepdim=True)
        act_lo = fin_l & (is_eq | (y_raw < -y_tol))
        act_hi = fin_u & (~act_lo) & (y_raw > y_tol)
        x_it_raw = s.d * x
        zeros_b = torch.zeros((B,), dtype=dtype, device=dev)
        ops = PolishOps(p_dense=qp.p_dense, q=qp.q, l=qp.l, u=qp.u, is_eq=is_eq,
                        C=C_raw, box=box_diag_raw, x_it=x_it_raw, o_x=zeros_b, v_x=zeros_b)
        ops = ops._replace(o_x=_polish_obj(ops, x_it_raw), v_x=_polish_viol(ops, x_it_raw))
        if snap_first:
            x_sn, y_sn, st_sn = _polish_core(ops, act_lo, act_hi, reduced=False)
            ok_sn = _polish_certify(ops, act_lo, act_hi, x_sn, y_sn, st_sn, eps_abs) & (
                step <= stall_tol)
            x_base = torch.where(ok_sn[:, None], x_sn, 0.0)
        else:
            ok_sn = torch.zeros((B,), dtype=torch.bool, device=dev)
            x_base = torch.zeros_like(x_it_raw)
        need = ~ok_sn
        cap = B if (B < 16 or not snap_first) else max(B // polish_cap_div, 8)
        count = B if not snap_first else int(need.sum())  # host read
        if count == 0:
            x_pol_raw, ok_pol = x_base, ok_sn
        elif count <= cap < B:
            # the snap failures alone, gathered into a sub-batch of their own
            idx = need.nonzero()[:, 0]
            o_sub = tree_map(lambda a: a[idx], ops)
            x_s, ok_s = _polish_ladder(o_sub, act_lo[idx], act_hi[idx], polish_rounds, eps_abs)
            x_pol_raw, ok_pol = x_base.clone(), ok_sn.clone()
            x_pol_raw[idx] = torch.where(ok_s[:, None], x_s, x_base[idx])
            ok_pol[idx] = ok_s
        else:
            x_f, ok_f = _polish_ladder(ops, act_lo, act_hi, polish_rounds, eps_abs)
            x_pol_raw = torch.where(ok_sn[:, None], x_base, x_f)
            ok_pol = ok_sn | ok_f
        if debug:
            print(f"polish: snap_ok {int(ok_sn.sum())}/{B} viol x={ops.v_x.cpu().numpy()} "
                  f"pol={_polish_viol(ops, x_pol_raw).cpu().numpy()} ok={ok_pol.cpu().numpy()}")
        return x_pol_raw / s.d, ok_pol

    Minv = _factorize(setup, rho)
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)
    conv_iter = torch.full((B,), -1, dtype=torch.int32, device=dev)
    n_chunks = max_iter // check_every
    adapt_stride = max(1, 100 // check_every)
    max_adapts = 3
    rescue_chunk = 10
    d_count = torch.zeros((B,), dtype=torch.int32, device=dev)
    x_pol_buf = torch.zeros_like(x)
    pol_ok = torch.zeros((B,), dtype=torch.bool, device=dev)
    log_ratio = float(np.log(rho_refactor_ratio))

    it = 0
    keep_going = n_chunks > 0
    while keep_going:
        x_prev = x
        x, z, y = chunk_iters(x, z, y, rho, Minv)
        pr, dr = residuals(x, z, y)
        rho_ok = rho <= rho_accept_max
        step = torch.amax(torch.abs(s.d * (x - x_prev)), dim=-1)
        stalled = rho_ok & (pr <= 1.0) & (dr <= stall_dual_cap) & (step <= stall_tol)
        if debug:
            f = lambda v: v.cpu().numpy()  # noqa: E731
            print(f"chunk {it} rho={f(rho)} pr={f(pr)} dr={f(dr)} step={f(step)}")
        newly = (rho_ok & (pr <= 1.0) & (dr <= 1.0)) | stalled
        iters_done = (it + 1) * check_every
        conv_iter = torch.where(newly & (conv_iter < 0), iters_done, conv_iter).to(torch.int32)
        converged = converged | newly
        if polish:
            at_cap = (it + 1) >= n_chunks
            want_pol = at_cap or bool(converged.all())  # host read, once per chunk
            if want_pol:
                x_pol_buf, pol_ok = attempt_polish(x, y, step)
            x_scale = torch.amax(torch.abs((s.d * x)[:, :first_step_vars]), dim=-1)
            step_ok = (step <= stall_tol) | (x_scale >= small_force_scale)
            if want_pol and not at_cap:
                converged = converged & pol_ok & step_ok
            conv_iter = torch.where(converged, conv_iter, -1).to(torch.int32)
        at_boundary = ((it + 1) % adapt_stride) == 0
        can = (~converged) & (d_count < max_adapts) if at_boundary else torch.zeros_like(converged)
        ratio = torch.sqrt(pr / torch.clamp(dr, min=1e-12))
        rho_desc = torch.clamp(rho * torch.clamp(ratio, 0.1, 1.0), 1e-6, 1e6)
        moved = torch.abs(torch.log(rho_desc / rho)) > log_ratio
        descend = can & moved
        d_count = d_count + descend.to(torch.int32)
        rho_new = torch.where(descend, rho_desc, rho)
        if (it + 1) == rescue_chunk:
            rescue = (~converged) & (rho <= rho_accept_max)
        else:
            rescue = torch.zeros_like(converged)
        rho_new = torch.where(rescue, 0.1, rho_new)
        d_count = torch.where(rescue, 0, d_count).to(torch.int32)
        gate_desc = (~converged) & (pr <= 1.0) & (dr <= 1.0) & (~rho_ok)
        rho_new = torch.where(gate_desc, torch.clamp(rho * 0.1, min=1e-4), rho_new)
        # one host read per chunk: refactor? and does any scenario go on?
        flags = torch.stack([(descend | rescue | gate_desc).any(), (~converged).any()])
        do_refactor, any_open = (bool(v) for v in flags.tolist())
        if do_refactor:
            Minv = _factorize(setup, rho_new)
        rho = rho_new
        it += 1
        keep_going = any_open and it < n_chunks

    if polish and return_polished:
        x = torch.where(pol_ok[:, None], x_pol_buf, x)

    x_out = s.d * x
    y_out = s.e * y / s.c[:, None]
    z_out = z / s.e
    ax = torch.cat([
        torch.einsum("bnfr,bnr->bnf", C_raw, x_out.reshape(B, nb, 3)).reshape(B, m_fr),
        box_diag_raw * x_out,
    ], dim=-1)
    viol_ret = torch.amax(torch.clamp(torch.maximum(qp.l - ax, ax - qp.u), min=0.0), dim=-1)
    use_pol_point = pol_ok if (polish and return_polished) else torch.zeros_like(pol_ok)
    rp = torch.where(use_pol_point, viol_ret, torch.amax(torch.abs(ax - z_out), dim=-1))
    px = _bmv(qp.p_dense, x_out)
    aty = (torch.einsum("bnfr,bnf->bnr", C_raw, y_out[:, :m_fr].reshape(B, nb, 4)).reshape(B, nz)
           + box_diag_raw * y_out[:, m_fr:])
    rd = torch.amax(torch.abs(px + qp.q + aty), dim=-1)
    iters = torch.where(conv_iter < 0, it * check_every, conv_iter).to(torch.int32)
    return AdmmSolution(
        x=x_out, y=y_out, prim_res=rp, dual_res=rd, iters=iters,
        state=AdmmState(x=x_out, z=z_out, y=y_out, rho=rho),
    )


# ---------------------------------------------------------------------------
# Legacy fixed-segment solver (dense QpData)
# ---------------------------------------------------------------------------
# the JAX solve's defaults that no caller of the port changes
SIGMA = 1e-6
ALPHA = 1.6
EQ_SCALE = 1e3  # rho weight of equality rows
EPS_EQ_ABS = 3e-4  # unscaled criterion: absolute primal tolerance on equality rows
EPS_DUAL_ABS = 4e-5  # unscaled criterion: absolute dual tolerance
CHECK_EVERY = 10
SEGMENTS = 4
SCALING_ITERS = 10

class ScaledQp(NamedTuple):
    """Ruiz-equilibrated dense QP (batched)."""

    p_diag: torch.Tensor  # (B, nz)
    q: torch.Tensor  # (B, nz)
    A: torch.Tensor  # (B, m, nz)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    d: torch.Tensor  # (B, nz) variable scaling:   x = d * x_hat
    e: torch.Tensor  # (B, m) constraint scaling:  z = z_hat / e,  y = e * y_hat / c
    c: torch.Tensor  # (B,) cost scaling
    p_dense: torch.Tensor | None = None


def init_state(qp: QpData, rho: float = 0.1) -> AdmmState:
    """Cold start of the shape of ``qp`` (batched or not)."""
    z = torch.zeros_like(qp.l)
    return AdmmState(x=torch.zeros_like(qp.q), z=z, y=torch.zeros_like(z),
                     rho=torch.full(qp.q.shape[:-1], rho, dtype=qp.q.dtype, device=qp.q.device))


def _px(p_diag, p_dense, x):
    """P @ x for diagonal or dense P (batched)."""
    return p_diag * x if p_dense is None else _bmv(p_dense, x)


def _amax(x):
    return torch.amax(torch.abs(x), dim=-1)


def ruiz_equilibrate(qp: QpData, iters: int = 10) -> ScaledQp:
    """Modified Ruiz equilibration of [P A'; A 0] + OSQP cost normalization,
    per scenario: P_s = c D P D, q_s = c D q, A_s = E A D, l_s = E l, u_s = E u."""
    dense = qp.p_dense is not None
    p = qp.p_dense if dense else qp.p_diag
    A, q = qp.A, qp.q
    B, nz = q.shape
    dtype, dev = q.dtype, q.device
    d = torch.ones((B, nz), dtype=dtype, device=dev)
    e = torch.ones_like(qp.l)
    c = torch.ones((B,), dtype=dtype, device=dev)

    def col_norms_P(p):
        return torch.amax(torch.abs(p), dim=-2) if dense else torch.abs(p)

    def inv_sqrt_clip(v):
        return torch.clamp(1.0 / torch.sqrt(torch.clamp(v, min=1e-12)), 1e-6, 1e6)

    for _ in range(iters):
        dd = inv_sqrt_clip(torch.maximum(torch.amax(torch.abs(A), dim=-2), col_norms_P(p)))
        ee = inv_sqrt_clip(torch.amax(torch.abs(A * dd[:, None, :]), dim=-1))
        A = ee[:, :, None] * (A * dd[:, None, :])
        p = (dd[:, :, None] * p * dd[:, None, :]) if dense else (dd * dd * p)
        q = dd * q
        gamma = 1.0 / torch.clamp(
            torch.maximum(torch.mean(col_norms_P(p), dim=-1), _amax(q)), min=1e-12)
        gamma = torch.clamp(gamma, 1e-6, 1e6)
        p = gamma[:, None, None] * p if dense else gamma[:, None] * p
        q = gamma[:, None] * q
        d, e, c = d * dd, e * ee, c * gamma
    l_s, u_s = qp.l * _isfinite_or(qp.l, e), qp.u * _isfinite_or(qp.u, e)
    if dense:
        return ScaledQp(p_diag=torch.diagonal(p, dim1=-2, dim2=-1), q=q, A=A, l=l_s, u=u_s,
                        d=d, e=e, c=c, p_dense=p)
    return ScaledQp(p_diag=p, q=q, A=A, l=l_s, u=u_s, d=d, e=e, c=c)


def _unscale(s: ScaledQp, x_hat, z_hat, y_hat):
    return s.d * x_hat, z_hat / s.e, s.e * y_hat / s.c[:, None]


def _raw_residuals(qp: QpData, s: ScaledQp, x_hat, z_hat, y_hat):
    """Unscaled max-abs primal/dual residuals (for reporting)."""
    x, z, y = _unscale(s, x_hat, z_hat, y_hat)
    rp = _amax(_bmv(qp.A, x) - z)
    rd = _amax(_px(qp.p_diag, qp.p_dense, x) + qp.q + torch.einsum("bmn,bm->bn", qp.A, y))
    return rp, rd


def _residuals(qp, s, is_eq, x_hat, z_hat, y_hat, eps_abs, eps_rel, scaled: bool):
    """The OSQP scaled-space criterion (``scaled``, the condensed form) or the
    unscaled row-type-aware one; residuals over tolerances, <= 1 means met."""
    if not scaled:
        return _unscaled_residuals(qp, s, is_eq, x_hat, z_hat, y_hat, eps_abs, eps_rel)
    ax = _bmv(s.A, x_hat)
    aty = torch.einsum("bmn,bm->bn", s.A, y_hat)
    px = _px(s.p_diag, s.p_dense, x_hat)
    ep = eps_abs + eps_rel * torch.maximum(_amax(ax), _amax(z_hat))
    ed = eps_abs + eps_rel * torch.maximum(_amax(px), torch.maximum(_amax(aty), _amax(s.q)))
    return _amax(ax - z_hat) / ep, _amax(px + s.q + aty) / ed


def _unscaled_residuals(qp, s, is_eq, x_hat, z_hat, y_hat, eps_abs, eps_rel):
    """Row-type-aware criterion on the unscaled problem: an absolute primal
    tolerance on equality rows, OSQP's on inequality rows, an absolute dual
    tolerance."""
    x, z, y = _unscale(s, x_hat, z_hat, y_hat)
    ax = _bmv(qp.A, x)
    aty = torch.einsum("bmn,bm->bn", qp.A, y)
    px = _px(qp.p_diag, qp.p_dense, x)
    r = torch.abs(ax - z)
    rp_eq = torch.amax(torch.where(is_eq, r, 0.0), dim=-1)
    rp_in = torch.amax(torch.where(is_eq, 0.0, r), dim=-1)
    ep_in = eps_abs + eps_rel * torch.maximum(_amax(ax), _amax(z))
    rd = _amax(px + qp.q + aty)
    return torch.maximum(rp_eq / EPS_EQ_ABS, rp_in / ep_in), rd / EPS_DUAL_ABS


def _segment_inverse(M):
    """Cholesky inverse of each SPD matrix, NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Minv = torch.matmul(Linv.transpose(-1, -2), Linv)
    return torch.where((info != 0)[:, None, None], float("nan"), Minv)


def _solve_impl(
    qp: QpData,
    state: AdmmState,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-4,
    max_iter: int = 200,
    adaptive_rho: bool = True,
    scaled_termination: bool = False,
    box_tail: int = 0,
) -> AdmmSolution:
    """The fixed-segment solve of a batch (every leaf of ``qp``/``state``
    has a leading batch axis).

    ``max_iter`` is split into ``SEGMENTS`` equal segments; each scenario's
    rho adapts (``adaptive_rho``), and its KKT matrix is refactorized,
    between segments. The iterations run in kernel launches that end at every
    ``CHECK_EVERY``-th global iteration and at segment ends; at a check point
    the termination criterion is evaluated (``scaled_termination``: OSQP's in
    the scaled space, else the unscaled row-type-aware one), and ``iters``
    reports the first check point at which it held (``max_iter`` if none).
    ``box_tail`` declares that the last ``box_tail`` rows of A are an
    identity block (the condensed QP's box rows): the KKT matrix then takes
    their Gram as a diagonal. The other settings are the JAX ``solve``
    defaults, kept as module constants.
    """
    B, nz = qp.q.shape
    m = qp.l.shape[-1]
    dtype, dev = qp.q.dtype, qp.q.device
    s = ruiz_equilibrate(qp, SCALING_ITERS)
    is_eq = (qp.u - qp.l) < 1e-9

    # the warm start in the scaled space
    x = state.x / s.d
    z = torch.clamp(state.z * s.e, s.l, s.u)
    y = s.c[:, None] * state.y / s.e
    rho = torch.clamp(state.rho, 1e-6, 1e6).expand(B)

    eye = torch.eye(nz, dtype=dtype, device=dev)
    w_vec = torch.where(is_eq, EQ_SCALE, 1.0).to(dtype)
    if s.p_dense is None:
        P_mat = torch.diag_embed(s.p_diag + SIGMA)
    else:
        P_mat = s.p_dense + SIGMA * eye
    # M(rho) = P + sigma I + rho K: K = A' diag(w) A is hoisted out of the segments
    if box_tail:
        m_fr = m - box_tail
        A_fr = s.A[:, :m_fr]
        box_diag = torch.diagonal(s.A[:, m_fr:], dim1=-2, dim2=-1)
        K = torch.matmul(A_fr.transpose(1, 2), A_fr * w_vec[:, :m_fr, None])
        K_box = w_vec[:, m_fr:] * box_diag * box_diag
    else:
        K = torch.matmul(s.A.transpose(1, 2), s.A * w_vec[:, :, None])
        K_box = None

    def residuals(x, z, y):
        return _residuals(qp, s, is_eq, x, z, y, eps_abs, eps_rel, scaled_termination)

    conv_iter = torch.full((B,), -1, dtype=torch.int32, device=dev)
    per_seg = max_iter // SEGMENTS
    for seg in range(SEGMENTS):
        M = P_mat + rho[:, None, None] * K
        if K_box is not None:
            M = M + torch.diag_embed(rho[:, None] * K_box)
        Minv = _segment_inverse(M)
        rho_vec = rho[:, None] * w_vec
        done = 0
        while done < per_seg:
            it0 = seg * per_seg + done
            k = min(CHECK_EVERY - it0 % CHECK_EVERY, per_seg - done)
            x, z, y = kernels.admm_iterations(s.A, Minv, s.q, s.l, s.u, rho_vec, x, z, y,
                                              iters=k, sigma=SIGMA, alpha=ALPHA)
            done += k
            if (it0 + k) % CHECK_EVERY == 0:
                pr, dr = residuals(x, z, y)
                newly = (pr <= 1.0) & (dr <= 1.0) & (conv_iter < 0)
                conv_iter = torch.where(newly, it0 + k, conv_iter).to(torch.int32)
        if adaptive_rho:
            pr, dr = residuals(x, z, y)
            ratio = torch.sqrt(pr / torch.clamp(dr, min=1e-12))
            rho = torch.clamp(rho * torch.clamp(ratio, 0.1, 10.0), 1e-6, 1e6)

    rp, rd = _raw_residuals(qp, s, x, z, y)
    x_out, z_out, y_out = _unscale(s, x, z, y)
    iters = torch.where(conv_iter < 0, max_iter, conv_iter).to(torch.int32)
    return AdmmSolution(x=x_out, y=y_out, prim_res=rp, dual_res=rd, iters=iters,
                        state=AdmmState(x=x_out, z=z_out, y=y_out, rho=rho))


def solve_batch(qp: QpData, state: AdmmState, **kwargs) -> AdmmSolution:
    """Batched solve: every leaf of qp/state has a leading batch axis
    (keyword arguments as :func:`_solve_impl`)."""
    return _solve_impl(qp, state, **kwargs)


def solve(qp: QpData, state: AdmmState, **kwargs) -> AdmmSolution:
    """The fixed-segment solve of ONE QP: a B = 1 wrapper over :func:`_solve_impl`."""
    b1 = lambda x: None if x is None else x[None]  # noqa: E731
    sol = _solve_impl(QpData(*(b1(v) for v in qp)), AdmmState(*(b1(v) for v in state)),
                      **kwargs)
    sq = lambda x: x[0]  # noqa: E731
    return AdmmSolution(*(sq(v) for v in sol[:5]), state=AdmmState(*(sq(v) for v in sol.state)))
