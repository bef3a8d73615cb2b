"""The adaptive solve's per-chunk step: ``mpc/kernels.py::adapt_check`` and
``adapt_rho`` (plain versions, on the CPU). ``adapt_check`` is held to the
eager arithmetic ``admm.solve_adaptive`` ran before the step became two
kernels, kept as the oracle in ``chip_smoke.py`` (``adapt_check_eager``);
``adapt_rho_plain`` is that eager rho step as it stood, so it is held to
the step's rules worked row by row in float64 (``rho_step_f64``).

Bars:

- ``px_tree`` (P x in the adapt kernel's pinned order) within the f32
  summation bound of the float64 product, 4 nz 2^-24 sum|P x| a row, at nz
  = 12, 120, 144 and 384 (one, two and four 128-column chunks);
- ``adapt_check_plain``: pr, dr and step within a relative 1e-6 of the
  oracle's (its residuals sum A x, A' y and P x in another order), and
  every flag equal wherever the operands it is decided from (pr and dr
  against 1 and the stall cap, step against the stall tolerance) lie more
  than 1e-5 (relative) from their thresholds; the tolerances are set so
  that pr and dr straddle 1 without cancelling;
- ``adapt_rho_plain``: every decision (polish acceptance, descent, rescue,
  gate) that of the float64 rules wherever its operands lie more than 1e-5
  (relative) from their thresholds, NaN operands deciding as comparisons
  with NaN do (false); the new rho within a relative 1e-6 of the rules',
  and bit for bit the old rho where it did not move; the two counts exact.
  At the rescue chunk, at an adapt boundary, in the mid-loop polish branch
  and without polish, with a NaN row, and on the state of a chunk of a
  problem with infinite l (whose residuals cancel: pr and dr within a
  relative 1e-5 of the oracle's there).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    ADAPT_RHO_CASES, ADAPT_SETTINGS, adapt_check_eager, adapt_problem, adapt_rho_kwargs,
    adapt_rho_problem, structured_problem)

from convex_mpc_tpu_torch.mpc import kernels as K  # noqa: E402


@pytest.mark.parametrize("nz", [12, 120, 144, 384])
def test_px_tree_within_the_summation_bound(nz):
    rng = np.random.default_rng(nz)
    P = rng.standard_normal((2, nz, nz)).astype(np.float32)
    x = rng.standard_normal((2, nz)).astype(np.float32)
    out = K.px_tree(torch.as_tensor(P), torch.as_tensor(x)).double().numpy()
    exact = np.einsum("bnm,bm->bn", P.astype(np.float64), x.astype(np.float64))
    scale = np.einsum("bnm,bm->bn", np.abs(P).astype(np.float64), np.abs(x).astype(np.float64))
    assert (np.abs(out - exact) <= 4 * nz * 2.0 ** -24 * scale).all()


def _far(v, threshold, rel=1e-5):
    return (v - threshold).abs() > rel * abs(threshold)


@pytest.mark.parametrize("B, nb, seed, eps", [(8, 8, 0, (2.0, 0.8)), (5, 3, 1, (3.0, 0.8)),
                                               (1, 1, 2, (1.0, 1.5)), (8, 6, 3, (3.0, 0.6))])
def test_adapt_check_plain_against_eager(B, nb, seed, eps):
    p = adapt_problem(B, nb, seed, "cpu")
    kw = dict(iters_done=75, eps_abs=eps[0], eps_rel=eps[1], **ADAPT_SETTINGS)
    pr, dr, step, conv, it, n_open = K.adapt_check(*p.values(), **kw)
    e_pr, e_dr, e_step, e_conv, e_it = adapt_check_eager(*p.values(), **kw)
    for a, b in ((pr, e_pr), (dr, e_dr), (step, e_step)):
        assert ((a - b).abs() <= 1e-6 * b.abs()).all(), ((a - b).abs() / b.abs()).max().item()
    sure = (_far(e_pr, 1.0) & _far(e_dr, 1.0) & _far(e_dr, ADAPT_SETTINGS["stall_dual_cap"])
            & _far(e_step, ADAPT_SETTINGS["stall_tol"]))
    assert torch.equal(conv[sure], e_conv[sure]) and torch.equal(it[sure], e_it[sure])
    assert n_open.dtype == torch.int32 and int(n_open) == int((~conv).sum())
    assert it.dtype == torch.int32 and conv.dtype == torch.bool


def rho_step_f64(pr, dr, step, rho, converged, conv_iter, d_count, pol_ok, x, d, nu, polish,
                 apply_polish, at_boundary, rescue, max_adapts, stall_tol, small_force_scale,
                 log_ratio, rho_accept_max):
    """The rho step's rules in float64 numpy: (rho_new, d_count, changed,
    converged, conv_iter) and the rows whose every decision lies clear of
    its threshold (or is taken on NaN, which compares false)."""
    f = lambda t: t.double().numpy()  # noqa: E731
    pr, dr, step, rho, x, d = map(f, (pr, dr, step, rho, x, d))
    conv, it, dc = converged.numpy(), conv_iter.numpy().astype(np.int64), d_count.numpy()
    none = np.zeros_like(conv)
    clear = lambda v, t: np.isnan(v) | (np.abs(v - t) > 1e-5 * abs(t))  # noqa: E731
    sure = clear(rho, rho_accept_max) & clear(pr, 1.0) & clear(dr, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        if polish:
            x_scale = np.abs(d[:, :nu] * x[:, :nu]).max(axis=1)
            sure &= clear(step, stall_tol) & clear(x_scale, small_force_scale)
            if apply_polish:
                step_ok = (step <= stall_tol) | (x_scale >= small_force_scale)
                conv = conv & pol_ok.numpy() & step_ok
            it = np.where(conv, it, -1)
        rho_desc = np.clip(rho * np.clip(np.sqrt(pr / np.maximum(dr, 1e-12)), 0.1, 1.0), 1e-6, 1e6)
        moved = np.abs(np.log(rho_desc / rho))
        if at_boundary:
            sure &= clear(moved, log_ratio)
        descend = (~conv) & (dc < max_adapts) & (moved > log_ratio) if at_boundary else none
        rescued = (~conv) & (rho <= rho_accept_max) if rescue else none
        gate = (~conv) & (pr <= 1.0) & (dr <= 1.0) & (rho > rho_accept_max)
    rho_new = np.where(gate, np.maximum(rho * 0.1, 1e-4),
                       np.where(rescued, 0.1, np.where(descend, rho_desc, rho)))
    dc = np.where(rescued, 0, dc + descend)
    return (rho_new, dc, descend | rescued | gate, conv, it), sure


def _check_rules(out, args, kw):
    """adapt_rho's outputs against ``rho_step_f64`` on the rows it is sure
    of (at least 90% of them), and its two counts against its own flags."""
    (rho, dc, changed, conv, it), sure = rho_step_f64(*args, **kw)
    assert sure.mean() >= 0.9
    o_rho, o_dc, o_changed, o_conv, o_it, flags = out
    assert o_rho.dtype == torch.float32
    assert o_dc.dtype == o_it.dtype == flags.dtype == torch.int32
    for a, b in ((o_dc, dc), (o_changed, changed), (o_conv, conv), (o_it, it)):
        assert (a.numpy()[sure] == b[sure]).all()
    assert (np.abs(o_rho.double().numpy() - rho) <= 1e-6 * rho)[sure].all()
    kept = ~o_changed
    assert torch.equal(o_rho[kept], args[3][kept])  # a rho that did not move, bit for bit
    assert flags.tolist() == [int(o_changed.sum()), int((~o_conv).sum())]


@pytest.mark.parametrize("case", list(ADAPT_RHO_CASES))
@pytest.mark.parametrize("nan_row", [None, 5])
def test_adapt_rho_plain_follows_the_rules(case, nan_row):
    v = adapt_rho_problem(64, 7, "cpu", nan_row)
    kw = adapt_rho_kwargs(case)
    out = K.adapt_rho(*v.values(), **kw)
    _check_rules(out, list(v.values()), kw)
    if nan_row is not None:  # NaN decides nothing: the row neither descends nor gates
        assert not bool(out[2][nan_row]) or (kw["rescue"] and float(v["rho"][nan_row]) <= 5e-4)


@pytest.mark.parametrize("case", ["adapt boundary", "rescue chunk", "mid-loop polish"])
def test_adapt_step_after_a_chunk_with_infinite_l(case):
    """A 25-iteration chunk of the plain structured kernel on a problem
    whose friction rows have l = -inf, then both steps."""
    B, nb = 8, 8
    C, box, Minv, q, l, u, rho_vec, x0, z0, y0 = structured_problem(B, nb, seed=5, dev="cpu")
    assert torch.isinf(l).any()
    x, z, y = K.admm_iterations_structured_plain(C, box, Minv, q, l, u, rho_vec, x0, z0, y0,
                                                 iters=25)
    rng = np.random.default_rng(3)
    P = torch.as_tensor(np.eye(3 * nb) + 0.01 * rng.standard_normal((B, 3 * nb, 3 * nb)),
                        dtype=torch.float32)
    d = torch.ones_like(x)
    rho = torch.as_tensor(10.0 ** rng.uniform(-5, -1, B), dtype=torch.float32)
    conv0 = torch.zeros(B, dtype=torch.bool)
    it0 = torch.full((B,), -1, dtype=torch.int32)
    kw = dict(iters_done=25, eps_abs=1e-4, eps_rel=1e-4, **ADAPT_SETTINGS)
    pr, dr, step, conv, it, _ = K.adapt_check(P, C, box, q, d, x, x0, z, y, rho, conv0, it0,
                                              **kw)
    e = adapt_check_eager(P, C, box, q, d, x, x0, z, y, rho, conv0, it0, **kw)
    # this iterate's z meets A x to about 2 digits, so the sums' order shows
    # 10-50 times larger in pr than in the terms: 1e-5 here
    for a, b in zip((pr, dr, step), e):
        assert torch.isfinite(a).all() and ((a - b).abs() <= 1e-5 * b.abs()).all()
    args = (pr, dr, step, rho, conv, it, torch.zeros(B, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool), x, d)
    kw = adapt_rho_kwargs(case)
    _check_rules(K.adapt_rho(*args, **kw), args, kw)
