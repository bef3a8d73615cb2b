"""The pass order of ``csrc/admm_dense.cu``'s ring instance, on the CPU.

The CUDA kernel runs only on the card. Its ring instance reorders the dense
ADMM iterations: a prologue pass over each CTA's rows of A forms iteration
0's partial A' t; the pass of iteration ``it`` then runs step 5 (A xt, the
relaxation, projection and dual step, the row's new t) on each row and, on
the same row, its share of iteration ``it + 1``'s partial A' t; the last
iteration's pass forms none. Warp w of a CTA takes its rows w, w + 16, ...
and keeps its own partial; the 16 partials are summed in warp order, the
CTAs' in rank order. ``ring_order_iterations`` below is a plain version of
that order, held within 2e-4 of scale against JAX's ``admm_iterations``
(its Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it) and the port's ``admm_iterations_plain`` on numpy-seeded random
problems: A (40, 24), and A (160, 96) (the full form's ratio, as at horizon
4). The kernel's own agreement is held on the card by
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_kernels import make_problem  # noqa: E402
from torch_parity import assert_close_scaled, t  # noqa: E402

from convex_mpc_tpu.mpc import kernels as JK  # noqa: E402
from convex_mpc_tpu_torch.mpc import kernels as TK  # noqa: E402

WARPS = 16  # admm_dense.cu's kWarps: a CTA's rows go to its warps in turn


def ring_order_iterations(A, Minv, q, l, u, rho, x, z, y, iters: int, csize: int,
                          sigma: float = 1e-6, alpha: float = 1.6, fault: str | None = None):
    """The dense iterations in the ring instance's order, in clusters of
    ``csize`` CTAs: returns (x, z, y, passes over A). ``fault`` plants an
    error the order must not have: "no_prologue" (iteration 0's partial
    left at 0) or "stale_t" (a row's partial formed before its step 5)."""
    B, m, n = A.shape
    mr = -(-m // csize)
    ctas = [(a0, min(m, a0 + mr)) for a0 in range(0, m, mr)]
    pos = rho > 0
    rho_safe = torch.where(pos, rho, torch.ones_like(rho))
    z, y = z.clone(), y.clone()
    t_row = rho * z - y
    passes = 0

    def run_pass(xt, partial: bool):
        """One pass of every CTA over its rows; the CTAs' partials A_c' t
        (the warps' partials summed in warp order) if ``partial``."""
        nonlocal passes
        passes += 1
        parts = []
        for a0, a1 in ctas:
            acc = torch.zeros(WARPS, B, n)
            for r in range(a0, a1):
                w = (r - a0) % WARPS
                if partial and fault == "stale_t":
                    acc[w] += A[:, r, :] * t_row[:, r, None]
                if xt is not None:  # step 5 on the row
                    axt = (A[:, r, :] * xt).sum(-1)
                    axr = alpha * axt + (1.0 - alpha) * z[:, r]
                    y_over_rho = torch.where(pos[:, r], y[:, r] / rho_safe[:, r], 0.0)
                    zn = torch.clamp(axr + y_over_rho, l[:, r], u[:, r])
                    y[:, r] = y[:, r] + rho[:, r] * (axr - zn)
                    z[:, r] = zn
                    t_row[:, r] = rho[:, r] * zn - y[:, r]
                if partial and fault != "stale_t":  # the next iteration's share, same row
                    acc[w] += A[:, r, :] * t_row[:, r, None]
            part = acc[0].clone()
            for w in range(1, WARPS):
                part = part + acc[w]
            parts.append(part)
        return parts

    parts = run_pass(None, True) if iters > 0 else []  # the prologue: iteration 0's A' t
    if fault == "no_prologue":
        parts = [torch.zeros_like(p) for p in parts]
    for it in range(iters):
        s = parts[0]
        for p in parts[1:]:  # the owners' sum, in rank order
            s = s + p
        rhs = (sigma * x - q) + s
        xt = torch.einsum("bnk,bk->bn", Minv, rhs)
        x = alpha * xt + (1.0 - alpha) * x
        parts = run_pass(xt, it + 1 < iters)
    return x, z, y, passes


SHAPES = ((40, 24), (160, 96))


def _problem(m: int, n: int):
    return make_problem(b=2, m=m, n=n, seed=m + n)


@pytest.mark.parametrize("csize", [8, 16])
@pytest.mark.parametrize("iters", [1, 2, 7, 10])
@pytest.mark.parametrize("m, n", SHAPES)
def test_ring_order_matches_jax_and_plain(m, n, iters, csize):
    """k iterations in k + 1 passes, within 2e-4 of scale of JAX's kernel
    (interpret mode) and of the port's plain version."""
    args = _problem(m, n)
    ref_jax = JK.admm_iterations(*[jnp.asarray(a) for a in args], iters=iters, block_k=2)
    ref_plain = TK.admm_iterations_plain(*[t(a) for a in args], iters=iters)
    *out, passes = ring_order_iterations(*[t(a) for a in args], iters=iters, csize=csize)
    assert passes == iters + 1
    for name, a, rj, rp in zip("xzy", out, ref_jax, ref_plain):
        assert_close_scaled(a.numpy(), np.asarray(rj), 2e-4, name=f"{name} vs JAX")
        assert_close_scaled(a.numpy(), rp.numpy(), 2e-4, name=f"{name} vs plain")


@pytest.mark.parametrize("fault", ["no_prologue", "stale_t"])
def test_ring_order_sees_its_faults(fault):
    """The comparison above can fail: a missing prologue, or a row's
    partial formed from the t before its step 5, leaves the plain version's
    iterations by far more than the bar."""
    args = [t(a) for a in _problem(160, 96)]
    ref = TK.admm_iterations_plain(*args, iters=7)
    *out, _ = ring_order_iterations(*args, iters=7, csize=8, fault=fault)
    worst = max(float((a - r).abs().max() / (r.abs().max() + 1e-6)) for a, r in zip(out, ref))
    assert worst > 1e-2, worst
