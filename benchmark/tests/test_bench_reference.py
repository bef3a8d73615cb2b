"""The frozen reference against the system's plain CPU path: its start, its
QP, the QP's optimum against the system's forces, and the plant after the
ticks, at a few scenarios over a short stretch."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import condensed as RCo
from benchmark.reference import qp as RQ

from conftest import follow, small_cell


@pytest.mark.parametrize("name,fused", [("h16_sweep1k.fused", False), ("h16_sweep1k.fused", True),
                                        ("h32_trot1280.fused", True)])
def test_reference_follows_the_system(name, fused):
    """On the system's eager tick loop and on the plain version of its fused
    window."""
    follow(small_cell(name, batch=3 if name.startswith("h16") else 1, fused_ticks=fused))


def test_interior_point_meets_kkt():
    """The reference's QP solver on a random strictly convex QP with box,
    general and equality rows: feasible, and no better point along any
    feasible direction the active set leaves (checked against scipy)."""
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(3)
    n, m = 6, 5
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A = np.vstack([rng.normal(size=(m, n)), np.eye(n)[[0]]])  # last row: x0 = 0.3
    l = np.concatenate([-np.inf * np.ones(m - 1), [-0.5], [0.3]])
    u = np.concatenate([0.2 * np.ones(m - 1), [np.inf], [0.3]])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)[None]  # noqa: E731
    x = RQ.solve(t(P), t(q), t(A), t(l), t(u))[0].numpy()
    cons = [{"type": "ineq", "fun": lambda z, i=i: u[i] - A[i] @ z} for i in range(m - 1)]
    cons += [{"type": "ineq", "fun": lambda z: A[m - 1] @ z - l[m - 1]},
             {"type": "eq", "fun": lambda z: z[0] - 0.3}]
    ref = scipy_opt.minimize(lambda z: 0.5 * z @ P @ z + q @ z, np.zeros(n),
                             jac=lambda z: P @ z + q, constraints=cons, method="SLSQP",
                             options={"ftol": 1e-14, "maxiter": 500})
    assert ref.success
    assert np.abs(x - ref.x).max() < 1e-6
    assert x[0] == pytest.approx(0.3, abs=1e-12)


def test_constraint_matrix_places_the_blocks():
    B, n = 2, 2
    nb = 4 * n
    C = torch.arange(B * nb * 12, dtype=torch.float64).reshape(B, nb, 4, 3) + 1
    qp = RCo.CondensedQp(P=None, q=torch.zeros(B, 12 * n, dtype=torch.float64), C=C,
                         l=None, u=None)
    A = RCo.constraint_matrix(qp)
    assert A.shape == (B, 28 * n, 12 * n)
    for blk in range(nb):
        assert torch.equal(A[:, 4 * blk:4 * blk + 4, 3 * blk:3 * blk + 3], C[:, blk])
    assert torch.equal(A[:, 16 * n:], torch.eye(12 * n, dtype=torch.float64).expand(B, -1, -1))
    assert int((A[:, :16 * n] != 0).sum()) == B * nb * 12
