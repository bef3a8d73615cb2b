"""Kernel 1 at any order (``ops/chol_kernel.py::spd_inverse``): the counts of
the work on its padded panel grid, kept on the CPU route too, and horizon
10's solve (nz = 120, off the old 32-grid) going through ``spd_inverse`` in
both the KKT factorization and the polish's reduced solve. CPU, small B."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import spd_batch, start_batch  # noqa: E402

from convex_mpc_tpu_torch.mpc import admm  # noqa: E402
from convex_mpc_tpu_torch.ops import chol_kernel as TCK  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.utils import config as C  # noqa: E402
from convex_mpc_tpu_torch.utils import profiling as PR  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,grid", [(1, 16), (16, 16), (37, 48), (120, 128), (192, 192),
                                    (348, 352)])
def test_grid_order(n, grid):
    assert TCK.grid_order(n) == grid


@pytest.mark.parametrize("n", [120, 37, 192])
def test_counts_the_pad(n):
    """n^3 operations a matrix, and where the grid is larger, the padded
    matrices and grid^3 - n^3 operations of the pad each."""
    B = 3
    A = spd_batch(B, n, 5, CPU)
    PR.reset_counts()
    out = TCK.spd_inverse(A)
    c = PR.counts()
    torch.testing.assert_close(out, TCK.spd_inverse_plain(A), rtol=0, atol=0)
    assert c["spd_inverse.ops"] == B * n ** 3
    grid = TCK.grid_order(n)
    if grid == n:
        assert "spd_inverse.padded" not in c and "spd_inverse.pad_ops" not in c
    else:
        assert c["spd_inverse.padded"] == B
        assert c["spd_inverse.pad_ops"] == B * (grid ** 3 - n ** 3)
    if n == 120:
        assert c["spd_inverse.pad_ops"] == B * 369_152  # 128^3 - 120^3


def test_refuses_what_is_not_a_batch_of_square_matrices():
    with pytest.raises(ValueError):
        TCK.spd_inverse(torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        TCK.spd_inverse(torch.zeros(2, 0, 0))
    with pytest.raises(TypeError):
        TCK.spd_inverse(torch.zeros(2, 4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        TCK.spd_inverse(torch.eye(64).expand(2, 64, 64).to("meta"))


@pytest.fixture(scope="module")
def horizon10_cycle():
    """One production cycle at horizon 10 (nz = 120), B = 2, with the orders
    of the solve's ``spd_inverse`` calls and the counters' change."""
    torch.set_num_threads(2)
    kw = C.engine_kwargs_batched(C.EngineConfig(mpc=C.MpcConfig(horizon=10)))
    dyn, gait, contact, sched, state = start_batch(2, CPU, 10)
    inner, orders = admm.spd_inverse, []

    def counted(A):
        orders.append(A.shape[-1])
        return inner(A)

    admm.spd_inverse = counted
    PR.reset_counts()
    try:
        E.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
    finally:
        admm.spd_inverse = inner
    return dict(orders=orders, counts=PR.counts())


def test_horizon10_solve_calls_spd_inverse(horizon10_cycle):
    """Every KKT factorization and every polish reduced solve at nz = 120
    is a call of ``spd_inverse``, counted on its padded grid."""
    orders, c = horizon10_cycle["orders"], horizon10_cycle["counts"]
    assert orders and set(orders) == {120}
    assert c["kkt_factorizations"] >= 1 and c["polish_solves"] >= 1
    assert len(orders) == c["kkt_factorizations"] + c["polish_solves"]
    rows = c["kkt_rows"] + c["polish_rows"]
    assert c["spd_inverse.padded"] == rows
    assert c["spd_inverse.ops"] == rows * 120 ** 3
    assert c["spd_inverse.pad_ops"] == rows * (128 ** 3 - 120 ** 3)


def test_horizon10_polish_reduced_solve_calls_spd_inverse(horizon10_cycle):
    """The polish's reduced solve alone: ``_polish_core(reduced=True)`` on a
    horizon-10 polish problem makes one ``spd_inverse`` call at n = 120."""
    g = torch.Generator().manual_seed(4)
    B, nz = 2, 120
    nb = nz // 3
    M = torch.randn((B, nz, nz), generator=g) / nz ** 0.5
    P = M @ M.transpose(-1, -2) + 0.1 * torch.eye(nz)
    C_ = torch.randn((B, nb, 4, 3), generator=g)
    q = torch.randn((B, nz), generator=g)
    m = 4 * nb + nz
    l, u = -torch.ones((B, m)), torch.ones((B, m))
    o = admm.PolishOps(p_dense=P, q=q, l=l, u=u, is_eq=torch.zeros((B, m), dtype=torch.bool),
                       C=C_, box=torch.ones((B, nz)), x_it=torch.zeros((B, nz)),
                       o_x=torch.zeros(B), v_x=torch.zeros(B))
    act_lo = torch.zeros((B, m), dtype=torch.bool)
    act_lo[:, ::7] = True
    inner, orders = admm.spd_inverse, []

    def counted(A):
        orders.append(tuple(A.shape))
        return inner(A)

    admm.spd_inverse = counted
    try:
        x_pol, _, _ = admm._polish_core(o, act_lo, torch.zeros_like(act_lo), reduced=True)
    finally:
        admm.spd_inverse = inner
    assert orders == [(B, nz, nz)]
    assert torch.isfinite(x_pol).all()
