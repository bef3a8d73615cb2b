"""Refactor-on-demand of the scenarios whose rho moved
(``mpc/admm.py::_refactor``): the rows it re-inverts and writes into ``Minv``
in place equal the whole batch's ``_factorize`` at the new rho, bit for bit,
for any set of changed rows, with NaN confined to a non-SPD row; and two
closed-loop production cycles at B = 4, horizon 16, equal those made with
every refactor on the whole batch; and ``kkt_matrix``, which assembles M from
K's 3 x 3 blocks, equals the dense sum bit for bit. CPU, small B."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import start_batch  # noqa: E402

from convex_mpc_tpu_torch.mpc import admm  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.utils import config as C  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402
from convex_mpc_tpu_torch.utils import profiling as PR  # noqa: E402

B = 5


def same(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def kkt_pieces(nz: int, seed: int = 0) -> admm.KktSetup:
    """A KKT setup of B scenarios at ``nz``: P SPD, K block-diagonal PSD of
    3 x 3 blocks, a positive box diagonal (the parts ``kkt_matrix`` reads)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((B, nz, nz), generator=g) / nz ** 0.5
    P = A @ A.transpose(-1, -2) + 0.1 * torch.eye(nz)
    nb = nz // 3
    blk = torch.randn((B, nb, 3, 3), generator=g)
    blk = blk @ blk.transpose(-1, -2)
    box = torch.rand((B, nz), generator=g) + 0.5
    return admm.KktSetup(s=None, is_eq=None, w_vec=None, P_mat=P, K_blocks=blk, K_box_diag=box)


@pytest.mark.parametrize("nz", [120, 192, 384])
def test_kkt_matrix_equals_the_dense_sum(nz):
    """M from K's 3 x 3 blocks is bit for bit (signs of zeros too) the dense
    P_mat + rho K + diag(rho K_box_diag), K built from the same blocks, with
    -0 and +0 entries in P_mat and zero blocks in K."""
    setup = kkt_pieces(nz, seed=3)
    P = setup.P_mat.clone()
    P[:, ::7, ::5] = -0.0
    P[:, 1::11, ::3] = 0.0
    blk = setup.K_blocks.clone()
    blk[:, ::4] = -0.0
    setup = setup._replace(P_mat=P, K_blocks=blk)
    rho = torch.tensor([0.1, 1e-3, 2e-4, 0.1, 5e-4])
    nb = nz // 3
    K = (blk[:, :, :, None, :] * torch.eye(nb)[None, :, None, :, None]).reshape(B, nz, nz)
    box = (rho[:, None] * setup.K_box_diag)[:, :, None] * torch.eye(nz)
    dense = P + rho[:, None, None] * K + box
    M = admm.kkt_matrix(setup, rho)
    assert torch.equal(M, dense)
    assert torch.equal(M.view(torch.int32), dense.view(torch.int32))


MASKS = {
    "none": [],
    "one": [3],
    "some": [0, 2, 4],
    "all": list(range(B)),
}


@pytest.mark.parametrize("nz", [192, 384])
@pytest.mark.parametrize("mask", list(MASKS))
def test_subset_refactor_equals_the_whole_batch(nz, mask):
    setup = kkt_pieces(nz)
    rho = torch.tensor([0.1, 1e-3, 2e-4, 0.1, 5e-4])
    changed = torch.zeros(B, dtype=torch.bool)
    changed[MASKS[mask]] = True
    rho_new = torch.where(changed, rho * 0.1, rho)
    Minv = admm._factorize(setup, rho)
    PR.reset_counts()
    out = admm._refactor(setup, rho_new, Minv, changed, int(changed.sum()))
    same(out, admm._factorize(setup, rho_new))
    c = PR.counts()
    assert c["kkt_rows"] - B == int(changed.sum())  # the whole batch's B counted once
    assert c["kkt_factorizations"] == 2
    if 0 < int(changed.sum()) < B:
        assert out is Minv  # written in place


@pytest.mark.parametrize("nz", [192, 384])
def test_non_spd_changed_row_is_nan_alone(nz):
    setup = kkt_pieces(nz, seed=1)
    rho = torch.full((B,), 1e-2)
    Minv = admm._factorize(setup, rho)
    before = Minv.clone()
    changed = torch.tensor([False, True, False, True, False])
    rho_new = torch.where(changed, rho * 0.1, rho)
    rho_new[1] = -1e3  # M(rho) indefinite: its Cholesky meets a negative pivot
    out = admm._refactor(setup, rho_new, Minv, changed, 2)
    assert torch.isnan(out[1]).all()
    assert not torch.isnan(out[[0, 2, 3, 4]]).any()
    same(out[[0, 2, 4]], before[[0, 2, 4]])
    same(out, admm._factorize(setup, rho_new))


@pytest.mark.parametrize("nz", [192, 384])
def test_unchanged_nan_row_stays_nan(nz):
    setup = kkt_pieces(nz, seed=2)
    rho = torch.full((B,), 1e-2)
    rho[2] = -1e3
    Minv = admm._factorize(setup, rho)
    assert torch.isnan(Minv[2]).all()
    changed = torch.tensor([True, False, False, False, True])
    rho_new = torch.where(changed, rho * 0.1, rho)
    out = admm._refactor(setup, rho_new, Minv, changed, 2)
    assert torch.isnan(out[2]).all()
    assert not torch.isnan(out[[0, 1, 3, 4]]).any()
    same(out, admm._factorize(setup, rho_new))


def _two_cycles(whole: bool, monkeypatch):
    if whole:
        monkeypatch.setattr(admm, "_refactor",
                            lambda setup, rho, Minv, changed, k: admm._factorize(setup, rho))
    kw = C.engine_kwargs_batched(C.DEFAULT_CONFIG)
    assert kw["n"] == 16
    # x offsets of +-5 cm: rho moves in both cycles, so each refactors a subset
    dyn, gait, contact, sched, state = start_batch(4, torch.device("cpu"), x_spread=0.05)
    out, counts = [], []
    for _ in range(2):
        PR.reset_counts()
        state, log = E.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
        out.append((state, log))
        counts.append(PR.counts())
    monkeypatch.undo()
    return out, counts


def test_cycles_equal_whole_batch_refactors(monkeypatch):
    """Two closed-loop cycles, B = 4, horizon 16: the subset refactors leave
    state and log as every refactor on the whole batch would, and they ran
    (fewer rows than B a factorization)."""
    torch.set_num_threads(2)
    sub, sub_counts = _two_cycles(False, monkeypatch)
    whole, whole_counts = _two_cycles(True, monkeypatch)
    for run_a, run_b in zip(sub, whole):
        for tree_a, tree_b in zip(run_a, run_b):  # state, log
            a_leaves, b_leaves = interop.tree_leaves(tree_a), interop.tree_leaves(tree_b)
            assert len(a_leaves) == len(b_leaves) > 0
            for a, b in zip(a_leaves, b_leaves):
                assert torch.equal(a, b)
    rows_counted = ("kkt_rows", "spd_inverse.ops")  # follow the rows inverted
    for a, b in zip(sub_counts, whole_counts):
        assert a["kkt_factorizations"] == b["kkt_factorizations"]
        assert b["kkt_rows"] == 4 * b["kkt_factorizations"]
        assert 4 <= a["kkt_rows"] < 4 * a["kkt_factorizations"]
        for c in (a, b):
            assert c["spd_inverse.ops"] == (c["kkt_rows"] + c["polish_rows"]) * 192 ** 3
        assert {k: v for k, v in a.items() if k not in rows_counted} == {
            k: v for k, v in b.items() if k not in rows_counted}
