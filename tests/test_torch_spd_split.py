"""A numpy model of kernel 1's cluster schedule, run on the CPU.

``csrc/spd_inverse.cu`` splits the packed upper triangle of each matrix
between the two CTAs of a cluster (``spd_inverse_cluster_kernel``): rank r
holds the 16-row panels p with p % 2 == r (``half_rowoff``), and values
cross between the CTAs only as panels pushed into a staging slot of the peer
(phase 1), strips (U W_q) pushed into the peer's slot q % 2 (phase 2), the
peer's diagonal blocks and, in phase 3, its panels copied out of its shared
memory. The model below runs the kernel's schedule, loop for loop, on two
ranks that hold only their own rows and share nothing else, at n = 64 and 96
(4 and 6 panels), each rank a generator that a scheduler interleaves: one
rank first as far as it can go, the other first, and seeded random orders,
a push landing in the peer at once (the earliest a real one can). It
asserts:

- the layout: ``half_rowoff`` maps each rank's packed rows one to one onto
  its ``half_floats`` and the shared bytes are ``cluster_floats``;
- every 4 x 4 output tile (a <= b) is written by exactly one rank;
- every read is of an owned row, or of a staged copy whose source has not
  been written since it was copied; a panel copied out of the peer's shared
  memory is never written again; a push lands only in a slot its receiver
  has released, and each wait finds exactly the bytes it armed for;
- the result matches JAX ``spd_inverse`` on the CPU, by its XLA path and
  (at n = 64) by its Pallas kernel under ``interpret=True`` (as
  tests/test_torch_mpc.py runs it), and the port's plain version, within
  5e-5 x max|ref|;
- a matrix failing at its first pivot and one failing only in its last
  panel come back all NaN, their neighbour finite.

It also checks that a launch the C side refuses raises with n.
"""

from __future__ import annotations

import ctypes
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_mpc_tpu.ops.chol_kernel import spd_inverse as jax_spd_inverse
from convex_mpc_tpu_torch.ops import chol_kernel as TCK
from convex_mpc_tpu_torch.utils import cuda_build

NB = 16


# the kernel's index arithmetic, line for line
def half_rowoff(i: int, n: int, r: int) -> int:
    p, g = i >> 4, i >> 2
    k, gl = p >> 1, g & 3
    return (k * (16 * n - 96 - 256 * r) - 256 * k * (k - 1) + 4 * gl * (n - 16 * p)
            - 8 * gl * (gl - 1) + (i & 3) * (n - 4 * g) - 4 * g)


def half_floats(n: int, r: int) -> int:
    k = (n // NB + 1 - r) // 2
    return k * (16 * n - 96 - 256 * r) - 256 * k * (k - 1)


def cluster_floats(n: int) -> int:
    return half_floats(n, 0) + 32 * n + 256 * ((n // NB + 1) // 2)


def upper_tile(t: int) -> tuple[int, int]:
    b = int((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    if (b + 1) * (b + 2) // 2 <= t:
        b += 1
    elif b * (b + 1) // 2 > t:
        b -= 1
    return t - b * (b + 1) // 2, b


class Buf:
    """A rank's shared-memory array: values, a write version per float, and
    for a staged float the buffer, index and version of its source. Every
    buffer of a model is listed in its ``bufs``, by ``id``."""

    def __init__(self, size: int, bufs: list):
        self.v = np.full(size, np.nan, np.float32)
        self.ver = np.zeros(size, np.int64)
        self.src_buf = np.full(size, -1, np.int64)  # the source's id, -1: not a copy
        self.src_idx = np.zeros(size, np.int64)
        self.src_ver = np.zeros(size, np.int64)
        self.bufs, self.id = bufs, len(bufs)
        bufs.append(self)


class Rank:
    def __init__(self, n: int, r: int, bufs: list):
        self.r, self.peer = r, r ^ 1
        self.S = Buf(half_floats(n, r), bufs)
        self.stage = Buf(32 * n, bufs)
        self.wpeer = Buf(256 * ((n // NB + 1 - self.peer) // 2), bufs)
        self.pending = [0, 0]  # bytes landed in each slot since its last wait
        self.busy = [False, False]  # a slot between its wait and its release
        self.bad = False
        self.peer_bad = None


class Model:
    def __init__(self, A: np.ndarray):
        self.A = A.astype(np.float32)
        self.n = A.shape[0]
        bufs: list[Buf] = []
        self.ranks = [Rank(self.n, 0, bufs), Rank(self.n, 1, bufs)]
        self.out = np.full((self.n, self.n), np.inf, np.float32)
        self.tiles: dict[tuple[int, int], list[int]] = {}
        self.pulled: list[tuple[Buf, np.ndarray, np.ndarray]] = []

    # ---- memory ------------------------------------------------------------
    def row(self, rk: Rank, i: int) -> int:
        assert (i >> 4) % 2 == rk.r, f"rank {rk.r} addresses row {i}, which it does not hold"
        return half_rowoff(i, self.n, rk.r)

    @staticmethod
    def read(buf: Buf, idx, staged: bool = False) -> np.ndarray:
        idx = np.asarray(idx)
        if staged:
            ids = buf.src_buf[idx]
            assert (ids >= 0).all(), "read of a staged float nothing was copied into"
            for b in np.unique(ids):
                sel = ids == b
                src = buf.bufs[b]
                assert np.array_equal(src.ver[buf.src_idx[idx][sel]], buf.src_ver[idx][sel]), \
                    "staged copy read after its source was written again"
        return buf.v[idx]

    @staticmethod
    def write(buf: Buf, idx, vals) -> None:
        idx = np.asarray(idx)
        buf.v[idx] = vals
        buf.ver[idx] += 1
        buf.src_buf[idx] = -1

    @staticmethod
    def copy(dst: Buf, didx, src: Buf, sidx) -> None:
        didx, sidx = np.asarray(didx).ravel(), np.asarray(sidx).ravel()
        dst.v[didx] = src.v[sidx]
        dst.ver[didx] += 1
        dst.src_buf[didx] = src.id
        dst.src_idx[didx] = sidx
        dst.src_ver[didx] = src.ver[sidx]

    def push(self, rk: Rank, slot: int, off: int, src: Buf, sidx) -> None:
        """16 bytes into the peer's slot at float ``off``, from ``src``."""
        peer = self.ranks[rk.peer]
        assert not peer.busy[slot], f"push into rank {peer.r}'s slot {slot} before its release"
        self.copy(peer.stage, 16 * self.n * slot + off + np.arange(4), src, sidx)
        peer.pending[slot] += 16

    def receive(self, rk: Rank, slot: int, nbytes: int):
        if rk.pending[slot] < nbytes:
            yield ("wait", slot, nbytes)  # resumed once that many bytes have landed
        assert rk.pending[slot] == nbytes, "bytes of a later message landed before this wait"
        assert not rk.busy[slot]
        rk.pending[slot] = 0
        rk.busy[slot] = True

    # ---- tiles -------------------------------------------------------------
    def rows_idx(self, rk: Rank, rows, cols, base=None) -> np.ndarray:
        """Indices of (rows x cols) of rank rk's packed rows (or, with
        ``base``, of the same rows copied into a buffer at that shift)."""
        offs = [(half_rowoff(i, self.n, rk.r) - base) if base is not None else self.row(rk, i)
                for i in rows]
        return np.asarray(offs)[:, None] + np.asarray(cols)[None, :]

    def update_tile(self, rk, src, c0, a0, b0):
        """M[a0.., b0..] -= U[c0 + m, a0..]' U[c0 + m, b0..] (16 m), src either
        ('own', None) or ('staged', slot)."""
        n, ms = self.n, range(c0, c0 + NB)
        if src[0] == "own":
            U_a = self.read(rk.S, self.rows_idx(rk, ms, range(a0, a0 + 4)))
            U_b = self.read(rk.S, self.rows_idx(rk, ms, range(b0, b0 + 4)))
        else:
            assert rk.busy[src[1]], "read of a slot outside its wait and release"
            base = 16 * n * src[1]
            ia = base + np.arange(NB)[:, None] * n + np.arange(a0, a0 + 4)[None, :]
            ib = base + np.arange(NB)[:, None] * n + np.arange(b0, b0 + 4)[None, :]
            U_a, U_b = self.read(rk.stage, ia, True), self.read(rk.stage, ib, True)
        idx = self.rows_idx(rk, range(a0, a0 + 4), range(b0, b0 + 4))
        self.write(rk.S, idx, self.read(rk.S, idx) - U_a.T @ U_b)

    def invert_diag(self, rk: Rank, c0: int) -> None:
        """The warp's 16 x 16 Cholesky (pivot > 0 else bad, and 1 in its
        place) and W = U_pp^-1 written over the block's packed entries."""
        blk = np.zeros((NB, NB), np.float32)
        for rr in range(NB):
            blk[rr, rr:] = self.read(rk.S, self.rows_idx(rk, [c0 + rr], range(c0 + rr, c0 + NB)))[0]
        col = blk.copy()
        with np.errstate(over="ignore", invalid="ignore"):  # a non-SPD block may blow up
            for m in range(NB):
                piv = col[m, m]
                ok = piv > 0.0
                rk.bad = rk.bad or not ok
                col[m, m:] *= np.float32(1.0 / np.sqrt(piv if ok else 1.0))
                for rr in range(m + 1, NB):
                    col[rr, rr:] -= col[m, rr] * col[m, rr:]
        W = np.triu(np.linalg.inv(np.triu(col).astype(np.float64))).astype(np.float32)
        for i in range(NB):
            lo = i & ~3
            self.write(rk.S, self.rows_idx(rk, [c0 + i], range(c0 + lo, c0 + NB))[0], W[i, lo:])

    def vv_tile(self, rk, a0, b0, panel=None):
        """out[a0.., b0..] and its mirror from rows a0.. (own) and b0.. (own,
        or the peer's panel copied into slot 0 at shift ``panel``)."""
        n = self.n
        ks = range(b0, n)
        Va = self.read(rk.S, self.rows_idx(rk, range(a0, a0 + 4), ks))
        if panel is None:
            Vb = self.read(rk.S, self.rows_idx(rk, range(b0, b0 + 4), ks))
        else:
            assert rk.busy[0]
            Vb = self.read(rk.stage, self.rows_idx(self.ranks[rk.peer], range(b0, b0 + 4), ks,
                                                   base=panel), True)
        acc = Va @ Vb.T
        self.out[a0:a0 + 4, b0:b0 + 4] = acc
        self.out[b0:b0 + 4, a0:a0 + 4] = acc.T
        self.tiles.setdefault((a0 // 4, b0 // 4), []).append(rk.r)

    # ---- the schedule of one CTA -------------------------------------------
    def program(self, r: int):
        n = self.n
        rk, other = self.ranks[r], self.ranks[r ^ 1]
        peer = r ^ 1
        P, G = n // NB, n // 4
        K, Kp = (P + 1 - r) // 2, (P + 1 - peer) // 2

        def grp(gi):
            return 4 * (r + 2 * (gi >> 2)) + (gi & 3)

        for il in range(16 * K):
            i = 16 * (r + 2 * (il >> 4)) + (il & 15)
            lo = 4 * (i >> 2)
            self.write(rk.S, self.rows_idx(rk, [i], range(lo, n))[0], self.A[i, lo:])
        yield "barrier"

        # 1. blocked Cholesky over this rank's panels
        sent = got = 0
        for q in range(r, P, 2):
            c0, c1 = q * NB, q * NB + NB
            prev = None

            def later(src, cs):  # this rank's panels q + 2, q + 4, .. from panel cs / 16
                for pa in range(q + 2, P, 2):
                    for t in range(4 * (G - 4 * pa)):
                        ga, gb = 4 * pa + (t & 3), 4 * pa + (t >> 2)
                        if gb >= ga:
                            self.update_tile(rk, src, cs, 4 * ga, 4 * gb)
            if q > 0:
                s = got & 1
                got += 1
                yield from self.receive(rk, s, 64 * (n - c0))
                prev = ("staged", s)
                for lane in range(10):
                    ta, tb = upper_tile(lane)
                    self.update_tile(rk, prev, c0 - NB, c0 + 4 * ta, c0 + 4 * tb)
                self.invert_diag(rk, c0)
                for t in range(n - c1):
                    self.update_tile(rk, prev, c0 - NB, c0 + 4 * (t & 3), c1 + 4 * (t >> 2))
                later(prev, c0 - NB)  # while warp 0 inverts
                rk.busy[prev[1]] = False  # panel q - 1 is read no more
            else:
                self.invert_diag(rk, 0)
            yield "step"
            s_out, tiles = sent & 1, []
            for t in range(n - c1):  # every tile reads, then every tile writes
                r0, j0 = 4 * (t & 3), c1 + 4 * (t >> 2)
                ms = range(c0, c0 + r0 + 4)
                Wt = self.read(rk.S, self.rows_idx(rk, ms, range(c0 + r0, c0 + r0 + 4)))
                X = self.read(rk.S, self.rows_idx(rk, ms, range(j0, j0 + 4)))
                tiles.append((r0, j0, Wt.T @ X))
            for r0, j0, acc in tiles:
                for rr in range(4):
                    idx = self.rows_idx(rk, [c0 + r0 + rr], range(j0, j0 + 4))[0]
                    self.write(rk.S, idx, acc[rr])
                    self.push(rk, s_out, (r0 + rr) * n + j0, rk.S, idx)
            if n - c1 > 0:
                sent += 1
            yield "step"
            later(("own", None), c0)
            yield "step"

        other.peer_bad = rk.bad
        yield "barrier"
        if rk.bad or rk.peer_bad:
            for il in range(16 * K):
                self.out[16 * (r + 2 * (il >> 4)) + (il & 15)] = np.nan
            return

        # 2. V = U^-1: the peer's diagonal blocks, then block columns q
        for pk in range(Kp):
            c0 = NB * (peer + 2 * pk)
            for i in range(NB):
                lo = 4 * (i >> 2)
                sidx = self.rows_idx(other, [c0 + i], range(c0 + lo, c0 + NB))[0]
                didx = 256 * pk + 16 * i + np.arange(lo, NB)
                self.copy(rk.wpeer, didx, other.S, sidx)
                self.pulled.append((other.S, sidx, other.S.ver[sidx].copy()))
        yield "step"
        for q in range(1, P):
            c0, s = q * NB, q & 1
            rows, peer_rows = NB * ((q + 1 - r) // 2), NB * ((q + 1 - peer) // 2)
            assert not rk.busy[s]
            base = 16 * n * s
            for t in range(rows):
                k0, cc = 4 * grp(t >> 2), 4 * (t & 3)
                U = self.read(rk.S, self.rows_idx(rk, range(k0, k0 + 4), range(c0, c0 + cc + 4)))
                if (q & 1) == r:
                    W = self.read(rk.S, self.rows_idx(rk, range(c0, c0 + cc + 4),
                                                      range(c0 + cc, c0 + cc + 4)))
                else:
                    widx = (256 * (q >> 1) + 16 * np.arange(cc + 4)[:, None]
                            + np.arange(cc, cc + 4)[None, :])
                    W = self.read(rk.wpeer, widx, True)
                acc = U @ W
                for rr in range(4):
                    idx = base + 16 * (k0 + rr) + cc + np.arange(4)
                    self.write(rk.stage, idx, acc[rr])
                    self.push(rk, s, 16 * (k0 + rr) + cc, rk.stage, idx)
            if peer_rows > 0:
                yield from self.receive(rk, s, 64 * peer_rows)
            else:
                rk.busy[s] = True
            yield "step"
            assert rk.busy[s]
            for t in range(rows):
                i0, cc = 4 * grp(t >> 2), 4 * (t & 3)
                V = self.read(rk.S, self.rows_idx(rk, range(i0, i0 + 4), range(i0, c0)))
                sidx = base + 16 * np.arange(i0, c0)[:, None] + np.arange(cc, cc + 4)[None, :]
                strip = np.empty((c0 - i0, 4), np.float32)
                for k in range(i0, c0):  # own rows from this rank's writes, the peer's pushed
                    own = (k >> 4) % 2 == r
                    strip[k - i0] = self.read(rk.stage, sidx[k - i0], not own)
                self.write(rk.S, self.rows_idx(rk, range(i0, i0 + 4), range(c0 + cc, c0 + cc + 4)),
                           -(V @ strip))
            rk.busy[s] = False
            yield "step"

        # 3. out = V V'
        yield "barrier"
        gm = 4 * K
        for t in range(gm * (gm + 1) // 2):
            ta, tb = upper_tile(t)
            self.vv_tile(rk, 4 * grp(ta), 4 * grp(tb))
        for pb in range(peer, P, 2):
            ra = 4 * ((pb + 1 - r) // 2)
            if ra == 0:
                continue
            first = half_rowoff(NB * pb, n, peer) + NB * pb
            length = 16 * n - 256 * pb - 96
            assert not rk.busy[0]
            sidx = first + np.arange(length)
            self.copy(rk.stage, np.arange(length), other.S, sidx)
            self.pulled.append((other.S, sidx, other.S.ver[sidx].copy()))
            rk.busy[0] = True
            for t in range(4 * ra):
                self.vv_tile(rk, 4 * grp(t % ra), 4 * (4 * pb + t // ra), panel=first)
            rk.busy[0] = False
            yield "step"
        yield "barrier"


def run_model(A: np.ndarray, order: str) -> Model:
    """The two ranks' programs interleaved: ``first0`` / ``first1`` run that
    rank whenever it can move, ``seed<k>`` picks a rank that can move at
    random at every step. A rank waiting for bytes can move once they have
    landed; a cluster barrier lets both go once both reached it (a rank
    that returned on the NaN path has passed its last one). Returns the
    model after its checks."""
    m = Model(A)
    progs = [m.program(0), m.program(1)]
    state: list = ["run", "run"]  # "run", ("wait", slot, bytes), "barrier", "done"
    rng = random.Random(int(order[4:]) if order.startswith("seed") else 0)

    def can_move(i):
        st = state[i]
        return st == "run" or (isinstance(st, tuple) and m.ranks[i].pending[st[1]] >= st[2])

    while state != ["done", "done"]:
        if all(st in ("barrier", "done") for st in state):
            state = ["run" if st == "barrier" else st for st in state]
            continue
        movable = [i for i in (0, 1) if can_move(i)]
        assert movable, f"deadlock: {state}"
        if order.startswith("seed"):
            i = rng.choice(movable)
        else:
            i = int(order[-1]) if int(order[-1]) in movable else movable[0]
        if isinstance(state[i], tuple):  # the wait's bytes are here: the receive goes on
            state[i] = "run"
        try:
            ev = next(progs[i])
        except StopIteration:
            state[i] = "done"
            continue
        state[i] = "run" if ev == "step" else ev
    for rk in m.ranks:
        assert rk.pending == [0, 0], "a push that was never waited for"
        assert rk.busy == [False, False], "a slot never released"
    for buf, sidx, ver in m.pulled:
        assert np.array_equal(buf.ver[sidx], ver), "a copied row was written after the copy"
    return m


def spd_batch(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(3, n, n)).astype(np.float32)
    A = (M @ np.swapaxes(M, -1, -2) / n + 3.0 * np.eye(n, dtype=np.float32)).astype(np.float32)
    A[1] -= 4.0 * np.eye(n, dtype=np.float32)  # fails at its first pivot
    A[2, n - 16:, n - 16:] -= 50.0  # fails only in its last panel
    return A


def test_half_layout():
    """Each rank's packed rows fill [0, half_floats) one to one; at n = 384
    the shared bytes of a CTA are those the kernel reports (216,576 B)."""
    for n in (64, 96, 352, 384):
        for r in (0, 1):
            offs = [half_rowoff(i, n, r) + j for i in range(n) if (i >> 4) % 2 == r
                    for j in range(4 * (i >> 2), n)]
            assert sorted(offs) == list(range(half_floats(n, r)))
    assert 4 * cluster_floats(384) == 216576
    assert 4 * half_floats(384, 0) == 155136 and 4 * half_floats(384, 1) == 142848


@pytest.mark.parametrize("n", [64, 96])
def test_cluster_schedule_matches_jax(n):
    A = spd_batch(n, seed=n)
    # the Pallas interpreter takes ~8 s to trace at n = 64 and ~13 s at 96,
    # whatever the batch: it runs at n = 64 only, on the SPD matrix
    refs = [np.asarray(jax_spd_inverse(jnp.asarray(A[:k]), blk=32, block_k=1, interpret=interp))
            for k, interp in ((3, False), (1, True)) if k == 3 or n == 64]
    plain = TCK.spd_inverse_plain(torch.from_numpy(A)).numpy()
    for order in ("first0", "first1", "seed1", "seed2"):
        m = run_model(A[0], order)
        assert sorted(m.tiles) == sorted((a, b) for b in range(n // 4) for a in range(b + 1))
        assert all(len(w) == 1 for w in m.tiles.values()), "a tile written twice"
        assert {w[0] for w in m.tiles.values()} == {0, 1}
        for ref in (*refs, plain):
            scale = np.abs(ref[0]).max()
            np.testing.assert_allclose(m.out, ref[0], atol=5e-5 * scale, rtol=0)
    for b in (1, 2):  # first pivot, last panel: all NaN in either order
        for order in ("first0", "first1"):
            out = run_model(A[b], order).out
            assert np.isnan(out).all(), (b, order)
        assert np.isnan(plain[b]).all()
    assert np.isfinite(plain[0]).all()


def test_refused_launch_raises_with_n(monkeypatch):
    """A launch the C side refuses (no cluster of 2 resident:
    cudaErrorInvalidConfiguration) raises, naming n; nothing falls back."""

    def c_function(lib, symbol, argtypes):  # the C side's answers at n = 384, 0 resident
        def spd_inverse_shape(n, *refs):
            for ref, v in zip(refs, (216576, 0, 0, 2)):
                ref._obj.value = v
            return 0

        return spd_inverse_shape if symbol == "spd_inverse_shape" else lambda *args: 9

    class CudaLike:  # what the launch reads of a CUDA tensor
        device, shape = torch.device("cuda", 0), (2, 384, 384)

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

    monkeypatch.setattr(cuda_build, "_fn", c_function)
    monkeypatch.setattr(TCK, "_shapes", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    assert TCK.spd_inverse_shape(384) == (216576, 0, 0, 2)
    with pytest.raises(RuntimeError, match=r"n=384"):
        TCK._launch(CudaLike(), CudaLike())
