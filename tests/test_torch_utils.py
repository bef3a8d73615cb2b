"""The port's utils (checkpoint, profiling) and ``linalg.spd_inverse_recursive``
against the JAX package.

- Checkpoints cross between the packages in both directions with every leaf
  of an ``EngineState`` equal (the keys are JAX's ``keystr`` strings); a
  missing leaf raises ``KeyError``, a shape mismatch ``ValueError``, and both
  packages put a file at the same ``.npz`` name.
- ``SolveStats.summary()`` equals JAX's on the same numpy-seeded logs;
  ``time_fn`` returns a positive float; ``trace`` writes a Chrome trace.
- ``spd_inverse_recursive`` on uniformly conditioned SPD batches (cond <= 1e2,
  B = 4): within 1e-4 of JAX's, and both within 1e-4 of the f64
  ``np.linalg.inv``, each relative to the inverse's largest entry.
"""

from __future__ import annotations

import json
import sys
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parity  # noqa: E402,F401  (thread pool size)

from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.ops import linalg as JL
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.utils import checkpoint as JC
from convex_mpc_tpu.utils import profiling as JPR
from convex_mpc_tpu_torch.models import dynamics as TD
from convex_mpc_tpu_torch.ops import linalg as TL
from convex_mpc_tpu_torch.sim import engine as TE
from convex_mpc_tpu_torch.utils import checkpoint as TC
from convex_mpc_tpu_torch.utils import interop
from convex_mpc_tpu_torch.utils import profiling as TPR

KEYS = [".plant.q", ".plant.dq", ".leg.last_mask", ".leg.takeoff_time", ".leg.swing_p0",
        ".leg.swing_td", ".refgen.pos_des_world", ".refgen.vel_cmd", ".solver.x", ".solver.z",
        ".solver.y", ".solver.rho", ".yaw_cont", ".yaw_prev", ".u0", ".t", ".vel_filt"]


@pytest.fixture(scope="module")
def jax_dyn():
    return JD.build_dyn()


@pytest.fixture(scope="module")
def port_dyn():
    return TD.build_dyn(device="cpu")


def _jax_state(dyn, seed: int):
    """JAX init_state(n=16) with every float leaf made non-zero from a seed."""
    rng = np.random.default_rng(seed)
    s = JE.init_state(dyn, n=16)
    return jax.tree.map(lambda v: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                        if v.dtype == jnp.float32 else v, s)


def test_port_keys_are_jax_keystr(port_dyn, tmp_path):
    TC.save_pytree(tmp_path / "s", TE.init_state(port_dyn, n=16))
    with np.load(tmp_path / "s.npz") as d:
        assert list(d.keys()) == KEYS


def test_checkpoint_jax_to_port(jax_dyn, port_dyn, tmp_path):
    state = _jax_state(jax_dyn, 0)
    assert float(jnp.abs(state.plant.q).max()) > 0
    JC.save_pytree(tmp_path / "j.npz", state)
    back = TC.load_pytree(tmp_path / "j.npz", TE.init_state(port_dyn, n=16))
    ref = jax.tree_util.tree_leaves(state)
    got = interop.tree_leaves(back)
    assert len(got) == len(ref) == 17
    for a, b in zip(got, ref):
        assert a.dtype == {"float32": torch.float32, "int32": torch.int32}[str(b.dtype)]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_port_to_jax(jax_dyn, port_dyn, tmp_path):
    rng = np.random.default_rng(1)
    like = TE.init_state(port_dyn, n=16)
    state = interop.tree_map(lambda v: torch.as_tensor(
        rng.standard_normal(tuple(v.shape)), dtype=v.dtype) if v.is_floating_point() else v + 1,
        like)
    TC.save_pytree(tmp_path / "p", state)
    back = JC.load_pytree(tmp_path / "p", JE.init_state(jax_dyn, n=16))
    for a, b in zip(jax.tree_util.tree_leaves(back), interop.tree_leaves(state)):
        assert str(np.asarray(a).dtype) == str(b.numpy().dtype)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_checkpoint_nested_tuples_and_none(tmp_path):
    """Plain tuples, lists, dicts and None leaves keep JAX's keys and structure."""
    P = namedtuple("P", ["a", "b"])
    tree = (P(a=torch.arange(3, dtype=torch.float32), b=None), [torch.ones(2, 2), torch.zeros(1)],
            {"y": torch.full((2,), 5.0), "x": torch.full((1,), 4.0)})
    TC.save_pytree(tmp_path / "t", tree)
    jlike = (P(a=jnp.zeros(3), b=None), [jnp.ones((2, 2)), jnp.ones(1)],
             {"y": jnp.zeros(2), "x": jnp.zeros(1)})
    with np.load(tmp_path / "t.npz") as d:
        assert list(d.keys()) == [jax.tree_util.keystr(k) for k, _ in
                                  jax.tree_util.tree_flatten_with_path(jlike)[0]]
        assert list(d.keys()) == ["[0].a", "[1][0]", "[1][1]", "[2]['x']", "[2]['y']"]
    jback = JC.load_pytree(tmp_path / "t", jlike)
    assert jback[0].b is None
    np.testing.assert_array_equal(np.asarray(jback[0].a), [0, 1, 2])
    np.testing.assert_array_equal(np.asarray(jback[2]["y"]), [5.0, 5.0])
    like = (P(a=torch.zeros(3), b=None), [torch.zeros(2, 2), torch.zeros(1)],
            {"y": torch.zeros(2), "x": torch.zeros(1)})
    back = TC.load_pytree(tmp_path / "t", like)
    assert back[0].b is None and isinstance(back[1], list)
    assert torch.equal(back[0].a, tree[0].a) and torch.equal(back[1][0], tree[1][0])
    assert torch.equal(back[2]["x"], tree[2]["x"]) and torch.equal(back[2]["y"], tree[2]["y"])


def test_checkpoint_missing_leaf_raises(port_dyn, tmp_path):
    state = TE.init_state(port_dyn, n=16)
    TC.save_pytree(tmp_path / "s", state)
    X = namedtuple("X", ["plant", "extra"])
    with pytest.raises(KeyError, match="checkpoint missing leaf '\\.extra'"):
        TC.load_pytree(tmp_path / "s", X(plant=state.plant, extra=torch.zeros(1)))


def test_checkpoint_shape_mismatch_raises(port_dyn, tmp_path):
    TC.save_pytree(tmp_path / "s", TE.init_state(port_dyn, n=16))
    with pytest.raises(ValueError, match="'\\.solver\\.x' shape \\(192,\\) != expected "
                                         "\\(120,\\)"):
        TC.load_pytree(tmp_path / "s", TE.init_state(port_dyn, n=10))


@pytest.mark.parametrize("name", ["ckpt", "ckpt.npz", "run.state", "dir.v2/ckpt"])
def test_checkpoint_npz_suffix_rule(name, tmp_path):
    assert TC._npz_path(tmp_path / name) == JC._npz_path(tmp_path / name)
    (tmp_path / "dir.v2").mkdir()
    TC.save_pytree(tmp_path / name, (torch.ones(2),))
    assert TC._npz_path(tmp_path / name).exists()
    assert torch.equal(TC.load_pytree(tmp_path / name, (torch.zeros(2),))[0], torch.ones(2))


def test_solve_stats_summary_matches_jax():
    rng = np.random.default_rng(3)
    Log = namedtuple("Log", ["solver_iters", "prim_res", "dual_res"])
    jst, tst = JPR.SolveStats(), TPR.SolveStats()
    for k in range(3):
        it = rng.integers(25, 1001, (6, 4)).astype(np.int32)
        pr = rng.random((6, 4)).astype(np.float32)
        du = rng.random((6, 4)).astype(np.float32)
        jst.update(Log(jnp.asarray(it), jnp.asarray(pr), jnp.asarray(du)), max_iter=1000)
        tst.update(Log(torch.as_tensor(it), torch.as_tensor(pr), torch.as_tensor(du)),
                   max_iter=1000)
    assert tst.summary() == jst.summary()
    assert tst.summary()["cycles"] == 72
    assert TPR.SolveStats().summary() == JPR.SolveStats().summary() == {}


def test_time_fn_positive():
    a = torch.randn(32, 32)
    t = TPR.time_fn(torch.matmul, a, a, windows=2, reps=3)
    assert isinstance(t, float) and t > 0.0


def test_trace_writes_chrome_trace(tmp_path):
    with TPR.trace(tmp_path / "tr") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert TPR.device_busy_ms(prof) == 0.0  # a CPU run has no device interval


def _spd_batch(n: int, seed: int, B: int = 4) -> np.ndarray:
    """Q diag(lam) Q' with lam uniform in [1, 100]: cond <= 1e2."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    lam = rng.uniform(1.0, 100.0, (B, n))
    M = np.einsum("bij,bj,bkj->bik", Q, lam, Q)
    return (0.5 * (M + M.transpose(0, 2, 1))).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6, 8, 12, 20, 48])
def test_spd_inverse_recursive_matches_jax(n):
    M = _spd_batch(n, seed=n)
    port = TL.spd_inverse_recursive(torch.as_tensor(M)).numpy()
    ref = np.asarray(JL.spd_inverse_recursive(jnp.asarray(M)))
    truth = np.linalg.inv(M.astype(np.float64))
    scale = np.abs(truth).max()
    assert np.abs(port - ref).max() <= 1e-4 * scale
    assert np.abs(port - truth).max() <= 1e-4 * scale
    assert np.abs(ref - truth).max() <= 1e-4 * scale
