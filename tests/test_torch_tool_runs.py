"""The port's counterparts of the JAX ablation, sweep and host-side tools, on the CPU.

- ``tools/torch_cycle_ablation.py`` and ``tools/torch_solve_ablation.py``
  with ``--cpu`` at B = 2: the JAX tools' keys and rows, every time finite
  and positive (CPU times), the structured chunk's wrapper restored after
  the plain version was swapped in, ``admm.SEGMENTS`` restored after the
  segment ablation.
- ``tools/torch_spd_kernel_bench.py --cpu``: a row per n and route, each
  inverse's residual small.
- ``tools/torch_long_sweep.py`` (B = 4, 2-cycle chunks): one chunk, then the
  same command resumed for a second, leaves the checkpoint bitwise equal to
  two chunks in one run; the metrics JSONL and the meta file have the JAX
  tool's keys.
- ``tools/torch_blocked_linalg.py`` against JAX's ``tools/blocked_linalg.py``
  on a seeded SPD batch (n = 64, block 32), within 1e-4 of scale.
- ``tools/torch_reference_loop.py`` bitwise equal to
  ``tools/reference_loop.py`` over 0.1 s (5 MPC solves, 100 MuJoCo ticks):
  both f64 NumPy on host MuJoCo, each with its own package's bridge and
  native oracle (JAX's built into this test's directory: its ``_build``
  writes ``native/build/`` in place, where another test may build at the
  same moment).
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

import blocked_linalg as jax_blx  # noqa: E402
import torch_blocked_linalg as blx  # noqa: E402
import torch_cycle_ablation  # noqa: E402
import torch_long_sweep  # noqa: E402
import torch_solve_ablation  # noqa: E402
import torch_spd_kernel_bench  # noqa: E402

torch.set_num_threads(2)

# tools/cycle_ablation.py's keys
ABLATION_KEYS = {"pre_ms", "refgen_ms", "qpbuild_ms", "solve_xla_twin_ms", "solve_ms",
                 "solve_iters_mean", "ticks_ms", "full_ms", "legobs_plus_step_ms_per_cycle",
                 "legobs_ms_per_cycle", "torques_ms_per_cycle", "chol_solve_ms_per_cycle",
                 "batch", "reps", "backend", "solves_per_s_full"}
# tools/long_sweep.py's metrics and meta keys
SWEEP_KEYS = {"chunk", "sim_s", "upright_frac", "height_mean", "vx_err_mean", "wall_s",
              "solves_per_s"}
META_KEYS = {"batch", "seed", "chunks_done", "chunk_cycles", "solver_iters", "adaptive"}


def test_cycle_ablation_cpu(capsys):
    from convex_mpc_tpu_torch.mpc import kernels

    wrapper = kernels.admm_iterations_structured
    res = torch_cycle_ablation.main(["--cpu", "--batch", "2", "--reps", "1"])
    assert kernels.admm_iterations_structured is wrapper
    line = json.loads(next(l for l in capsys.readouterr().out.splitlines() if l.startswith("{")))
    assert ABLATION_KEYS <= set(line) and line["backend"] == "cpu" and line["batch"] == 2
    for k in ABLATION_KEYS - {"batch", "reps", "backend"}:
        assert math.isfinite(line[k]) and line[k] > 0, k
    assert set(line["routes"]) == {"solve_ms", "solve_xla_twin_ms"}
    assert res["launches"] == {n: 0 for n in res["launches"]}


def test_solve_ablation_cpu(capsys):
    from convex_mpc_tpu_torch.mpc import admm

    res = torch_solve_ablation.main(["--cpu", "--batch", "2", "--reps", "1"])
    assert admm.SEGMENTS == 4
    out = capsys.readouterr().out
    keys = ["build_condensed"] + [f"solve segs={s} iters={i}" for s, its in
                                  ((1, (4, 152, 400)), (2, (8, 152, 400)), (4, (16, 152, 400)))
                                  for i in its]
    assert list(res)[:len(keys)] == keys
    assert all(math.isfinite(res[k]) and res[k] > 0 for k in keys)
    assert "per-refactorization (setup):" in out and "per-iteration:" in out
    assert math.isfinite(res["per_iteration"])


def test_spd_kernel_bench_cpu():
    rows = torch_spd_kernel_bench.main(["--cpu", "--batch", "3", "--n", "32", "64", "--reps", "2"])
    assert [(r["n"], r["route"]) for r in rows] == [
        (n, route) for n in (32, 64) for route in ("spd_inverse", "cholesky_ex+cholesky_inverse")]
    assert all(r["ms_per_call"] > 0 and r["max_resid"] < 1e-4 for r in rows)


def test_long_sweep_resume_is_bitwise(tmp_path):
    def run(out, seconds):
        return torch_long_sweep.main(["--cpu", "--batch", "4", "--chunk-cycles", "2",
                                      "--seconds", str(seconds), "--out", str(out)])

    first = run(tmp_path / "a" / "sweep", 0.04)
    resumed = run(tmp_path / "a" / "sweep", 0.08)
    whole = run(tmp_path / "b" / "sweep", 0.08)
    assert (first["start_chunk"], first["total_chunks"]) == (0, 1)
    assert (resumed["start_chunk"], resumed["total_chunks"]) == (1, 2)
    assert whole["start_chunk"] == 0
    a, b = np.load(tmp_path / "a" / "sweep.npz"), np.load(tmp_path / "b" / "sweep.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 20
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    jsonl = (tmp_path / "a" / "sweep.metrics.jsonl").read_text()
    recs = [json.loads(l) for l in jsonl.splitlines()]
    assert [r["chunk"] for r in recs] == [1, 2] and all(set(r) == SWEEP_KEYS for r in recs)
    meta = json.loads((tmp_path / "a" / "sweep.meta.json").read_text())
    assert set(meta) == META_KEYS and meta["chunks_done"] == 2 and meta["adaptive"] is False


def test_blocked_linalg_matches_jax():
    rng = np.random.default_rng(7)
    G = rng.standard_normal((3, 64, 64)).astype(np.float32)
    M = (G @ G.transpose(0, 2, 1) / 64 + 2.0 * np.eye(64, dtype=np.float32)).astype(np.float32)
    Lj = np.asarray(jax_blx.blocked_cholesky(jnp.asarray(M), block=32))
    Lt = blx.blocked_cholesky(torch.as_tensor(M), block=32).numpy()
    assert np.abs(Lt - Lj).max() <= 1e-4 * np.abs(Lj).max()
    assert np.abs(np.triu(Lt, 1)).max() == 0.0
    Xj = np.asarray(jax_blx.blocked_tri_inverse(jnp.asarray(Lj), block=32))
    Xt = blx.blocked_tri_inverse(torch.as_tensor(Lj), block=32).numpy()
    assert np.abs(Xt - Xj).max() <= 1e-4 * np.abs(Xj).max()
    with pytest.raises(ValueError):
        blx.blocked_cholesky(torch.as_tensor(M), block=48)


def test_reference_loop_bitwise_equal_to_jax(tmp_path, monkeypatch):
    pytest.importorskip("mujoco")
    import reference_loop
    import torch_reference_loop
    from convex_mpc_tpu.utils import native_oracle as JNO

    monkeypatch.setattr(JNO, "_BUILD_DIR", tmp_path / "jax_native")
    monkeypatch.setattr(JNO, "_SO_PATH", tmp_path / "jax_native" / "libqp_solver.so")
    monkeypatch.setattr(JNO, "_lib", None)
    for tool, name in ((reference_loop, "jax"), (torch_reference_loop, "port")):
        monkeypatch.setattr(sys, "argv", [name, "--seconds", "0.1",
                                          "--save", str(tmp_path / f"{name}.npz")])
        with pytest.raises(SystemExit) as exc:
            tool.main()
        assert exc.value.code == 0  # upright
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == ["force", "kkt", "q", "tau", "x"] and a["x"].shape == (100, 12)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
