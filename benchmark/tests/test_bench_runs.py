"""A whole run at a few scenarios on the CPU: the result line's shape, the
command's refusal without a card, the import guard, and ``correct`` coming
out false when the timed path is broken underneath."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

from conftest import ROOT, small_cell

CPU = torch.device("cpu")


def run(cell, faults=None, traced=False, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 1.0, traced, CPU, time.perf_counter(), faults=faults)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    res = run(small_cell("h16_sweep1k.fused", batch=2), traced=traced)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    names = set(res["metrics"])
    if traced:
        assert {"update_ms.batch", "solve_ms.batch", "apply_ms.batch", "solve_iters.batch"} <= names
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {"solves_per_s", "setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def _state_unchanged(prog):
    real = prog.E.mpc_cycle_batch

    def step(dyn, gait, contact, sched, state, **kw):
        _, log = real(dyn, gait, contact, sched, state, **kw)
        return state, log

    prog.E = SimpleNamespace(mpc_cycle_batch=step)


def _forces_altered(prog, rows=slice(None), scale=1.25):
    solve = prog.admm.solve_adaptive

    def altered(qp, *args, **kwargs):
        sol = solve(qp, *args, **kwargs)
        x = sol.x.clone()
        x[rows, :12] *= scale
        return sol._replace(x=x, state=sol.state._replace(x=x))

    prog.admm.solve_adaptive = altered  # the run puts the original back


@pytest.mark.parametrize("fault,caught_by", [(_state_unchanged, "plant_over_tol"),
                                              (_forces_altered, "u0_over_2pct")])
def test_broken_path_is_not_correct(fault, caught_by):
    res = run(small_cell("h16_sweep1k.fused", batch=1), faults=fault)
    assert res["correct"] is False
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("name,scale", [("altered", 1.25), ("left_out", 0.0)])
def test_half_the_batch_broken_is_not_correct(name, scale):
    """Every other scenario's forces altered (or left out, as zero) where the
    solve returns them, the rest sound: the share over the budget sees it."""
    def fault(prog):
        _forces_altered(prog, rows=slice(1, None, 2), scale=scale)

    res = run(small_cell("h16_sweep1k.fused", batch=16, check_rows=16), faults=fault)
    assert res["correct"] is False
    c = res["checks"]["u0_over_2pct"]
    assert c["value"] > c["limit"]
    assert all(c["value"] <= c["limit"] for k, c in res["checks"].items()
               if k != "u0_over_2pct")


def test_guard_finds_nothing():
    assert [b for b in harness.banned_imports() if ":" in b] == []
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from benchmark import harness, control; import benchmark.reference.cycle; "
         "print([m for m in sys.modules if m.split('.')[0] in harness.BANNED])"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def _cli(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "h32_trot1280.fused",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_system(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_judged_cycle_past_the_window_runs_late():
    """A window too short to reach a drawn cycle still judges it, after the
    window, and counts only the window's cycles as attempted."""
    cell = small_cell("h16_sweep1k.fused", batch=2, check_span=3, check_cycles=3)
    res = harness.run_cell(cell, 2**31 + 78, 0.0, False, CPU, time.perf_counter())
    assert res["device"]["cycles_in_window"] == 1 and res["attempted"] == 2
    assert res["device"]["judged_cycles"] == 3 and res["correct"] is True
