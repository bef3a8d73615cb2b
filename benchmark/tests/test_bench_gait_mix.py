"""The cell ``h16_mix10k.config5``: BASELINE config 5's five horizon-16 gaits
(three periods, so three MPC steps) in one batch, run by the port with a (B,)
step and judged against the float64 reference at the cell's own limits; a
program handed one step for every scenario is caught; and the two readers
that only this cell feeds, ``per_row_step`` and ``gait_iters_spread``."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness, spans

from conftest import ROOT, small_cell

CPU = torch.device("cpu")
MIX = "h16_mix10k.config5"


def config5_mix(**traffic):
    """The cell ``h16_mix10k.config5`` cut to ten scenarios, two of each of
    config 5's five horizon-16 gaits, every one judged, at the cell's own
    limits."""
    return small_cell(MIX, batch=10, check_rows=10, **traffic)


def reader(name):
    return harness.load_metric(harness.HERE / "metrics", name)


def test_config5_mix_is_correct():
    """Five gaits of three periods (three MPC steps) in one batch, run by
    the port with a (B,) step, judged against the float64 reference."""
    cell = config5_mix()
    assert cell.limits == harness.load_json(ROOT / f"benchmark/limits/{MIX}.json")
    kept = {}
    res = harness.run_cell(cell, 2**31 + 103, 1.0, False, CPU, time.perf_counter(), keep=kept)
    names = kept["scenarios"]["gait"]
    assert sorted(set(names.tolist())) == ["bound", "pace", "trot", "trot_fast", "trot_slow"]
    assert all((names == g).sum() == 2 for g in set(names.tolist()))
    assert torch.is_tensor(kept["setting"].mpc_dt)
    assert res["correct"] is True, res["checks"]


def test_one_step_for_the_config5_mix_is_not_correct():
    """The program handed the first gait's step as a float for every
    scenario: the QPs of the other periods' scenarios differ."""
    cell = config5_mix()
    step = next(iter(harness.config_gaits(cell.config).values()))["mpc_dt"]

    def fault(prog):
        assert torch.is_tensor(prog.kw["mpc_dt"])
        prog.kw = {**prog.kw, "mpc_dt": step}

    res = harness.run_cell(cell, 2**31 + 103, 1.0, False, CPU, time.perf_counter(), faults=fault)
    assert res["correct"] is False
    c = res["checks"]["qp_gap"]
    assert c["value"] > c["limit"]


def test_per_row_step_reads_the_counter(monkeypatch):
    """``mpc_dt_rows`` a cycle; nothing where the program does not count it
    (one step for the batch, or an older program)."""
    got = {"cycles": 3, "mpc_dt_rows": 3 * 10240, "kkt_rows": 7}
    monkeypatch.setattr(spans, "profiling", SimpleNamespace(counts=lambda: dict(got)))
    ctx = SimpleNamespace(trace=None, counters={})
    assert reader("per_row_step.mix").read(ctx) == 10240
    del got["mpc_dt_rows"]
    assert reader("per_row_step.mix").read(ctx) is None
    monkeypatch.setattr(spans, "profiling", SimpleNamespace())
    assert reader("per_row_step.mix").read(ctx) is None


def test_gait_iters_spread_by_gait():
    """Two gaits: bound's scenarios take 150 and 250 iterations over two
    cycles, trot's 100: a spread of 2, and each gait's mean."""
    gaits = np.array(["trot", "bound", "trot", "bound"])
    iters = np.array([[100, 150, 100, 250], [100, 250, 100, 150]])
    out = reader("gait_iters_spread.mix").read(SimpleNamespace(iters=iters, gaits=gaits))
    assert out == {"value": 2.0, "iters.bound": 200.0, "iters.trot": 100.0}
    one = reader("gait_iters_spread").read(SimpleNamespace(iters=iters, gaits=np.full(4, "t")))
    assert one == {"value": 1.0, "iters.t": 150.0}
    assert reader("gait_iters_spread").read(
        SimpleNamespace(iters=np.zeros((0, 4)), gaits=gaits)) is None


def test_traced_mix_run_reports_the_gait_metrics():
    """The gait mix cut to five scenarios, one of each gait, traced on the
    CPU: every scenario counted on its own step, a spread of at least 1."""
    res = harness.run_cell(small_cell(MIX, batch=5), 2**31 + 92, 1.0, True, CPU,
                           time.perf_counter())
    assert res["correct"] is True
    m = res["metrics"]
    assert m["per_row_step.mix"]["value"] == 5
    spread = m["gait_iters_spread.mix"]
    assert spread["value"] >= 1.0
    assert sorted(spread) == ["iters.bound", "iters.pace", "iters.trot", "iters.trot_fast",
                              "iters.trot_slow", "unit", "value"]
    for name in ("update_ms.mix", "solve_ms.mix", "solve_iters.mix", "kkt_rows.mix"):
        assert m[name]["value"] > 0, name
