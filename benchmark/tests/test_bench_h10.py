"""The horizon-10 cell ``h10_sweep10k.fused``: its files found by name, the
reference following the system's plain CPU path at horizon 10, and the
reader of kernel 1's pad (``spd_padded_rows``) on the program's counters,
silent on a program without them."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness, spans

from conftest import scenarios, small_cell

CELL = "h10_sweep10k.fused"
PER_LAYER = ("update_ms", "solve_ms", "apply_ms", "solve_iters", "launches_per_cycle",
             "device_idle_pct", "spd_inverse_roofline", "admm_structured_roofline",
             "tick_window_roofline", "kkt_factorizations", "kkt_rows", "polish_solves",
             "host_reads", "solve_idle_ms", "update_idle_ms", "spd_padded_rows")


def test_cell_loads_with_its_files():
    c = harness.load_cell(CELL)
    assert c.chips == 1
    cfg = c.config
    assert (cfg["name"], cfg["horizon"], cfg["qp_variables"], cfg["qp_rows"]) == (
        "go2_trot_h10", 10, 120, 280)
    (g,) = cfg["gaits"]
    assert g["mpc_dt"] == pytest.approx(g["gait_period"] / 10, rel=1e-15)
    assert harness.engine_kwargs(cfg)["n"] == 10
    tr = c.traffic
    assert tr["batch"] == 10240 and tr["fused_ticks"] is True and tr["set_seed"] == 20261017
    assert (tr["check_rows"], tr["check_cycles"], tr["check_span"], tr["profiled_cycles"],
            tr["warmup_cycles"]) == (32, 3, 16, 3, 2)
    sweep = harness.load_cell("h16_sweep1k.fused")
    for k in ("vx", "vy", "wz", "kn", "dn", "mu", "x_offset"):  # config 3's draws
        assert tr[k] == sweep.traffic[k], k
    assert set(c.limits) == set(check.NUMBERS)
    assert all(c.limits[k] <= sweep.limits[k] for k in check.NUMBERS)  # no looser
    assert {m["name"] for m in c.end_to_end} == {"solves_per_s", "setup_s"}
    assert sorted(m["name"] for m in c.per_layer) == sorted(f"{n}.h10" for n in PER_LAYER)
    layers = {m["name"]: m["layer"] for m in c.per_layer}
    assert layers["spd_padded_rows.h10"] == layers["spd_inverse_roofline.h10"]
    for m in c.per_layer:
        assert m["moves"] == "solves_per_s" and m["workloads"] == [CELL]
        assert callable(harness.load_metric(c.metrics_dir, m["name"]).read)
    sc = scenarios(c, 2**31 + 5)
    assert sc["vx"].shape == (10240,) and -0.3 <= sc["vx"].min() < sc["vx"].max() <= 0.8


def test_reference_follows_the_system_at_horizon_10():
    """One judged cycle at B = 4 from the reference's own start: the QP, the
    forces against the QP's optimum and the plant after the ticks."""
    cell = small_cell(CELL, batch=4)
    sc = scenarios(cell, 2**31 + 13)
    dev = torch.device("cpu")
    prog = harness.Program(cell.config, cell.traffic, sc, dev)
    rows = torch.arange(4)
    setting = harness.reference_setting(cell.config, sc, dev)
    from benchmark.reference import cycle as RC

    start = RC.init_state(setting, sc["x_offset"].astype(np.float32).astype(np.float64))
    cap = check.Capture(rows)
    solve = prog.admm.solve_adaptive
    prog.admm.solve_adaptive = cap.wrap(solve)
    try:
        cap.armed = True
        prog.cycle()
        cap.armed = False
    finally:
        prog.admm.solve_adaptive = solve
    assert cap.qp["p_dense"].shape == (4, 120, 120)
    gaps = check.stage_gaps(setting, start, cap.qp, check.state_rows(prog.state, rows))
    assert gaps["qp_gap"].max() < 1e-5  # f32 assembly against float64
    assert gaps["u0_gap"].max() < 0.02  # the force-parity budget, 2% of m g
    assert gaps["plant_gap"].max() < 1e-4 and gaps["carry_gap"].max() < 1e-4


def test_traced_cpu_run_reads_the_pad():
    """A traced run at B = 2 on the CPU: correct, and the pad's reader gives
    every matrix kernel 1 inverts (factorizations' rows and polish rows) at
    n = 120 on the grid of 128, the pad 17.6% of the operations."""
    res = harness.run_cell(small_cell(CELL, batch=2), 2**31 + 29, 1.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True
    m = res["metrics"]
    pad = m["spd_padded_rows.h10"]
    rows = m["kkt_rows.h10"]["value"] + m["polish_solves.h10"]["rows"]
    assert pad["value"] == pytest.approx(rows) and pad["value"] > 0
    assert pad["pad_ops_pct"] == pytest.approx(100 * (128 ** 3 - 120 ** 3) / 128 ** 3)
    assert "spd_inverse_roofline.h10" not in m  # no device trace on the CPU


def test_pad_reader_silent_without_the_counters(monkeypatch):
    reader = harness.load_metric(harness.HERE / "metrics", "spd_padded_rows.h10")
    ctx = SimpleNamespace(trace=None, counters={})
    monkeypatch.setattr(spans, "profiling", SimpleNamespace())  # no counters at all
    assert reader.read(ctx) is None
    # counters, but none of the pad's (a program before it, or no pad)
    monkeypatch.setattr(spans, "profiling", SimpleNamespace(
        counts=lambda: {"cycles": 2, "kkt_factorizations": 6}))
    assert reader.read(ctx) is None
    monkeypatch.setattr(spans, "profiling", SimpleNamespace(counts=lambda: {
        "cycles": 2, "spd_inverse.padded": 10, "spd_inverse.ops": 30, "spd_inverse.pad_ops": 10}))
    assert reader.read(ctx) == {"value": 5.0, "pad_ops_pct": 25.0}
