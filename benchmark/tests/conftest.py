"""Shared fixtures of the benchmark's tests: a cell cut down to a few
scenarios for the CPU, and the card for the tests marked ``cuda``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, batch: int = 3, **traffic):
    """The cell ``name`` with ``batch`` scenarios, one warm-up cycle, and
    every cycle of a short window judged."""
    from benchmark import harness

    cell = harness.load_cell(name)
    cell.traffic = {**cell.traffic, "batch": batch, "check_rows": min(2, batch), "check_span": 2,
                    "check_cycles": 2, "warmup_cycles": 1, "profiled_cycles": 1, **traffic}
    return cell


def scenarios(cell, seed: int) -> dict:
    """The cell's scenarios for ``seed``, among its configuration's gaits."""
    from benchmark import harness, traffic

    return traffic.scenarios(cell.traffic, seed, list(harness.config_gaits(cell.config)))


def follow(cell, seed: int = 11, cycles: int = 3):
    """The frozen reference against the system's plain CPU path over
    ``cycles`` cycles of every scenario of ``cell``: the first from the
    reference's own start, then from the system's state; the QP, the forces
    against the QP's optimum, the plant after the ticks and the carried
    state."""
    import numpy as np

    from benchmark import check, harness
    from benchmark.reference import cycle as RC

    sc = scenarios(cell, seed)
    dev = torch.device("cpu")
    prog = harness.Program(cell.config, cell.traffic, sc, dev)
    rows = torch.arange(cell.traffic["batch"])
    setting = harness.reference_setting(cell.config, sc, dev)
    start = RC.init_state(setting, sc["x_offset"].astype(np.float32).astype(np.float64))
    cap = check.Capture(rows)
    solve = prog.admm.solve_adaptive
    prog.admm.solve_adaptive = cap.wrap(solve)
    try:
        for i in range(cycles):
            s_in = check.state_rows(prog.state, rows)
            cap.armed = True
            prog.cycle()
            cap.armed = False
            gaps = check.stage_gaps(setting, start if i == 0 else s_in, cap.qp,
                                    check.state_rows(prog.state, rows))
            assert gaps["qp_gap"].max() < 1e-5  # f32 assembly against float64
            assert gaps["u0_gap"].max() < 0.02  # the force-parity budget, 2% of m g
            assert gaps["plant_gap"].max() < 1e-4 and gaps["carry_gap"].max() < 1e-4
    finally:
        prog.admm.solve_adaptive = solve


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
