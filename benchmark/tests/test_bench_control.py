"""The control on the card: the reference computed in float32 with TF32
matmuls, in the system's place, fails the cell's limits where the system
passes them (a few scenarios and a short window; the readings at the cells'
own sizes are in PERF.md)."""

from __future__ import annotations

import time

import pytest

from benchmark import check, control, harness

from conftest import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["h16_sweep1k.fused", "h32_trot1280.fused"])
def test_control_fails_where_the_system_passes(name, cuda_device):
    cell = small_cell(name, batch=32, check_rows=8)
    kept = {}
    res = harness.run_cell(cell, 2**31 + 5, 2.0, False, cuda_device, time.perf_counter(),
                           keep=kept)
    assert res["correct"] is True
    nums = check.numbers(control.control_readings(cell.config, kept))
    assert any(v > cell.limits[k] for k, v in nums.items())
