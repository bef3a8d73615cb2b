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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
