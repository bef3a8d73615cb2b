"""The traffic generator: the same seed gives the same scenarios, and every
seed the same set of them in its own order."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, traffic

SEEDS = (0, 7, 2**31 + 12345, 3 * 2**31)


@pytest.mark.parametrize("cell", ["h16_sweep1k.fused", "h32_trot1280.fused"])
def test_same_seed_same_scenarios(cell):
    tr = harness.load_cell(cell).traffic
    for seed in SEEDS:
        a, b = traffic.scenarios(tr, seed), traffic.scenarios(tr, seed)
        assert all(np.array_equal(a[k], b[k]) for k in traffic.PARAMS)
        assert traffic.check_plan(tr, seed) == traffic.check_plan(tr, seed)


def test_every_seed_the_same_set():
    tr = harness.load_cell("h16_sweep1k.fused").traffic
    a, b = traffic.scenarios(tr, SEEDS[0]), traffic.scenarios(tr, SEEDS[2])
    for k in traffic.PARAMS:
        assert np.array_equal(np.sort(a[k]), np.sort(b[k]))
    assert not np.array_equal(a["vx"], b["vx"])
    lo, hi = tr["vx"]["uniform"]
    assert a["vx"].min() >= lo and a["vx"].max() <= hi and len(a["vx"]) == tr["batch"]


def test_check_plan_within_the_batch():
    tr = harness.load_cell("h32_trot1280.fused").traffic
    rows, cycles = traffic.check_plan(tr, SEEDS[3])
    assert len(set(rows)) == tr["check_rows"] and max(rows) < tr["batch"]
    assert len(set(cycles)) == tr["check_cycles"] and max(cycles) < tr["check_span"]
    assert traffic.check_plan(tr, SEEDS[0]) != traffic.check_plan(tr, SEEDS[1])


def test_linspace_and_constants():
    tr = harness.load_cell("h32_trot1280.fused").traffic
    sc = traffic.scenarios(tr, 3)
    assert np.allclose(np.sort(sc["x_offset"]), np.linspace(-0.02, 0.02, tr["batch"]))
    assert (sc["vx"] == 0.5).all() and (sc["kn"] == 30000.0).all()
