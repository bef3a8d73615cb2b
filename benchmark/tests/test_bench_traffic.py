"""The traffic generator: the same seed gives the same scenarios, and every
seed the same set of them in its own order."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, traffic

SEEDS = (0, 7, 2**31 + 12345, 3 * 2**31)
TROT = ["trot"]  # the gait of the accepted cells' configurations


@pytest.mark.parametrize("cell", ["h16_sweep1k.fused", "h32_trot1280.fused"])
def test_same_seed_same_scenarios(cell):
    tr = harness.load_cell(cell).traffic
    for seed in SEEDS:
        a, b = traffic.scenarios(tr, seed, TROT), traffic.scenarios(tr, seed, TROT)
        assert all(np.array_equal(a[k], b[k]) for k in traffic.PARAMS)
        assert traffic.check_plan(tr, seed) == traffic.check_plan(tr, seed)


def test_every_seed_the_same_set():
    tr = harness.load_cell("h16_sweep1k.fused").traffic
    a, b = traffic.scenarios(tr, SEEDS[0], TROT), traffic.scenarios(tr, SEEDS[2], TROT)
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
    sc = traffic.scenarios(tr, 3, TROT)
    assert np.allclose(np.sort(sc["x_offset"]), np.linspace(-0.02, 0.02, tr["batch"]))
    assert (sc["vx"] == 0.5).all() and (sc["kn"] == 30000.0).all()


def test_gait_shares():
    """Shares give round(share x batch) scenarios of each gait, the same set
    for every seed in the seed's own order; a traffic may name only the
    configuration's gaits, and where it names none, the configuration has
    one."""
    tr = dict(harness.load_cell("h32_trot1280.fused").traffic,
              gait={"shares": {"trot": 0.5, "bound": 0.25, "pace": 0.25}})
    names = ["trot", "bound", "pace"]
    a, b = (traffic.scenarios(tr, s, names)["gait"] for s in SEEDS[:2])
    assert {n: int((a == n).sum()) for n in names} == {"trot": 640, "bound": 320, "pace": 320}
    assert np.array_equal(np.sort(a), np.sort(b)) and not np.array_equal(a, b)
    assert (traffic.scenarios(dict(tr, gait="pace"), 3, names)["gait"] == "pace").all()
    with pytest.raises(ValueError, match="lacks"):
        traffic.scenarios(tr, 3, TROT)
    with pytest.raises(ValueError, match="names no gait"):
        traffic.scenarios(harness.load_cell("h32_trot1280.fused").traffic, 3, names)
    with pytest.raises(ValueError, match="scenarios"):
        traffic.scenarios(dict(tr, gait={"shares": {"trot": 0.5}}), 3, names)
