"""Each roofline count against a figure worked by hand at one shape."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_bound_picks_the_larger():
    assert roofline.bound(3.35e9, 0.0) == pytest.approx((1e-3, "bytes"))
    assert roofline.bound(0.0, 67e9) == pytest.approx((1e-3, "operations"))
    assert roofline.bound(3.35e9, 2 * 67e9)[1] == "operations"


def test_spd_inverse_n192_b512():
    # 2 * 512 * 192^2 * 4 B; 512 * 192^3 operations -> 54.09 us, operations-bound
    b, f = roofline.spd_inverse_work(192, 512)
    assert (b, f) == (150_994_944.0, 3_623_878_656.0)
    t, by = roofline.bound(b, f)
    assert by == "operations" and t == pytest.approx(54.088e-6, rel=1e-4)


def test_admm_structured_nb64_b512_25_iterations():
    # in 4 * 512 * (768 + 36,864 + 576 + 2,240) B, out 4 * 512 * (192 + 896) B;
    # 512 * 25 * (73,728 + 1,920 + 1,536 + 192 + 5,376) operations -> 25.39 us, bytes
    b, f = roofline.admm_structured_work(512, 192, 25)
    assert (b, f) == (85_065_728.0, 1_059_225_600.0)
    t, by = roofline.bound(b, f)
    assert by == "bytes" and t == pytest.approx(25.393e-6, rel=1e-4)


def test_tick_window_all_stance_b512():
    # 14,824 * 512 * 20 + 12 * 512 + 15 * 512 * 20 * 4 operations;
    # 4 * 512 * (78 + 35 + 78 + 71 * 20) + 4 * 220 bytes
    b, f = roofline.tick_window_work(512, 20, (0, 0), 0, 0, 0)
    assert (b, f) == (3_300_208.0, 152_418_304.0)
    # one swing leg-tick adds its trajectory and the stance term it replaces
    _, f1 = roofline.tick_window_work(512, 20, (1, 1), 0, 0, 0)
    assert f1 - f == 777 + 1452 - 15
