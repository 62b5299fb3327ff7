"""The metric arithmetic on hand-worked cases."""

import statistics

import pytest

from cardbench.harness import roofline, stats


def test_rate_over_the_window():
    assert stats.rate(5000 * 10, 2.0) == 25000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p90_over_all_runs():
    runs = [float(i) for i in range(1, 101)]  # 1 .. 100
    assert stats.percentile(runs, 90) == pytest.approx(90.1)
    assert stats.percentile([0.3], 90) == 0.3
    # A single slow run moves the tail of all runs.
    assert stats.percentile([1.0] * 9 + [3.0], 90) == pytest.approx(1.2)


def test_spread_is_the_quartiles_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_union_and_gaps_of_intervals():
    merged = stats.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 20)],
                         clip=(0, 15))
    assert merged == [(0, 3), (5, 9), (12, 15)]
    assert stats.covered(merged) == 10
    assert stats.gaps(merged, (0, 15)) == [(3, 5), (9, 12)]
    assert stats.gaps([], (2, 4)) == [(2, 4)]


def test_b2_work_counts_state_once_and_every_iterations_gathers():
    # 4 planes x 1000 candidates, 10 iterations.
    b, f = roofline.b2_work(4, 1000, 10, fit_bytes=80)
    state = 3 * 4 * 1000 * 4 + 2 * 1000 * 4 + 80
    assert b == state + 10 * 4 * 1000 * 4
    assert f == 10 * 4 * 4 * 1000
    b1, _ = roofline.b2_work(4, 1000, 1)
    assert b1 == 3 * 4 * 1000 * 4 + 2 * 1000 * 4 + 16000


def test_b1_linear_work_counts_each_iteration():
    b, f = roofline.b1_linear_work(8, 2048, 2048, 3)
    assert b == 3 * (3 * 8 + 1) * 2048 * 2048 * 4
    assert f == 3 * (4 * 8 + 1) * 2048 * 2048


def test_bound_takes_the_larger_time():
    t, what = roofline.bound_s(3.35e12, 0.0, "NVIDIA H100 80GB HBM3")
    assert (t, what) == (1.0, "bytes")
    t, what = roofline.bound_s(0.0, 134e12, "an unknown card")
    assert (t, what) == (2.0, "operations")
