"""The snapped-window rate, the p90 and the spread on made-up numbers."""
import statistics

import pytest

from plexbench import stats


def test_snapped_rate_counts_work_after_the_first_completion():
    # completions at 1, 2, 4 s: the first only opens the interval
    done = [(2.0, 100), (1.0, 50), (4.0, 300)]
    assert stats.snapped_rate(done) == pytest.approx((100 + 300) / 3.0)


def test_snapped_rate_needs_two_completions():
    assert stats.snapped_rate([]) is None
    assert stats.snapped_rate([(1.0, 5)]) is None
    assert stats.snapped_rate([(1.0, 5), (1.0, 5)]) is None


def test_snapped_rate_counts_zero_work_ops_as_edges():
    # forwards (0 tokens) still open and close the window
    done = [(0.5, 0), (1.5, 1000), (2.5, 0)]
    assert stats.snapped_rate(done) == pytest.approx(1000 / 2.0)


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.9, 9.1),
    ([3.0], 0.9, 3.0),
    ([1, 2], 0.9, 1.9),
    (list(range(101)), 0.9, 90.0),
])
def test_percentile_interpolates_between_ranks(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_percentile_matches_statistics_inclusive():
    vals = [0.31, 1.2, 0.9, 2.4, 0.75, 1.1, 3.3, 0.2, 1.7, 0.6, 2.2]
    want = statistics.quantiles(vals, n=10, method="inclusive")[8]
    assert stats.percentile(vals, 0.9) == pytest.approx(want)


def test_percentile_of_a_failed_op_is_infinite():
    assert stats.percentile([1.0] * 9 + [float("inf")] * 2, 0.9) == \
        float("inf")


def test_spread_is_iqr_over_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def _switch(t_off, t_load, nbytes):
    return {"t_offload": t_off, "t_load": t_load, "offload_bytes": nbytes,
            "load_bytes": nbytes}


def test_switch_mean_counts_only_changes_of_job():
    from types import SimpleNamespace
    from plexbench import readers
    # the router also logs ops whose job was resident: nothing moved
    rec = SimpleNamespace(switches=[_switch(0.1, 0.1, 5), _switch(0, 3e-5, 0),
                                    _switch(0.2, 0.2, 5)])
    assert readers.mean_switch(rec) == pytest.approx(0.3)
    assert len(readers.transitions(rec)) == 2
    assert readers.mean_switch(SimpleNamespace(
        switches=[_switch(0, 3e-5, 0)])) is None
