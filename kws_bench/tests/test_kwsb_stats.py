"""The arithmetic of the end-to-end metrics."""

import pytest

from kws_bench import stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(384 * 500, 10.0) == 19200.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_step():
    steps = [10.0] * 95 + [50.0] * 5
    assert stats.p95(steps) == 10.0        # the 95th of 100 by rank
    assert stats.p95(steps + [50.0]) == 50.0
    assert stats.p95([3.0]) == 3.0
    assert stats.p95(list(range(1, 21))) == 19


def test_host_record_reads_the_window():
    from kws_bench import harness

    before = {"cpu_s": 1.0, "voluntary": 5, "involuntary": 2,
              "python_s": 0.004, "clock": 10.0}
    after = {"cpu_s": 3.0, "voluntary": 9, "involuntary": 7,
             "python_s": 0.005, "clock": 12.0}
    got = harness.host_record(before, after, [10.0, 11.0, 12.0, 13.0, 14.0])
    assert got["cpu_per_s"] == pytest.approx(1.0)
    assert got["switches"] == [4, 5]
    assert got["python_s"] == [0.004, 0.005]
    q1, q2, q3 = got["step_ms_quartiles"]
    assert q2 == 12.0 and got["step_spread"] == pytest.approx((q3 - q1) / 12)
