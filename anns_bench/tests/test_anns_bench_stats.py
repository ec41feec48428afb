"""stats.py: percentiles over all requests, each timed from when it was
due; busy and idle time from device intervals."""
from __future__ import annotations

import conftest  # noqa: F401  (paths)
import numpy as np
import pytest

from anns_bench import stats


def test_percentile_is_over_every_request():
    rng = np.random.default_rng(3)
    v = rng.exponential(size=1001)
    for q in (50, 95, 99, 99.9):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_latency_runs_from_the_due_time():
    # the third request was due at 1.0 but the generator only sent it at
    # 1.5 (late): its latency still starts at 1.0
    due = [0.0, 0.5, 1.0]
    done = [0.2, 0.9, 1.8]
    lat = stats.request_latencies(due, done)
    assert lat == pytest.approx([0.2, 0.4, 0.8])
    assert stats.percentile(lat, 100) == pytest.approx(0.8)
    with pytest.raises(ValueError):
        stats.request_latencies([0.0], [])


def test_busy_and_idle():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.merge_intervals(spans) == [(0.0, 2.0), (3.0, 4.0),
                                            (9.0, 12.0)]
    assert stats.busy_time(spans, (1.0, 10.0)) == pytest.approx(3.0)
    assert stats.idle_gaps(spans, (1.0, 10.0)) == [(2.0, 3.0), (4.0, 9.0)]
