"""roofline.py's counts against hand-worked K1, B2 and K23 calls."""
from __future__ import annotations

import conftest  # noqa: F401  (paths)
import pytest

from anns_bench import roofline


def test_k1_by_hand():
    # 2 queries, 3 live probes over 2 distinct clusters of L=2 rows, D=4
    w = roofline.k1_call(batch=2, probes=3, union=2, width=4, cluster_len=2,
                         dim=4, k2=3)
    # a cluster: codes 2*4, norms and ids 2*(4+4), centroid 4*4, scale 4
    assert w.bytes == 2 * 44 + 2 * 4 * 4 + 2 * 4 * 5 + 2 * 3 * 8 == 208
    # a probe: ||q-c||^2 3*4, then per row a dot 2*4 and a combine 4
    assert w.ops == 3 * (12 + 2 * 12) == 108


def test_b2_by_hand():
    w = roofline.b2_call(batch=2, probes=3, union=2, width=4, cluster_len=2,
                         dim=4, k2=3)
    # a cluster: 2*4 floats and 2 ids
    assert w.bytes == 2 * 40 + 32 + 40 + 48 == 200
    # probe rows 3*2*(2*4+3), union row norms 2*2*8, query norms 2*8
    assert w.ops == 66 + 32 + 16 == 114


def test_k23_by_hand():
    w = roofline.k23_call(sizes=[3, 5], ks=[2, 1], dim=4, iters=2)
    assert w.bytes == 128 + 32 + 128 + 16 + 64 + 512 + 128 == 1008
    # per iteration: 3 points x 2 centroids and 5 x 1, 2*4 each, plus sums
    assert w.ops == 2 * (3 * (2 * 4 * 2 + 4) + 5 * (2 * 4 + 4)) == 240


def test_bound_and_share():
    w = roofline.Work(ops=67e12, bytes=1.0)
    assert w.bound_s() == pytest.approx(1.0)
    assert w.bound_by() == "operations"
    w = roofline.Work(ops=1.0, bytes=3.35e12)
    assert w.bound_by() == "bytes"
    assert roofline.share_pct(w, 2.0) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        roofline.share_pct(w, 0.0)
