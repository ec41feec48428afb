"""The port's elastic pool simulator (``build/elastic.py``'s ``SimPool``
family) and graph baseline (``core/graph_baseline.py``) against the JAX
package: ``tests/test_elastic.py``'s and ``tests/test_search_extras.py``'s
cases on the port, the same reports for the same seeds and inputs, the same
graph up to boundary near-ties and the same traversal on one graph."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch.build.elastic import PoolPolicy, SimNode, SimPool, \
    SimTask  # noqa: E402


def _tasks(n, work=10.0):
    return [SimTask(i, work) for i in range(n)]


def test_sim_pool_finishes_under_preemption():
    nodes = [SimNode(i, preempt_rate=0.4 if i < 3 else 0.0) for i in range(8)]
    rep = SimPool(nodes, PoolPolicy(seed=1)).run(_tasks(50))
    assert len(rep.task_node) == 50
    assert rep.n_preemptions > 0


def test_sim_pool_evicts_flaky_nodes():
    nodes = [SimNode(0, preempt_rate=1.0)] + [SimNode(i) for i in range(1, 4)]
    rep = SimPool(nodes, PoolPolicy(evict_after=2, seed=2)).run(_tasks(20))
    assert rep.n_evictions >= 1
    assert 0 not in set(rep.task_node.values())


def test_sim_pool_scaling_reduces_makespan():
    """Fig. 21b: makespan shrinks as workers grow."""
    makespans = []
    for n_nodes in (1, 4, 16, 64):
        nodes = [SimNode(i) for i in range(n_nodes)]
        rep = SimPool(nodes, PoolPolicy(seed=0)).run(_tasks(128, work=5.0))
        makespans.append(rep.makespan)
    assert makespans == sorted(makespans, reverse=True)
    assert makespans[0] / makespans[-1] > 16


def test_sim_pool_straggler_backup():
    nodes = [SimNode(0, speed=0.02)] + [SimNode(i) for i in range(1, 6)]
    rep = SimPool(nodes, PoolPolicy(straggler_factor=2.0, seed=3)).run(
        _tasks(24, work=8.0))
    assert rep.makespan < 100
    assert rep.n_backups >= 1


def _pool_case(seed):
    """Seeded nodes (preemption, speed) and tasks (work) for a report
    comparison; every fourth case has backups off, every third requeues
    at the back."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    nodes = [(i, float(rng.choice([0.0, 0.1, 0.3, 0.6], p=[.6, .2, .15, .05])),
              float(rng.uniform(0.05, 2.0))) for i in range(n)]
    tasks = [(i, float(rng.uniform(0.5, 20.0)))
             for i in range(int(rng.integers(1, 200)))]
    policy = dict(seed=seed, evict_after=int(rng.integers(0, 6)),
                  straggler_factor=None if seed % 4 == 0 else 2.0,
                  requeue_front=seed % 3 != 0)
    return nodes, tasks, policy


@pytest.mark.parametrize("seed", range(8))
def test_sim_pool_report_equals_reference(seed):
    """The same nodes, tasks and policy give the reference's PoolReport
    field for field (the same draws in the same order)."""
    from repro.build import elastic as ref

    nodes, tasks, policy = _pool_case(seed)
    got = SimPool([SimNode(*n) for n in nodes],
                  PoolPolicy(**policy)).run([SimTask(*t) for t in tasks])
    want = ref.SimPool([ref.SimNode(*n) for n in nodes],
                       ref.PoolPolicy(**policy)).run(
        [ref.SimTask(*t) for t in tasks])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --------------------------------------------------------------------------
# the graph baseline
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graphs(small_corpus):
    """(port graph, reference graph) over the shared small corpus."""
    from repro.core.graph_baseline import build_nsw_graph as jbuild
    from repro_torch.core.graph_baseline import build_nsw_graph

    x, _, _ = small_corpus
    return build_nsw_graph(x, degree=24, device="cpu"), jbuild(x, degree=24)


def test_graph_baseline_recall_and_hops(small_corpus, graphs):
    """tests/test_search_extras.py's gate on the port: recall@10 > 0.7 at
    beam 64, hops > 10, every node keeps its random long links."""
    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.graph_baseline import batch_search
    from repro_torch.core.ivf import brute_force_topk

    x, q, _ = small_corpus
    g, _ = graphs
    deg = (g.neighbors >= 0).sum(1)
    assert deg.min() >= 2
    _, ti = brute_force_topk(torch.from_numpy(x), torch.from_numpy(q[:32]),
                             10)
    ids, st = batch_search(g, q[:32], 10, beam=64)
    assert recall_at_k(ids, ti.numpy()) > 0.7
    assert st.hops > 10


def test_build_nsw_graph_matches_reference(graphs):
    """The port's graph equals the reference's on at least 99% of rows
    (only a last-bit distance difference may reorder a boundary
    candidate); entry point and shape equal."""
    g, jg = graphs
    assert g.neighbors.shape == jg.neighbors.shape
    assert g.entry == jg.entry
    same = (g.neighbors == jg.neighbors).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(g.vectors, jg.vectors)


def test_batch_search_matches_reference_on_one_graph(small_corpus, graphs):
    """On the reference's graph, the port's beam search gives the
    reference's ids and hop, eval and read counts exactly."""
    from repro.core.graph_baseline import batch_search as jbatch
    from repro.core.graph_baseline import beam_search as jbeam
    from repro_torch.core.graph_baseline import NSWGraph, batch_search, \
        beam_search

    _, q, _ = small_corpus
    _, jg = graphs
    g = NSWGraph(vectors=jg.vectors, neighbors=jg.neighbors, entry=jg.entry)
    ids, st = batch_search(g, q[:48], 10, beam=32)
    jids, jst = jbatch(jg, q[:48], 10, beam=32)
    np.testing.assert_array_equal(ids, jids)
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    one, st1 = beam_search(g, q[0], 5, beam=8, max_hops=3)
    jone, jst1 = jbeam(jg, q[0], 5, beam=8, max_hops=3)
    np.testing.assert_array_equal(one, jone)
    assert st1.hops == jst1.hops <= 3
