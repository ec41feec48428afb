"""The copied generators repeat by seed."""
from __future__ import annotations

import conftest  # noqa: F401  (paths)
import torch

from anns_bench import datagen, loadgen

GEN = {"data_seed": 0, "modes": 4, "intrinsic_dim": 8, "center_scale": 0.4,
       "noise": 0.05, "query_shift": 0.3}
BIG = 2 ** 33 + 12345          # past 32 signed bits, as the driver's are


def test_corpus_is_one_data_set_in_a_seeded_order():
    a = datagen.corpus(2000, 32, GEN, BIG, "cpu")
    b = datagen.corpus(2000, 32, GEN, BIG, "cpu")
    c = datagen.corpus(2000, 32, GEN, 7, "cpu")
    assert a.dtype == torch.float32 and a.shape == (2000, 32)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    key = lambda t: t[torch.argsort(t[:, 0])]          # noqa: E731
    assert torch.equal(key(a), key(c))


def test_queries_repeat_by_seed_and_training_queries_are_fixed():
    p1 = datagen.queries(300, 32, GEN, BIG, "cpu")
    assert torch.equal(p1, datagen.queries(300, 32, GEN, BIG, "cpu"))
    assert not torch.equal(p1, datagen.queries(300, 32, GEN, BIG + 1, "cpu"))
    t1 = datagen.queries(100, 32, GEN, 1, "cpu", "train")
    assert torch.equal(t1, datagen.queries(100, 32, GEN, 2, "cpu", "train"))


def test_every_mode_gets_the_same_count():
    assert datagen._counts(1_000_000, 100) == [10_000] * 100
    assert sum(datagen._counts(65536, 100)) == 65536


def test_subseeds_are_63_bit_and_distinct():
    s = {datagen.subseed(BIG, t) for t in ("pool", "order", "sample")}
    assert len(s) == 3 and all(0 <= v < 2 ** 63 for v in s)


def test_load_generator_repeats_by_seed():
    a = loadgen.poisson_trace(500.0, 2.0, seed=datagen.subseed(BIG, "a"))
    b = loadgen.poisson_trace(500.0, 2.0, seed=datagen.subseed(BIG, "a"))
    c = loadgen.poisson_trace(500.0, 2.0, seed=datagen.subseed(BIG, "b"))
    assert a == b and a != c
    assert all(x.t <= y.t for x, y in zip(a, a[1:]))
