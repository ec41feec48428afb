"""The port's twins of ``examples/quickstart.py`` and
``examples/serve_anns.py`` run on the CPU at a small size, through their
own arguments (``--device cpu``), and serve at the recall the reference's
examples print (0.95 and up at these sizes)."""
import importlib.util
import os

import pytest

pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_builds_and_serves_on_the_cpu():
    mod = _example("quickstart_torch")
    out = mod.run(mod.build_parser().parse_args(
        ["--device", "cpu", "--n", "8000", "--queries", "64"]))
    assert out["n_clusters"] > 0 and out["replication"] >= 1.0
    assert out["recall"] >= 0.95
    assert 1.0 <= out["mean_nprobe"] <= 64


def test_serve_anns_twin_serves_through_a_failover_on_the_cpu():
    mod = _example("serve_anns_torch")
    out = mod.run(mod.build_parser().parse_args(
        ["--device", "cpu", "--n", "4000", "--batches", "4",
         "--batch", "32"]))
    assert out["recall"] >= 0.95 and out["qps"] > 0
    assert out["failover"] is not None
    assert out["failover"]["moved"] + out["failover"]["lost"] > 0
