"""The port's single-node serving launcher on the CPU at a tiny size:
``run_single_node`` deploys, serves an open-loop trace through the engine
with the shard-failure drill and the mid-run rebuild + epoch swap, and
drops nothing; the sharded fabric is refused by name."""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401


def _args(*extra):
    from repro_torch.launch.serve import build_parser

    return build_parser().parse_args(
        ["--device", "cpu", "--indexes", "1", "--n", "2000",
         "--duration", "1", *extra])


def test_run_single_node_serves_drills_and_drops_nothing(tmp_path, capsys):
    from repro_torch.obs import check_well_nested, load_npz
    from repro_torch.launch import run_single_node

    health, harvest = tmp_path / "health.json", tmp_path / "harvest.npz"
    trace = tmp_path / "trace.json"
    out = run_single_node(_args(
        "--fail-shard", "3", "--rebuild", "--health-out", str(health),
        "--harvest-out", str(harvest), "--trace-out", str(trace)))
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and out["arrivals"] > 0
    assert out["dropped"] == 0 and out["failed"] == 0
    assert out["submitted"] == out["completed"]
    # every arrival and each of the 64 recall probes was taken or refused
    assert out["submitted"] + out["rejected"] == out["arrivals"] + 64
    assert out["shed"] == 0
    assert out["swap"]["retired"] and out["swap"]["new_epoch"] == 2
    assert out["injected_failures"] == [out["failover"]["shard"]]
    assert out["heartbeat_failed"] == out["injected_failures"]
    assert out["recall"]["sift"] >= 0.9
    for line in ("[done]", "[swap]", "retired=True", "[health] sift: recall",
                 "heartbeat-detected failures"):
        assert line in text
    doc = json.loads(health.read_text())
    assert doc["quality"]["queries"] > 0 and "alerts" in doc
    recs = load_npz(str(harvest))
    assert 0 < len(recs) <= out["completed"]
    events = json.loads(trace.read_text())["traceEvents"]
    check_well_nested(events)


def test_run_single_node_f32_tier_without_quality(capsys):
    from repro_torch.launch import run_single_node

    out = run_single_node(_args("--tier", "f32", "--no-quality",
                                "--grouping", "fifo", "--depth", "1"))
    assert out["dropped"] == 0 and out["failed"] == 0
    assert out["recall"]["sift"] >= 0.9
    assert "tier=f32" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [("--shards", "1"), ("--replicas", "2"),
                                  ("--kill-shard-at", "1.5")])
def test_fabric_mode_raises_by_name(flag):
    from repro_torch.launch.serve import FABRIC_NOT_PORTED, run_single_node

    with pytest.raises(ValueError, match="fabric"):
        run_single_node(_args(*flag))
    assert "not have yet" in FABRIC_NOT_PORTED


def test_serve_entry_point_needs_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    """Without a card the default ``--device cuda`` raises; nothing drops
    to the CPU on its own."""
    from repro_torch.launch.serve import build_parser, run_single_node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(["--indexes", "1", "--n", "500"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_single_node(args)
