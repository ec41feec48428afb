"""The port's single-node serving launcher on the CPU at a tiny size:
``run_single_node`` deploys, serves an open-loop trace through the engine
with the shard-failure drill and the mid-run rebuild + epoch swap, and
drops nothing; ``run_fabric`` serves the fabric's kill drill and drops
nothing; fabric mode refuses what the reference refuses."""
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


def test_trace_out_holds_the_index_builds_spans(tmp_path, capsys):
    """``--trace-out`` traces the deployed index's build beside the served
    batches: its stages, the splitters' K23 steps, stage 3's fit, nested."""
    from repro_torch.launch import run_single_node
    from repro_torch.obs import check_well_nested

    trace = tmp_path / "trace.json"
    run_single_node(_args("--tier", "f32", "--no-quality", "--grouping",
                          "fifo", "--trace-out", str(trace)))
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"build", "build.stage1", "build.stage2", "build.stage3",
            "stage1.split", "stage1.k23", "shard.assign", "llsp.fit",
            "batch", "gather"} <= names
    assert check_well_nested(events) == []


def test_run_single_node_f32_tier_without_quality(capsys):
    from repro_torch.launch import run_single_node

    out = run_single_node(_args("--tier", "f32", "--no-quality",
                                "--grouping", "fifo", "--depth", "1"))
    assert out["dropped"] == 0 and out["failed"] == 0
    assert out["recall"]["sift"] >= 0.9
    assert "tier=f32" in capsys.readouterr().out


@pytest.mark.parametrize("argv,raises,match", [
    (("--shards", "2", "--tier", "q8"), ValueError, "--tier q8"),
    (("--shards", "2", "--rebuild"), SystemExit, None),
    (("--shards", "2", "--fail-shard", "1"), SystemExit, None)])
def test_fabric_mode_refuses_what_the_reference_refuses(argv, raises, match,
                                                       capsys):
    """The reference's three fabric-mode refusals: an explicit --tier q8
    (ValueError, FABRIC_TIER_ERROR), --rebuild and --fail-shard (argparse
    errors) with --shards > 0."""
    from repro_torch.launch.serve import FABRIC_TIER_ERROR, main

    argv = ["--device", "cpu", "--n", "500", "--duration", "1", *argv]
    with pytest.raises(raises, match=match):
        main(argv)
    if raises is SystemExit:
        err = capsys.readouterr().err
        assert "--rebuild" in err or "--fail-shard" in err
    else:
        assert "fabric" in FABRIC_TIER_ERROR


def test_run_fabric_kill_drill_drops_nothing(capsys, monkeypatch):
    """``--shards 4 --replicas 2 --kill-shard-at`` on the CPU at a tiny
    size: the seeded kill fires, one failover with nothing lost, the dead
    shard's epoch retires, every admitted request completes with none
    partial or failed, and the fabric never timed out.  The fabric is
    built with hedging off and a shard declared dead after 25 silent
    heartbeat ticks (not 3): a batch holding a task on the victim then
    waits for the failover, which must come, and a healthy worker starved
    of the GIL on a loaded runner is not taken for a second victim."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_parser, run_fabric

    fabric = serve.ShardedFabric
    monkeypatch.setattr(serve, "ShardedFabric", lambda *a, **kw: fabric(
        *a, **{**kw, "hedge_after_s": 30.0, "miss_threshold": 25}))

    args = build_parser().parse_args(
        ["--device", "cpu", "--shards", "4", "--n", "2000", "--duration",
         "1.5", "--kill-shard-at", "0.5", "--rate", "60"])
    assert args.replicas == 2
    out = run_fabric(args)
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and out["arrivals"] > 0
    assert out["dropped"] == 0 and out["rejected"] == 0
    assert out["submitted"] == out["arrivals"] + 64    # + the recall probes
    assert out["partial"] == out["failed"] == out["shed"] == 0
    assert len(out["kills"]) == 1 and out["kills"][0][0] == "kill"
    victim = out["kills"][0][1]
    assert [f["shard"] for f in out["failovers"]] == [victim]
    assert out["failovers"][0]["lost"] == 0
    assert out["retired"] == [victim]
    assert out["timeouts"] == 0 and out["partial_queries"] == 0
    assert out["recall"] >= 0.9
    for line in ("[fabric] 4 shards x R=2", "[fault] shard", "[health]",
                 "busy_s per shard"):
        assert line in text


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
