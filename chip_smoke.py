#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. kernels: builds the CUDA library from ``src/repro_torch/csrc`` and holds
   each kernel (q8 fused scan K1, k-means assign/update K2, k-means M-step
   K3, batched Lloyd k-means K23, f32 fused scan B2, legacy f32 scan B6a,
   pairwise L2 B5, cluster-major f32 scan B6b, legacy q8 scan B7) against
   its plain torch version on the card, at the main paths' shapes, at
   ragged ones and with a NaN payload in a live row (which must come out
   NaN, as the reference's clamp keeps it); K23 also bit for bit against
   the per-node K2 + sort + K3 loop it replaces, and K2 and K23 keep a NaN
   distance (a NaN row, a NaN centroid) as their plain versions do; K2 bit
   for bit on grid inputs with its tiles cut at ragged N, K and D (37, 128,
   1024) and with a non-finite coordinate (the sums' one-hot rule, K23
   too); K1 and B2 at one block a query (tile) and at many, with one id in
   two chunks and a query with every probe masked; K1 also at k2 1, 24,
   32, 33 and 256, at P = 256 probes (one more must raise) and bit-equal over two
   launches; K1 and B2 with a NaN distance in
   a live row of the first, a middle or the last slot of a query's plan,
   or of a slot only one query of its tile probes (the query's candidates
   restart after that slot, as the reference's _extract_topk gives); B5 in
   both variants (narrow, wide) wherever each takes the shape, bit-equal
   to each other, equal to the plain version on grid inputs, and with
   argmin/min bit-equal to K2's assign/min_dist, at the unfused build's
   shapes and on both sides of the narrow/wide threshold; B6a at the edges
   of its ring of row chunks (L 1, 33, 129, 1024; D 4, 36, 1024) with
   out-of-range cluster ids and a fully masked query; K3 bit-equal with
   int32 and f32 counts, none, some and all clusters empty, K' above and
   at the number of empty clusters, counts above 2^24, 4-byte words (D % 4
   != 0, a misaligned copy) and K 1 to 20,614, each call one launch (the
   profiler counts one kernel) and one allocation;
3. build: builds a SIFT1M-sized index (1,000,000 x 128, the
   ann-benchmarks sift-128-euclidean base size) with the port's own
   ``build_index`` (launch serve settings: max_cluster_size 96,
   cluster_len 128, LLSP levels (8, 16), 8 ratio features); prints stage
   1's lockstep steps, K23's device time, the host's bookkeeping time and
   the index's ``index_content_hash`` (16 hex digits); stage 2 (the
   streamed ``ShardAssignPipeline``) split by shard stamps into load,
   stream, assign and harvest, with its overlap (some shard's load must
   land under the previous shard's assign) and ``build_postings``' time;
   stage 2 again on the elastic-task branch from the same stage-1
   centroids must hash the same;
   then stage 1 per node on the card (K2 + sort + K3 per splitter node and
   per oversized cell, as before K23) must give the same centroids bit for
   bit, and on the first 20 chunks the lockstep splitter is timed beside
   the per-node one and the per-node plain path on the host CPU;
4. serve: ``make_quantized_pipeline`` with the flash re-rank, warmup, then
   ``run_pipelined(depth=2)`` over 64 batches of 32 queries; recall@10
   against brute force on the card; K1's launches must equal the scan
   dispatches; each batch's scan window split into host spans (stamps)
   and device time (torch.profiler) on a ``[serve] scan window`` line;
5. parity: a subset of those batches through the same pipeline on the CPU
   (plain versions) must give the same ids up to ties; then (4b) the
   freshness merge on phase 4's pipeline: a ``LiveFreshState`` of 65,536
   delta rows with 4,096 seeded inserts and 4,096 deleted main ids, the 64
   batches with and without the merge, and a batch of self-queries (each
   must find its minted id at rank 0, no tombstoned id may come back,
   recall@10 against brute force over live main + delta >= 0.95 x the
   probe ceiling);
6. kernel times at the main paths' shapes, each two ways (CUDA events
   around a run of launches as issued, ``ms``, and the same launches
   queued behind a sleep kernel, ``device_ms``), printed as one JSON line
   with each kernel's launches (summed over every main-path run of phases
   3-16, the ranks of phase 15 included), times, bound and plain time (K1
   through its wrapper, which launches nothing but its two kernels, B2
   alone on a prebuilt plan beside its wrapper's time, both with their
   block counts and split into their two kernels; K2 at the 1M
   reassignment with its per-kernel split from torch.profiler; K23
   on the 1M build's largest step, beside the build's own per-step times;
   B5 also at every shape phase 10's unfused build launched it with,
   summed over its launches by variant beside the bound's sum);
7. resident f32: ``serve_step`` over the phase-4 queries on the index held
   on the card, fused (B2) and legacy (B6a), then ``serve_leveled`` and the
   resident q8 tier (``attach_quantized``, K1); recall against the probe
   ceiling and launch counts;
8. streamed f32: ``PrefetchPipeline`` over ``TieredPostings`` with
   ``run_pipelined(depth=2)``; ids equal phase 7's up to ties;
9. CPU parity: some phase-7 batches through the resident f32 path on the
   CPU (plain versions);
10. unfused build: ``BuildConfig(fused_assign=False)`` (B5 + host float64
    M-step) at 100,000 vectors, served through the q8 pipeline, beside a
    fused build at the same size, which, with one shard checkpoint
    deleted, must resume (``stage2:partial``) to the same hash;
11. engine: phase 3's index deployed as ``launch/serve.py`` deploys it (arena
    extents, striping, replica map, IndexMeta, q8 pipeline with the flash
    re-rank) and served through ``ServeEngine`` + ``DynamicBatcher``
    (depth 2, locality grouping, deadline degrade) with the quality, SLO,
    harvest and trace stack, under two open-loop traces at 0.25x and 0.75x
    phase 4's QPS (the second with a 50 ms deadline), then both traces once
    more without the quality stack, the first of them with an
    ``UpdateLane`` streaming seeded inserts (insert-to-visible p50 and
    p99); nothing lost, K1 once per scan dispatch, ids through the engine
    equal to ``run_sequential``'s up to ties;
12. the CLI: ``python -m repro_torch.launch.serve`` with the reference's
    defaults, two indexes, the shard-failure drill and a rebuild + swap;
    then its fabric mode (``--shards 4 --replicas 2 --kill-shard-at 2
    --duration 6 --n 100000``), which must exit 0 with one failover,
    nothing lost and nothing dropped;
13. the live rebuild: ``delta_build`` of phase 3's corpus with its
    centroids and settings (200 shards of 5,000) must give phase 3's
    postings and ids bit for bit; that build deployed as q8 with the flash
    re-rank (``q8_rebuild_hook``) through ``VersionManager``,
    ``ServeEngine`` and an ``UpdateLane`` over a 65,536-row
    ``LiveFreshState`` preloaded with 4,096 seeded inserts and phase 4b's
    4,096 deletes; a ``RebuildScheduler`` (fill trigger below the preload,
    a ``DriftMonitor`` attached) started 1 s into a 6 s Poisson trace at
    0.25x phase 4's QPS with 100 one-vector inserts a second (and 2 s more
    of the trace once the swap is done): one
    report (trigger ``delta_fill``, tier q8, carried ops, 200 shards
    reused and 1 streamed, no failed attempt), nothing dropped, failed or
    shed, self-queries at rank 0 before, during (on the old epoch, from
    inside the hook, before the swap) and after (distance exactly 0 from
    the new flash tier), no tombstoned id, recall@10 >= 0.95x the probe
    ceiling in each window, K1 once per scan dispatch of both epochs, and
    a full-mode rebuild giving the same postings bit for bit;
14. the fabric: ``ShardedFabric`` on phase 3's index, the planner and the
    merge on the card, the shard scans numpy: S = 1 against phase 8's ids
    up to ties, S = 8 with every cluster on 2 replicas bit-equal to S = 1
    on 8 batches of 32; a closed-loop rate through ``ServeEngine``, then a
    6 s Poisson trace at half of it (hedging off) with shard 1 killed
    (``FaultInjector(seed=0)``) at 2 s: nothing dropped, partial or
    failed, no timeout, one failover with nothing lost, the dead shard's
    epoch retired and its tier released, ``scan_sync`` still bit-equal to
    S = 1;
15. the mesh (``launch/mesh.py`` ``spawn``, ``launch/mesh_jobs.py``) on
    phase 3's index and phase 4's queries: (a) one NCCL rank, mesh (1, 1),
    ``make_sharded_serve`` (B2) with ``shard_centroids`` off and on and
    ``make_sharded_serve_quantized`` (K1), equal to phase 7 up to ties
    with no nprobe flip; (b) four gloo processes time-sharing the card
    (collectives staged through host memory), the same engines on meshes
    (2, 2) and (1, 4) over the index padded to 20,616 clusters, each rank
    loading only its stripe: ids up to ties where nprobe agrees with
    phase 7's, flips at most 2%, recall@10 within 0.005 of phase 7's; the
    q8 engine at ``serve_online``'s query parameters (k 100, P 256, 8
    batches of 512) equal to ``serve_step`` up to ties; (c)
    ``kmeans_sharded_step`` on mesh (4, 1), 1,048,576 x 128 rows a rank,
    K 4,096, against one process's K2 over all rows and the same M-step
    (counts exact, centroids within 1e-5), and the unfused one-hot step
    beside it; (d) ``compressed_psum_tree`` and ``bucketed_psum`` on the
    card's tensors over the gloo group (atol 3e-2 and 1e-5); (e)
    ``build_nsw_graph`` on the card over 10,000 corpus rows, recall@10 >
    0.7 and hops > 10; (f) ``embedding_lookup_sharded`` and
    ``embedding_bag_sharded`` over MIND's full table (4,194,304 x 64, a
    rank holding 1,048,576 rows) at (1, 4) with the ``train_batch`` history
    ids (65,536 x 50) against one process's unsharded functions: the
    lookup bit-equal, the bag within rtol and atol 1e-5.  Each rank's
    launch counts join phase 6's column;
16. train (``[train]``): (a) each recsys arch (MIND, DIN, Wide&Deep,
    xDeepFM) at its published widths and configured table rows, batch
    65,536 (xDeepFM 8,192, cut: its CIN keeps a (B, 7,800, 10) tensor a
    layer), 6 steps on one fixed batch (the loss must fall), then 10
    steps of ``recsys_batch``: ms a step by CUDA events, peak memory, the
    state's bytes, the losses; MIND's step run twice from one state must
    give bit-equal params and AdamW state, and the gathers' backward
    (``F.embedding``, ``index_select``, advanced indexing) is checked for
    bit-equal repeats; (b) one step of each arch at a 2,048-row table on
    the card against the CPU (loss rtol 1e-5, params and moments atol
    1e-5); (c) ``python -m repro_torch.launch.train --arch mind --steps
    20 --ckpt-every 5``: ``--fail-at 12`` exits non-zero, the relaunch
    resumes from step 10, and its step-20 checkpoint is byte-equal to an
    uninterrupted run's; (d) ``examples/train_retrieval_torch.py``'s
    ``run`` at 8,192 and 1,048,576 items (500 steps each): recall@50
    equal to the probe ceiling within 1e-6, and K23, K2 and B2 launched;
17. the LM and GNN families (``[lm]``, ``[gnn]``, ``[lm-cli]``): (a) each
    of the five LMs at its published widths in bf16 (llama4-scout at 8
    of its 48 layers), one at a time: ``prefill_step`` on
    ``token_batch(2, 4,096)`` (prefill_32k, cut), checked against
    ``forward`` over the same tokens (< 2e-3 of the scale), then 64
    ``decode_step``s past every 1,024-slot ring, each against a
    ``forward`` oracle over all 4,160 tokens (q_chunk 64) within 5e-2 of
    the scale, with MoE capacity 16 for both, over the steps' rows whose
    MoE picks all equal the oracle's (at least 0.18 of qwen2-moe's and
    0.875 of llama4-scout's; every other row must flip first at a near
    tie, ``route_checks``; the attention projections rescaled to 1/sqrt
    of their contracted dims, ``contracted_fan_in``):
    prefill ms and tokens/s, decode ms a token, peak memory; (b)
    phi4-mini at full width (3.84 B bf16 params, the same rescale, remat
    per block, the step donating its state) on ``token_batch(B, 4,097)`` at the largest
    B of 4, 2, 1 that fits: 6 steps on one batch (the loss falls), ms a
    step, peak, the state's bytes, the first step repeated from the same
    seeded state bit-equal; (c) GraphCast at full width (16 x 512, 227
    vars) on full_graph_sm, molecule and minibatch_lg (6 steps each, the
    loss falls; full_graph_sm's step repeated bit-equal), then
    ogb_products' forward (2,449,029 nodes, 4,194,304 edges, cut); (d)
    one scaled step of each LM and GraphCast on the card against the CPU,
    the training CLI's qwen2-moe ``--fail-at 12`` drill (the relaunch's
    step-20 checkpoint byte-equal), ``--accum 2`` and GraphCast, and two
    runs of the MoE combine and ``segment_sum`` bit-equal.  No kernel of
    the library launches here (phase 6's column counts zeros).

Phase 15 also runs (g) one full-width qwen2-moe MoE layer (64 experts,
16 a rank) over 2 x 4,096 tokens at mesh (1, 4), four gloo processes
against one process's ``moe_ffn`` (bf16 within 2e-2 of the scale, a
float32 copy within rtol 2e-3), and (h) GraphCast's ``forward_rowdp`` at
(1, 4) on minibatch_lg's sizes, dst-sorted, against the dense forward
(1e-4).  Phase 13's ``[rebuild]`` line carries the poller's longest gap
between SQ drains and the SQ's peak length per window of the rebuild,
from the engine's ``drain_log`` (held to its ``sq_peak`` and
``drain_gap_max_s`` stats).

The last line of standard output is the device JSON; the script exits
non-zero, printing no result, when there is no CUDA device or when it runs
outside a checkout of the repository.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
Q8_TOL = 1e-3                    # candidate tolerance of the q8 scan
F32_TOL = 1e-4                   # candidate tolerance of the f32 scans
N_BASE = 1_000_000
N_UNFUSED = 100_000              # the unfused build's host float64 M-step
                                 # makes a 1M build slow
N_BATCHES = 64
BATCH = 32
PARITY_BATCHES = 8
DEVICE = "cuda"                  # the serving device of phases 3 and 4
ENGINE_TRACE_S = 6.0             # seconds of each phase-11 open-loop trace
ENGINE_PROBES = 256              # phase-11 queries checked against
                                 # run_sequential
CLI_N = 100_000                  # phase 12's corpus size per index
CLI_TIMEOUT_S = 600              # phase 12's subprocess
MAX_PER_NODE_LAUNCHES = 200      # K2 or K3 launches a 1M build may make
                                 # (the per-node splitter made 81,579)


CARD = [""]                      # nvidia-smi's name and power limit


def log(*a) -> None:
    print(*a, flush=True)


# every main-path run's launch counts, by run: each phase resets the counts
# just before it drives its path and records them here just after
PATH_RUNS: dict = {}


def path_launches(what: str) -> dict:
    """The launch counts since the last reset, recorded as main-path run
    ``what``; phase 6's rows sum them per kernel."""
    from repro_torch.kernels.cuda_lib import LAUNCHES

    PATH_RUNS[what] = LAUNCHES.snapshot()
    return PATH_RUNS[what]


# --------------------------------------------------------------------------
# comparison helpers
# --------------------------------------------------------------------------
def candidates_match(gd, gi, wd, wi, tol: float, what: str) -> float:
    """Distances elementwise within tol; ids equal except inside groups of
    tied distances, where the id sets must agree.  A group tied with the
    last column may continue past it, so its ids may differ (two scans
    that sum in different orders can swap a near-tie at the k-th
    boundary); such swaps are counted and logged.  Returns max |gd - wd|
    over finite entries."""
    import numpy as np

    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    if gd.shape != wd.shape:
        raise AssertionError(f"{what}: shape {gd.shape} vs {wd.shape}")
    fin = np.isfinite(wd)
    if not np.array_equal(fin, np.isfinite(gd)):
        raise AssertionError(f"{what}: finite pattern differs")
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=tol, atol=tol * 10,
                               err_msg=what)
    boundary = 0
    for r in range(gd.shape[0]):
        for j in range(gd.shape[1]):
            if not fin[r, j]:
                if gi[r, j] != -1 or wi[r, j] != -1:
                    raise AssertionError(f"{what}: pad id at {(r, j)}")
                continue
            tied = np.isclose(wd[r], wd[r, j], rtol=tol, atol=tol * 10)
            if tied[-1]:
                boundary += int(gi[r, j] != wi[r, j])
            elif tied.sum() == 1:
                if gi[r, j] != wi[r, j]:
                    raise AssertionError(f"{what}: id at {(r, j)}")
            elif set(gi[r][tied].tolist()) != set(wi[r][tied].tolist()):
                raise AssertionError(f"{what}: tied ids at {(r, j)}")
    if boundary:
        log(f"[match] {what}: {boundary} id(s) differ inside a tie group "
            f"at the k-th boundary (distances agree within {tol})")
    return float(np.abs(gd[fin] - wd[fin]).max()) if fin.any() else 0.0


def time_ms(fn, n: int = 20, warm: int = 3) -> float:
    """ms a call of ``fn``: CUDA events around n calls as they are issued,
    so a call shorter than its issue time reads the host's time."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


SLEEP_CYCLES_PER_S = 1.98e9      # torch.cuda._sleep's unit: SM clock cycles
                                 # (the H100 SXM's 1,980 MHz boost clock)


def time_two_ways(fn, n: int, warm: int = 3) -> dict:
    """Device ms a call of ``fn``: CUDA events around n calls, first as they
    are issued ("events", :func:`time_ms`'s yardstick), then with the n
    calls queued behind a sleep kernel that holds the stream for about
    twice the host's time to issue them ("queued": the card's time alone,
    as long as the calls do not wait for the card themselves)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / max(warm, 1)
    events = time_ms(fn, n, warm=0)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * n * host_s, 1.0) * SLEEP_CYCLES_PER_S))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return {"events": events, "queued": a.elapsed_time(b) / n}


# --------------------------------------------------------------------------
# inputs at the kernels' shapes
# --------------------------------------------------------------------------
def q8_inputs(rows, l, d, b, p, *, seed, dead=0.0, masked=0.0, dup=False,
              device="cuda"):
    """Packed q8 rows (as the host tier streams them) and a probe plan."""
    import numpy as np
    import torch

    from repro_torch.core.quantize import quantize_postings

    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(rows, d)).astype(np.float32)
    post = cents[:, None, :] + 0.3 * rng.normal(size=(rows, l, d)).astype(
        np.float32)
    ids = rng.permutation(rows * l * 2)[: rows * l].reshape(rows, l)
    ids = ids.astype(np.int32)
    if dead:
        ids[rng.random(ids.shape) < dead] = -1
    ids[-1] = -1                                     # sentinel row
    qp = quantize_postings(torch.from_numpy(post), torch.from_numpy(cents),
                           torch.from_numpy(ids))
    q8 = qp.q8.numpy().copy()
    q8[ids < 0] = rng.integers(-128, 127, size=(int((ids < 0).sum()), d))
    queries = (cents[rng.integers(0, rows - 1, size=b)]
               + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    cids = rng.integers(0, rows - 1, size=(b, p)).astype(np.int32)
    if dup:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(q8), t(qp.scale.numpy()), t(qp.norm2.numpy()), t(cents), t(ids),
            t(cids), t(mask), t(queries))


def f32_inputs(rows, l, d, b, p, *, seed, dead=0.0, masked=0.0, dup=False,
               nan_dead=False, device="cuda"):
    """Packed f32 rows (as the f32 host tier streams them, the last row a
    sentinel of ids -1) and a probe plan.  ``nan_dead`` fills dead rows'
    payload with NaN, as stale pinned memory may."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(rows, d)).astype(np.float32)
    post = (cents[:, None, :]
            + 0.3 * rng.normal(size=(rows, l, d))).astype(np.float32)
    ids = rng.permutation(rows * l * 2)[: rows * l].reshape(rows, l)
    ids = ids.astype(np.int32)
    if dead:
        ids[rng.random(ids.shape) < dead] = -1
    ids[-1] = -1                                     # sentinel row
    if nan_dead:
        post[ids < 0] = np.nan
    queries = (cents[rng.integers(0, rows - 1, size=b)]
               + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    cids = rng.integers(0, rows - 1, size=(b, p)).astype(np.int32)
    if dup:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(post), t(ids), t(cids), t(mask), t(queries)


def kmeans_inputs(n, k, d, *, seed, device="cuda"):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    modes = rng.normal(size=(max(k // 4, 1), d)).astype(np.float32)
    x = modes[rng.integers(0, len(modes), size=n)] \
        + 0.25 * rng.normal(size=(n, d)).astype(np.float32)
    cents = x[rng.choice(n, size=k, replace=k > n)]
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(np.ascontiguousarray(cents)).to(device))


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------
def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return {"card": card, "name": name}


# --------------------------------------------------------------------------
# phase 2: build the kernels and hold each against its plain version
# --------------------------------------------------------------------------
def check_k1(case: str, k2: int, *args, chunks=(None,)) -> float:
    """K1 against its plain version at each block count a query of
    ``chunks`` (None: the card's own count; "P": one a probe), each within
    the kernel's limit."""
    import torch

    from repro_torch.kernels import ivf_scan_q8 as q8mod

    wd, wi = q8mod.ivf_scan_q8_topk_plain(*args, k2=k2)
    p = args[5].shape[1]
    top = q8mod._max_chunks(p, k2)
    err = 0.0
    for n in chunks:
        n = None if n is None else min(p if n == "P" else n, top)
        gd, gi = q8mod.ivf_scan_q8_topk_cuda(*args, k2=k2, chunks=n)
        torch.cuda.synchronize()
        if bool(torch.isnan(gd).any()):
            raise AssertionError(f"K1 {case}: NaN reached the candidates")
        err = max(err, candidates_match(gd.cpu(), gi.cpu(), wd.cpu(),
                                        wi.cpu(), Q8_TOL,
                                        f"K1 {case} chunks={n}"))
    log(f"[kernels] K1 {case}: ok at chunks {list(chunks)} "
        f"max_abs_err={err:.3g}")
    return err


def check_k2(case: str, x, cents) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels import kmeans_assign as am

    a, md, sums, counts = am.kmeans_assign_update_cuda(x, cents)
    a2, md2, sums2, counts2 = am.kmeans_assign_update_cuda(x, cents)
    pa, pmd, _, _ = am.kmeans_assign_update_plain(x, cents)
    torch.cuda.synchronize()
    for u, v in ((a, a2), (md, md2), (sums, sums2), (counts, counts2)):
        if not torch.equal(u, v):
            raise AssertionError(f"K2 {case}: not deterministic run to run")
    a_np, pa_np = a.cpu().numpy(), pa.cpu().numpy()
    xf = x.double()
    cf = cents.double()
    diff = np.nonzero(a_np != pa_np)[0]
    if diff.size:
        idx = torch.from_numpy(diff).to(x.device)
        dk = ((xf[idx] - cf[a[idx].long()]) ** 2).sum(1)
        dp = ((xf[idx] - cf[pa[idx].long()]) ** 2).sum(1)
        scale = (xf[idx] ** 2).sum(1) + 1.0
        if not bool(((dk - dp).abs() <= 1e-5 * scale).all()):
            raise AssertionError(f"K2 {case}: {diff.size} assignments differ "
                                 f"beyond ties")
    md_err = float((md.double() - pmd.double()).abs().max())
    tol = 1e-5 * float((xf ** 2).sum(1).max() + 1.0)
    if md_err > tol:
        raise AssertionError(f"K2 {case}: min_dist err {md_err} > {tol}")
    k = cents.shape[0]
    al = a.long()
    ref_counts = torch.bincount(al, minlength=k)
    if not torch.equal(ref_counts.to(torch.int32), counts):
        raise AssertionError(f"K2 {case}: counts disagree with assign")
    ref_sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, al, xf)
    s_err = float((sums.double() - ref_sums).abs().max())
    s_tol = 1e-5 * float(x.abs().max() + 1.0) * float(ref_counts.max())
    if s_err > s_tol:
        raise AssertionError(f"K2 {case}: sums err {s_err} > {s_tol}")
    log(f"[kernels] K2 {case}: ok ties={diff.size} md_err={md_err:.3g} "
        f"sums_err={s_err:.3g}")
    return max(md_err, s_err)


def check_k3(case: str, sums, counts, reseed, *, variant=None) -> float:
    """K3 bit-equal to its plain version, in one launch that allocates
    nothing but its output; ``variant`` is the word width it must take."""
    import torch

    from repro_torch.kernels import kmeans_mstep as mm
    from repro_torch.kernels.cuda_lib import LAUNCHES

    got_variant = mm.kmeans_mstep_variant(
        sums.shape[1], sums.data_ptr(), reseed.data_ptr(),
        torch.empty(1, device=sums.device).data_ptr())
    if variant is not None and got_variant != variant:
        raise AssertionError(f"K3 {case}: variant {got_variant}, "
                             f"wanted {variant}")
    want = mm.kmeans_mstep_plain(sums, counts, reseed)
    torch.cuda.synchronize()
    n0 = LAUNCHES.snapshot()["kmeans_mstep"]
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    got = mm.kmeans_mstep_cuda(sums, counts, reseed)
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0) \
        - a0
    torch.cuda.synchronize()
    if LAUNCHES.snapshot()["kmeans_mstep"] - n0 != 1 or allocs != 1:
        raise AssertionError(f"K3 {case}: {allocs} allocations (wanted the "
                             f"output alone)")
    if not torch.equal(got.isnan(), want.isnan()) or not torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(want)):
        raise AssertionError(f"K3 {case}: not bit-equal to the plain version")
    log(f"[kernels] K3 {case}: ok (bit-equal, {got_variant}, one launch, "
        f"one allocation)")
    return 0.0


def k3_launch_count(sums, counts, reseed) -> int:
    """Kernels the card ran in one K3 call, by torch.profiler: one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import kmeans_mstep as mm

    mm.kmeans_mstep_cuda(sums, counts, reseed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            mm.kmeans_mstep_cuda(sums, counts, reseed)
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if getattr(ev, "self_device_time_total", 0.0) > 0)
    return n // 4


def check_b2(case: str, k2: int, *args, chunks=(None,)) -> float:
    """B2 against its plain version by tile at each block count of
    ``chunks`` (None: the card's own count), and by cluster."""
    import torch

    from repro_torch.kernels import ivf_scan as scan

    wd, wi = scan.ivf_scan_topk_plain(*args, k2=k2)
    err = 0.0
    s_len = scan.BQ * args[2].shape[1]
    runs = [("by_tile", None if n is None else min(n, s_len))
            for n in chunks] + [("by_cluster", None)]
    for design, n in runs:
        gd, gi = scan.ivf_scan_topk_cuda(*args, k2=k2, chunks=n,
                                         design=design)
        torch.cuda.synchronize()
        if bool(torch.isnan(gd).any()):
            raise AssertionError(f"B2 {case}: NaN reached the candidates")
        err = max(err, candidates_match(gd.cpu(), gi.cpu(), wd.cpu(),
                                        wi.cpu(), F32_TOL,
                                        f"B2 {case} {design} chunks={n}"))
    log(f"[kernels] B2 {case}: ok by tile at chunks {list(chunks)} and by "
        f"cluster, max_abs_err={err:.3g}")
    return err


def check_k2_exact(case: str, x, cents) -> float:
    """K2 against its plain version on grid inputs, where every distance,
    sum and count is exact: equal, NaN for NaN (the sums' one-hot rule)."""
    import torch

    from repro_torch.kernels import kmeans_assign as am

    got = am.kmeans_assign_update_cuda(x, cents)
    want = am.kmeans_assign_update_plain(x, cents)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    log(f"[kernels] K2 {case}: ok, bit-equal, "
        f"{int(torch.isnan(got[2]).sum())} NaN sums")
    return 0.0


def check_b6a(case: str, post, cids, mask, queries) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels import ivf_scan as scan

    got = scan.ivf_scan_cuda(post, cids, mask, queries)
    want = scan.ivf_scan_plain(post, cids, mask, queries)
    torch.cuda.synchronize()
    g, w, m = got.cpu().numpy(), want.cpu().numpy(), mask.cpu().numpy()
    if not (g[~m] == np.inf).all():
        raise AssertionError(f"B6a {case}: a masked probe is not +inf")
    if not np.isfinite(g[m]).all():
        raise AssertionError(f"B6a {case}: a live distance is not finite")
    np.testing.assert_allclose(g[m], w[m], rtol=F32_TOL, atol=F32_TOL * 10,
                               err_msg=f"B6a {case}")
    err = float(np.abs(g[m] - w[m]).max()) if m.any() else 0.0
    log(f"[kernels] B6a {case}: ok max_abs_err={err:.3g}")
    return err


def check_b5(case: str, a, b) -> float:
    """B5 in every variant that takes the shape (narrow where b fits,
    wide always) and as its wrapper picks: each within a few ulps of the
    plain version, the variants bit-equal to each other, and the argmin
    and min of the distances bit-equal to K2's assign and min_dist."""
    import torch

    from repro_torch.kernels import kmeans_assign as am
    from repro_torch.kernels import pairwise_l2 as pw

    n, d = a.shape
    m = b.shape[0]
    variants = [v for v in ("narrow", "wide")
                if v == "wide" or pw.narrow_rows(m, d) >= 1]
    gots = {v: pw.pairwise_l2_cuda(a, b, variant=v) for v in variants}
    picked = pw.pairwise_l2_cuda(a, b)
    want = pw.pairwise_l2_plain(a, b)
    k2_assign, k2_min = am.kmeans_assign_update_cuda(a, b)[:2]
    torch.cuda.synchronize()
    # the norm form cancels: allow a few ulps of ||a||^2 + ||b||^2
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max()) + 1.0
    err = 0.0
    for v, got in gots.items():
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B5 {case} {v}: shape or non-finite values")
        if bool((got < 0).any()):
            raise AssertionError(f"B5 {case} {v}: negative distance")
        e = float((got - want).abs().max())
        if e > 2e-6 * scale:
            raise AssertionError(f"B5 {case} {v}: err {e} > {2e-6 * scale}")
        if not torch.equal(got.view(torch.int32), picked.view(torch.int32)):
            raise AssertionError(f"B5 {case}: {v} differs from the picked "
                                 f"variant ({pw.pairwise_l2_variant(n, m, d)})"
                                 f" in its bits")
        err = max(err, e)
    if not (torch.equal(torch.argmin(picked, 1).to(torch.int32), k2_assign)
            and torch.equal(torch.min(picked, 1).values.view(torch.int32),
                            k2_min.view(torch.int32))):
        raise AssertionError(f"B5 {case}: argmin/min differ from K2's "
                             f"assign/min_dist")
    log(f"[kernels] B5 {case}: ok variants {variants} bit-equal, picked "
        f"{pw.pairwise_l2_variant(n, m, d)}, argmin/min = K2's, "
        f"max_abs_err={err:.3g} (limit {2e-6 * scale:.3g})")
    return err


def check_b5_exact(case: str, n: int, m: int, d: int, seed: int) -> None:
    """B5 on grid inputs (every distance exact in f32) in every variant
    that takes the shape: equal to the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import pairwise_l2 as pw

    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(-4, 5, size=(r, d)).astype(
        np.float32)).cuda() for r in (n, m))
    want = pw.pairwise_l2_plain(a, b)
    for v in ("narrow", "wide"):
        if v == "narrow" and pw.narrow_rows(m, d) < 1:
            continue
        if not torch.equal(pw.pairwise_l2_cuda(a, b, variant=v), want):
            raise AssertionError(f"B5 exact {case} {v}: differs from plain")
    log(f"[kernels] B5 exact {case}: ok, equal to plain")


def cmajor_inputs(c, l, d, b, a_n, *, seed, nan_row=False, edges=False,
                  sel=0.5, device="cuda"):
    """Postings (C, L, D), an active-cluster list with a duplicate and
    out-of-range ids, a selection mask (A, B), each pair selected with
    probability ``sel``, and queries; ``nan_row`` puts a NaN in one row of
    the first active cluster, selected by every query; ``edges`` (A >= 7)
    gives active cluster 4 no selected query, 5 every query, and puts a NaN
    in a row of 4 (met only by unselected queries) and of 6 (selected by
    every other query)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(c, d)).astype(np.float32)
    post = (cents[:, None, :]
            + 0.3 * rng.normal(size=(c, l, d))).astype(np.float32)
    queries = (cents[rng.integers(0, c, size=b)]
               + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    active = rng.permutation(c)[:a_n].astype(np.int32)
    if a_n >= 4:
        active[1], active[2], active[3] = active[0], -3, c + 7
    qsel = rng.random((a_n, b)) < sel
    if nan_row:
        post[max(active[0], 0), l // 2, d // 3] = np.nan
        qsel[0] = True
    if edges:
        qsel[4], qsel[5] = False, True
        qsel[6] = np.arange(b) % 2 == 0
        post[active[4], l // 3, d // 2] = np.nan
        post[active[6], l - 1, 0] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(post), t(active), t(qsel), t(queries)


def check_b6b(case: str, post, active, qsel, queries) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels import ivf_scan as scan

    got = scan.ivf_scan_clustermajor_cuda(post, active, qsel, queries)
    want = scan.ivf_scan_clustermajor_plain(post, active, qsel, queries)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    sel = np.broadcast_to(qsel.cpu().numpy()[:, None, :], g.shape)
    if not (g[~sel] == np.inf).all():
        raise AssertionError(f"B6b {case}: an unselected pair is not +inf")
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"B6b {case}: NaN pattern differs from the "
                             f"plain version")
    live = sel & ~np.isnan(w)
    np.testing.assert_allclose(g[live], w[live], rtol=F32_TOL,
                               atol=F32_TOL * 10, err_msg=f"B6b {case}")
    err = float(np.abs(g[live] - w[live]).max()) if live.any() else 0.0
    log(f"[kernels] B6b {case}: ok max_abs_err={err:.3g} "
        f"nan={int(np.isnan(g).sum())}")
    return err


def q8_legacy_inputs(c, l, d, b, p, *, seed, masked=0.0, nan_norm=False,
                     device="cuda"):
    """Quantized postings with garbage codes in dead slots, out-of-range
    and duplicate cids, masked probes; ``nan_norm`` puts a NaN in one live
    slot's norm."""
    args = list(q8_inputs(c, l, d, b, p, seed=seed, dead=0.1, masked=masked,
                          dup=True, device="cpu"))
    q8, scale, norm2, cents, _, cids, mask, queries = args
    cids[0, -1] = c + 5
    cids[-1, 0] = -2
    if nan_norm:
        mask[1, 2] = True
        norm2[int(cids[1, 2]), l // 2] = float("nan")
    return [a.contiguous().to(device) for a in
            (q8, scale, norm2, cents, cids, mask, queries)]


def vec4_codes(q8):
    """A copy of B7's codes 4 bytes past a 16-byte boundary: a contiguous
    view that ``ivf_scan_q8_variant`` sends to the vec4 variant at any
    shape."""
    import torch

    buf = torch.empty(q8.numel() + 16, dtype=torch.int8, device=q8.device)
    start = (4 - buf.data_ptr()) % 16
    view = buf[start:start + q8.numel()].view(q8.shape)
    view.copy_(q8)
    assert view.data_ptr() % 16 == 4
    return view


def check_b7(case: str, *args) -> float:
    """B7 against its plain version, in the variant ``ivf_scan_q8_variant``
    picks."""
    import numpy as np
    import torch

    from repro_torch.kernels import ivf_scan_q8 as q8m

    got = q8m.ivf_scan_q8_cuda(*args)
    want = q8m.ivf_scan_q8_plain(*args)
    torch.cuda.synchronize()
    g, w, m = got.cpu().numpy(), want.cpu().numpy(), args[5].cpu().numpy()
    if not (g[~m] == np.inf).all():
        raise AssertionError(f"B7 {case}: a masked probe is not +inf")
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"B7 {case}: NaN pattern differs from the "
                             f"plain version")
    live = np.broadcast_to(m[:, :, None], g.shape) & ~np.isnan(w)
    np.testing.assert_allclose(g[live], w[live], rtol=1e-4, atol=1e-3,
                               err_msg=f"B7 {case}")
    err = float(np.abs(g[live] - w[live]).max()) if live.any() else 0.0
    picked = q8m.ivf_scan_q8_variant(args[0].shape[2], args[0].data_ptr())
    log(f"[kernels] B7 {case} ({picked}): ok "
        f"max_abs_err={err:.3g} nan={int(np.isnan(g).sum())}")
    return err


def check_nan_kept(case: str, got, want) -> None:
    """A NaN distance from a NaN payload must come out NaN, where the plain
    version (the reference's clamp) gives NaN."""
    import torch

    torch.cuda.synchronize()
    if not bool(torch.isnan(want).any()):
        raise AssertionError(f"{case}: the plain version lost the NaN")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{case}: NaN pattern differs from the plain "
                             f"version ({int(torch.isnan(got).sum())} vs "
                             f"{int(torch.isnan(want).sum())})")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)
    log(f"[kernels] {case}: ok, {int(torch.isnan(got).sum())} NaN kept")


def k23_inputs(sizes, k, d, *, seed, device="cuda"):
    """Sub-problems of the given sizes (k centroids each, capped at the
    size) over rows of a Gaussian mixture scattered in random order, with
    host int32 indices and initial rows drawn as the splitter draws them:
    (x, pts, offs, k, init)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t_n = int(sum(sizes))
    modes = rng.normal(size=(16, d)).astype(np.float32)
    x = modes[rng.integers(0, 16, size=t_n)] \
        + 0.25 * rng.normal(size=(t_n, d)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ks = np.minimum(k, np.asarray(sizes)).astype(np.int32)
    init = np.zeros((len(sizes), 16), np.int32)
    for i, (n, kk) in enumerate(zip(sizes, ks)):
        init[i, :kk] = np.random.default_rng(seed + i).choice(n, kk,
                                                              replace=False)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(rng.permutation(t_n).astype(np.int32)),
            torch.from_numpy(offs), torch.from_numpy(ks),
            torch.from_numpy(init))


def per_node_lloyd(x, pts, offs, k, init, iters):
    """The per-node loop K23 replaces: K2, a stable sort and K3 on each
    sub-problem in turn, on the card."""
    from repro_torch.kernels import kmeans_assign as am
    from repro_torch.kernels import kmeans_mstep as mm
    from repro_torch.kernels.kmeans_batched import lloyd

    outs = []
    for s in range(k.shape[0]):
        lo, hi, ks = int(offs[s]), int(offs[s + 1]), int(k[s])
        xs = x[pts[lo:hi].to(x.device).long()].contiguous()
        c0 = xs[init[s, :ks].to(x.device).long()].contiguous()
        outs.append(lloyd(xs, c0, iters, am.kmeans_assign_update_cuda,
                          mm.kmeans_mstep_cuda))
    return outs


def check_k23(case: str, iters: int, x, pts, offs, k, init) -> float:
    """K23 against its plain version (assignments >= 99% equal, centroids
    within 1e-4: the tolerance of the CPU test of the k-means loop), bit
    for bit against the per-node CUDA loop, and equal run to run."""
    import torch

    from repro_torch.kernels import kmeans_batched as kb

    got = kb.kmeans_batched_cuda(x, pts, offs, k, init, iters)
    again = kb.kmeans_batched_cuda(x, pts, offs, k, init, iters)
    want = kb.kmeans_batched_plain(x, pts, offs, k, init, iters)
    nodes = per_node_lloyd(x, pts, offs, k, init, iters)
    torch.cuda.synchronize()
    for u, v in zip(got, again):
        if not torch.equal(u, v):
            raise AssertionError(f"K23 {case}: not deterministic run to run")
    a, md, cents, counts = got
    for s, (c, pa, pmd, pcnt) in enumerate(nodes):
        lo, hi, ks = int(offs[s]), int(offs[s + 1]), int(k[s])
        if not (torch.equal(a[lo:hi], pa) and torch.equal(md[lo:hi], pmd)
                and torch.equal(cents[s, :ks], c)
                and torch.equal(counts[s, :ks], pcnt)):
            raise AssertionError(f"K23 {case}: sub-problem {s} differs from "
                                 f"the per-node K2 + sort + K3 loop")
    agree = float((a == want[0]).float().mean())
    if agree < 0.99:
        raise AssertionError(f"K23 {case}: {agree:.4f} of the assignments "
                             f"equal the plain version's")
    torch.testing.assert_close(cents, want[2], rtol=1e-4, atol=1e-4)
    err = float((cents - want[2]).abs().max())
    log(f"[kernels] K23 {case}: ok, bit-equal to the per-node loop, "
        f"assign agreement {agree:.5f} max_abs_err={err:.3g}")
    return err


def check_kmeans_nan(case: str, got, want) -> None:
    """K2 or K23 on grid inputs with a NaN row and a NaN centroid: every
    output equal to the plain version's, NaN for NaN."""
    import torch

    torch.cuda.synchronize()
    if not bool(torch.isnan(want[1]).any()):
        raise AssertionError(f"{case}: the plain version lost the NaN")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    log(f"[kernels] {case}: ok, {int(torch.isnan(got[1]).sum())} NaN "
        f"min distances kept, assignments equal")


def k3_inputs(k, d, n_empty, *, seed, int_counts=False, k_reseed=None,
              big=False):
    """K3's inputs: sums (K, D), counts (K,) int32 or f32 with ``n_empty``
    zeros (``big``: the others above 2^24, where f32 rounds), and reseed
    (K', D) with K' = ``k_reseed`` (K by default), on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sums = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    lo, hi = ((1 << 24) + 1, 1 << 30) if big else (1, 50)
    counts = rng.integers(lo, hi, size=k)
    counts[rng.choice(k, size=n_empty, replace=False)] = 0
    counts = torch.from_numpy(counts.astype(
        np.int32 if int_counts else np.float32))
    reseed = torch.from_numpy(rng.normal(
        size=(k if k_reseed is None else k_reseed, d)).astype(np.float32))
    return sums.cuda(), counts.cuda(), reseed.cuda()


def k3_misaligned(sums):
    """A copy of ``sums`` at a 4-byte offset from a 16-byte boundary: K3
    must take its 4-byte words there."""
    import torch

    buf = torch.empty(sums.numel() + 1, dtype=torch.float32,
                      device=sums.device)
    view = buf[1:].view(sums.shape)
    view.copy_(sums)
    return view


def phase_kernels() -> dict:
    """Returns each kernel's largest error against its plain version."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import pairwise_l2 as pw

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port import NAN_WHERE, plant_nan   # the CPU tests' NaN cases

    resolve_device(DEVICE)                 # TF32 off for the plain versions
    t0 = time.perf_counter()
    info = cuda_lib.build_info()
    log(f"[kernels] library {info.path} built in {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    if info.log:
        log(info.log)
    errs = {"ivf_scan_q8_topk": 0.0, "kmeans_assign_update": 0.0,
            "kmeans_mstep": 0.0, "ivf_scan_topk": 0.0, "ivf_scan": 0.0,
            "pairwise_l2": 0.0, "ivf_scan_clustermajor": 0.0,
            "ivf_scan_q8": 0.0, "kmeans_batched": 0.0}

    def k1(case, k2, *shape, chunks=(None, 1, 3, "P"), **kw):
        e = check_k1(case, k2, *q8_inputs(*shape, **kw), chunks=chunks)
        errs["ivf_scan_q8_topk"] = max(errs["ivf_scan_q8_topk"], e)

    k1("main 512x128x128 B32 P16", 24, 512, 128, 128, 32, 16, seed=1,
       dead=0.05, masked=0.2)
    k1("ragged B13 dead+masked+dup", 24, 40, 48, 24, 13, 7, seed=2,
       dead=0.3, masked=0.3, dup=True)
    k1("k2 > live candidates", 200, 9, 16, 32, 5, 3, seed=3, dead=0.5,
       masked=0.5)
    k1("D=1024 L=64 k2=256", 256, 20, 64, 1024, 3, 4, seed=4, dead=0.1)
    k1("serve_online shape L=128 D=128 P=256 k2=200 (static + dynamic "
       "shared memory over 48 KB)", 200, 600, 128, 128, 8, 256, seed=5,
       dead=0.05, masked=0.1)
    k1("main shape k2=1", 1, 512, 128, 128, 32, 16, seed=10, dead=0.05,
       masked=0.2)
    k1("main shape k2=32 (every register lane)", 32, 512, 128, 128, 32, 16,
       seed=11, dead=0.05, masked=0.2)
    k1("main shape k2=33 (shared-memory buffers)", 33, 512, 128, 128, 32,
       16, seed=5, dead=0.05, masked=0.2)
    k1("main shape k2=256", 256, 512, 128, 128, 32, 16, seed=6, dead=0.05,
       masked=0.2)
    k1("P=256 (the limit) with repeats", 24, 600, 32, 64, 8, 256, seed=7,
       dead=0.1, masked=0.2)
    # one id in a low and a high cluster that query 0 probes, so the copies
    # land in different chunks; query 3 with every probe masked
    from repro_torch.kernels import ivf_scan_q8 as q8m
    args = list(q8_inputs(512, 128, 128, 32, 16, seed=8, dead=0.05,
                          masked=0.1, device="cpu"))
    ids, cids, mask = args[4], args[5], args[6]
    cids[0, :2], mask[0, :2] = torch.tensor([2, 500]), True
    ids[2, 5] = ids[500, 9] = 10_000_000
    args[7][0] = args[3][2] + args[1][2, 0, 0] * args[0][2, 5].float()
    mask[3] = False
    args = [a.cuda() for a in args]
    e = check_k1("dup id across chunks + masked query", 24, *args,
                 chunks=(None, 1, 2, "P"))
    errs["ivf_scan_q8_topk"] = max(errs["ivf_scan_q8_topk"], e)
    gd, gi = q8m.ivf_scan_q8_topk_cuda(*args, k2=24, chunks=16)
    again = q8m.ivf_scan_q8_topk_cuda(*args, k2=24, chunks=16)
    torch.cuda.synchronize()
    if int((gi[0] == 10_000_000).sum()) != 1:
        raise AssertionError("K1: the id in two chunks is not there once")
    if not (bool(torch.isinf(gd[3]).all()) and bool((gi[3] == -1).all())):
        raise AssertionError("K1: the fully masked query has candidates")
    if not (torch.equal(gd, again[0]) and torch.equal(gi, again[1])):
        raise AssertionError("K1: two launches on the same inputs differ")
    log("[kernels] K1 two launches bit-equal; the id in two chunks once; "
        "the masked query empty")
    # a NaN distance of a live row empties the query's buffer at its slot,
    # in the first chunk or the last
    for where in NAN_WHERE:
        args = list(q8_inputs(64, 128, 128, 32, 16, seed=40, dead=0.05,
                              masked=0.1, device="cpu"))
        plant_nan(*(args[i].numpy() for i in (2, 4, 5, 6)), where, q=1)
        e = check_k1(f"NaN in a live row, {where} slot", 24,
                     *[a.cuda() for a in args], chunks=(None, 1, 3, "P"))
        errs["ivf_scan_q8_topk"] = max(errs["ivf_scan_q8_topk"], e)
    over = q8_inputs(20, 8, 16, 3, q8m.MAX_P + 1, seed=9)
    try:
        q8m.ivf_scan_q8_topk_cuda(*over, k2=8)
    except ValueError as exc:
        log(f"[kernels] K1 P={q8m.MAX_P + 1} refused: {exc}")
    else:
        raise AssertionError(f"K1 took P={q8m.MAX_P + 1} probes")

    def k2(case, n, k, d, seed):
        e = check_k2(case, *kmeans_inputs(n, k, d, seed=seed))
        errs["kmeans_assign_update"] = max(errs["kmeans_assign_update"], e)

    k2("splitter 5000x8x128", 5000, 8, 128, 5)
    k2("size-bound 1000000x14000x128", N_BASE, 14000, 128, 6)
    k2("ragged 2049x65x3", 2049, 65, 3, 7)
    k2("ragged 1x1x5", 1, 1, 5, 8)
    k2("K > N 100x300x20", 100, 300, 20, 9)
    # exact ties: duplicated centroids must resolve to the lower index
    import torch
    x, c = kmeans_inputs(3000, 16, 64, seed=10)
    c = torch.cat([c, c], dim=0).contiguous()
    check_k2("duplicated centroids", x, c)
    from repro_torch.kernels import kmeans_assign as am
    a, *_ = am.kmeans_assign_update_cuda(x, c)
    if int(a.max()) >= 16:
        raise AssertionError("K2: a tie went to the higher index")
    # the 128 x 128 tiles off their edges, D 37 / 128 / 1024, and the sums'
    # one-hot rule for a non-finite coordinate, bit for bit on grid inputs
    import numpy as np
    for (n, k, d), bad in (((1000, 300, 37), None), ((2049, 257, 128), None),
                           ((300, 130, 1024), None), ((1000, 300, 37), "nan"),
                           ((2049, 257, 128), "inf"),
                           ((300, 130, 1024), "-inf and nan")):
        rng = np.random.default_rng(n + d)
        xg = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        cg = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
        if bad:
            xg[n // 3, d // 2] = np.nan if bad == "nan" else \
                (np.inf if bad == "inf" else -np.inf)
            if bad == "-inf and nan":
                xg[n // 2, d // 2] = np.nan
        check_k2_exact(f"grid N{n} K{k} D{d} {bad or 'finite'}",
                       torch.from_numpy(xg).cuda(),
                       torch.from_numpy(cg).cuda())

    # K3: int32 and f32 counts; none, some and all empty; K' above and at
    # the number of empty clusters; 4-byte words (D % 4 != 0, a misaligned
    # copy); counts above 2^24; K 1, 2, 8, 2,048 and 20,614
    k3_cases = [
        ("K8 D128 f32 counts", k3_inputs(8, 128, 2, seed=11), "vec16"),
        ("K8 D128 int32 counts", k3_inputs(8, 128, 2, seed=11,
                                           int_counts=True), "vec16"),
        ("K2 D128 one empty", k3_inputs(2, 128, 1, seed=15,
                                        int_counts=True), "vec16"),
        ("K1 D7 all empty", k3_inputs(1, 7, 1, seed=13, int_counts=True),
         "vec4"),
        ("K65 D3 some empty", k3_inputs(65, 3, 20, seed=14), "vec4"),
        ("K37 D37 none empty", k3_inputs(37, 37, 0, seed=16), "vec4"),
        ("K64 D128 all empty", k3_inputs(64, 128, 64, seed=17), "vec16"),
        ("K2048 D128 K'=#empty", k3_inputs(2048, 128, 100, seed=18,
                                           int_counts=True, k_reseed=100),
         "vec16"),
        ("K2048 D128 int32 above 2^24", k3_inputs(2048, 128, 30, seed=19,
                                                  int_counts=True, big=True),
         "vec16"),
        ("K14000 D128 many empty", k3_inputs(14000, 128, 900, seed=12),
         "vec16"),
        ("K20614 D128 int32", k3_inputs(20614, 128, 40, seed=20,
                                        int_counts=True), "vec16"),
        ("K20614 D132 f32", k3_inputs(20614, 132, 0, seed=23), "vec16"),
    ]
    for case, args, variant in k3_cases:
        check_k3(case, *args, variant=variant)
    s_, c_, r_ = k3_inputs(2048, 128, 100, seed=24, int_counts=True)
    check_k3("K2048 D128 misaligned copy", k3_misaligned(s_), c_, r_,
             variant="vec4")
    n_k = k3_launch_count(*k3_inputs(20614, 128, 40, seed=20,
                                     int_counts=True))
    if n_k != 1:
        raise AssertionError(f"K3 ran {n_k} kernels a call, not one")
    log("[kernels] K3: one kernel a call (torch.profiler)")

    # K23: a 1M build's first step (100 chunks of 5000, k 8), later steps
    # (many small nodes, k 2-8), a ragged D and the widest D
    import numpy as np
    rng = np.random.default_rng(30)
    for case, iters, sizes, k, d in (
            ("first step 100x5000 k8 D128", 8, [5000] * 100, 8, 128),
            ("later step 160 nodes N100-1800 k2-8 D128", 8,
             rng.integers(100, 1800, size=160).tolist(), 8, 128),
            ("ragged D37 k16", 5, rng.integers(16, 700, size=40).tolist(),
             16, 37),
            ("D1024 k5", 3, rng.integers(5, 300, size=12).tolist(), 5,
             1024)):
        errs["kmeans_batched"] = max(errs["kmeans_batched"], check_k23(
            case, iters, *k23_inputs(sizes, k, d, seed=len(sizes) + d)))

    # K2 and K23 keep a NaN distance: a NaN row and a NaN centroid
    from repro_torch.kernels import kmeans_batched as kb
    xg = np.random.default_rng(31).integers(-4, 5, size=(300, 5))
    xg = xg.astype(np.float32)
    cg = xg[:7].copy()
    xg[17, 2] = np.nan
    cg[4, 1] = np.nan
    xg_d, cg_d = torch.from_numpy(xg).cuda(), torch.from_numpy(cg).cuda()
    check_kmeans_nan("K2 NaN row + NaN centroid",
                     am.kmeans_assign_update_cuda(xg_d, cg_d),
                     am.kmeans_assign_update_plain(xg_d, cg_d))
    pts = torch.arange(300, dtype=torch.int32)
    offs = torch.tensor([0, 100, 300], dtype=torch.int32)
    ks = torch.tensor([7, 5], dtype=torch.int32)
    init = torch.zeros((2, 16), dtype=torch.int32)
    init[0, :7] = torch.tensor([3, 17, 40, 1, 9, 60, 2])   # row 17 is NaN
    init[1, :5] = torch.tensor([0, 10, 20, 30, 40])
    check_kmeans_nan("K23 NaN row + NaN centroid",
                     kb.kmeans_batched_cuda(xg_d, pts, offs, ks, init, 1),
                     kb.kmeans_batched_plain(xg_d, pts, offs, ks, init, 1))
    # an inf coordinate in sub-problem 1, away from its initial centroids:
    # the one-hot rule makes that column NaN in its other clusters' means
    xi = torch.from_numpy(np.random.default_rng(32).integers(
        -4, 5, size=(300, 5)).astype(np.float32))
    xi[150, 3] = float("inf")
    xi_d = xi.cuda()
    got = kb.kmeans_batched_cuda(xi_d, pts, offs, ks, init, 1)
    want = kb.kmeans_batched_plain(xi_d, pts, offs, ks, init, 1)
    torch.cuda.synchronize()
    if not bool(torch.isnan(want[2][1]).any()):
        raise AssertionError("K23 one-hot rule: the plain version has no "
                             "NaN centroid")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    log(f"[kernels] K23 inf coordinate: ok, "
        f"{int(torch.isnan(got[2]).sum())} NaN centroid entries, equal to "
        f"the plain version's")

    def b2(case, k2, *shape, chunks=(None, 1, 3, 128), **kw):
        e = check_b2(case, k2, *f32_inputs(*shape, **kw), chunks=chunks)
        errs["ivf_scan_topk"] = max(errs["ivf_scan_topk"], e)

    b2("main 512x128x128 B32 P16", 24, 512, 128, 128, 32, 16, seed=15,
       dead=0.05, masked=0.2, nan_dead=True)
    # one id in a low and a high cluster that query 0 probes, so the copies
    # land in different chunks; query 3 with every probe masked
    post, ids, cids, mask, q = f32_inputs(512, 128, 128, 32, 16, seed=25,
                                          dead=0.05, masked=0.1,
                                          device="cpu")
    cids[0, :2], mask[0, :2] = torch.tensor([2, 500]), True
    ids[2, 5] = ids[500, 9] = 10_000_000
    post[500, 9] = q[0] + 0.01
    mask[3] = False
    e = check_b2("dup id across chunks + masked query", 24,
                 *[a.cuda() for a in (post, ids, cids, mask, q)],
                 chunks=(None, 1, 2, 64))
    errs["ivf_scan_topk"] = max(errs["ivf_scan_topk"], e)
    for where in NAN_WHERE:
        args = list(f32_inputs(64, 128, 128, 32, 16, seed=26, dead=0.05,
                               masked=0.1, device="cpu"))
        plant_nan(*(a.numpy() for a in args[:4]), where, q=1)
        e = check_b2(f"NaN in a live row, {where} slot", 24,
                     *[a.cuda() for a in args], chunks=(None, 1, 5))
        errs["ivf_scan_topk"] = max(errs["ivf_scan_topk"], e)
    b2("ragged B13 dead+masked+dup NaN", 24, 40, 48, 24, 13, 7, seed=16,
       dead=0.3, masked=0.3, dup=True, nan_dead=True)
    b2("k2 > live candidates", 200, 9, 16, 32, 5, 3, seed=17, dead=0.5,
       masked=0.5)
    b2("D=1024 L=64 k2=256", 256, 20, 64, 1024, 3, 4, seed=18, dead=0.1)

    for case, shape, kw in (("main 512x128x128 B32 P16",
                             (512, 128, 128, 32, 16), dict(masked=0.2)),
                            ("ragged B13 P7 L48 D24",
                             (40, 48, 24, 13, 7), dict(masked=0.3))):
        post, _, cids, mask, q = f32_inputs(*shape, seed=19, **kw)
        errs["ivf_scan"] = max(errs["ivf_scan"],
                               check_b6a(case, post, cids, mask, q))
    # the ring's edges: one row, a chunk and one, a chunk boundary past
    # several; D of one float4, of 9 (one thread a row), of 256 (a warp);
    # out-of-range cluster ids (clamped) and a query with every probe masked
    for l, d in ((1, 4), (33, 36), (129, 1024), (1024, 36), (1024, 1024)):
        post, _, cids, mask, q = f32_inputs(6, l, d, 5, 4, seed=l + d,
                                            masked=0.2)
        cids[0, 1], cids[1, 2] = 9, -5
        mask[0, 1] = mask[1, 2] = True
        mask[3] = False
        errs["ivf_scan"] = max(errs["ivf_scan"], check_b6a(
            f"ring L{l} D{d} out-of-range ids + masked query", post, cids,
            mask, q))

    for case, (n, k, d) in (("build chunk 16384x20614x128",
                             (16384, 20614, 128)),
                            ("ragged 2049x65x3", (2049, 65, 3)),
                            ("ragged 1x1x5", (1, 1, 5)),
                            ("K > N 100x300x20", (100, 300, 20)),
                            ("unfused most launched 97x2x128", (97, 2, 128)),
                            ("unfused splitter 5000x8x128", (5000, 8, 128)),
                            ("unfused most work 16384x1929x128",
                             (16384, 1929, 128)),
                            ("narrow ragged 129x7x37", (129, 7, 37)),
                            ("narrow D=1024 300x8x1024", (300, 8, 1024)),
                            ("at the threshold 3000xMAXx128",
                             (3000, pw.NARROW_MAX_M, 128)),
                            ("past the threshold 3000x(MAX+1)x128",
                             (3000, pw.NARROW_MAX_M + 1, 128))):
        a, b = kmeans_inputs(n, k, d, seed=n + k)
        errs["pairwise_l2"] = max(errs["pairwise_l2"], check_b5(case, a, b))
    for n, m, d in ((1, 1, 3), (127, 2, 37), (129, 8, 128), (128, 129, 37),
                    (2, 128, 1024), (16384, 1929, 128)):
        check_b5_exact(f"{n}x{m}x{d}", n, m, d, seed=n * m + d)

    for case, shape, kw in (
            ("main union A458 L128 D128 B32", (600, 128, 128, 32, 458), {}),
            ("ragged B13 dup+out-of-range NaN row", (40, 48, 24, 13, 9),
             dict(nan_row=True)),
            ("D=1024 L=64 B5", (20, 64, 1024, 5, 7), {}),
            ("main union, qsel all false/all true rows, NaN rows",
             (600, 128, 128, 32, 458), dict(edges=True, sel=0.035)),
            ("all selected A458 L128 D128 B32", (600, 128, 128, 32, 458),
             dict(sel=1.0)),
            ("4-byte copies D37 L129 B100, edges", (50, 129, 37, 100, 9),
             dict(edges=True))):
        errs["ivf_scan_clustermajor"] = max(
            errs["ivf_scan_clustermajor"],
            check_b6b(case, *cmajor_inputs(*shape, seed=sum(shape), **kw)))
    # vec4: the same codes at 16k+4 bytes, which take the vec4 variant
    for case, shape, kw, vec4 in (
            ("main resident B32 P16 L128 D128", (600, 128, 128, 32, 16),
             dict(masked=0.2), False),
            ("main resident B32 P16 L128 D128, codes at 16k+4 bytes",
             (600, 128, 128, 32, 16), dict(masked=0.2), True),
            ("ragged B13 masked+dup+out-of-range NaN norm",
             (40, 48, 24, 13, 7), dict(masked=0.3, nan_norm=True), False),
            ("D=1024 L=64 B3", (20, 64, 1024, 3, 4), {}, False),
            ("D=1024 L=64 B3, codes at 16k+4 bytes", (20, 64, 1024, 3, 4),
             {}, True),
            ("L=1024 D=12 B3", (9, 1024, 12, 3, 4), {}, False),
            ("L=33 D=16 B5", (9, 33, 16, 5, 4), dict(masked=0.3), False),
            ("resident shape, codes at 16k+4 bytes",
             (300, 128, 128, 32, 16), dict(masked=0.2), True)):
        q8, *rest = q8_legacy_inputs(*shape, seed=sum(shape), **kw)
        errs["ivf_scan_q8"] = max(errs["ivf_scan_q8"], check_b7(
            case, vec4_codes(q8) if vec4 else q8, *rest))

    # a NaN in one live row of B6a and one input row of B5 stays NaN
    from repro_torch.kernels import ivf_scan as scan

    post, _, cids, mask, q = f32_inputs(40, 48, 24, 13, 7, seed=23)
    mask[:] = True
    post[int(cids[2, 1]), 7, 3] = float("nan")
    check_nan_kept("B6a NaN row", scan.ivf_scan_cuda(post, cids, mask, q),
                   scan.ivf_scan_plain(post, cids, mask, q))
    for m, variant in ((90, "wide"), (4, "narrow"), (4, "wide")):
        a, b = kmeans_inputs(700, m, 24, seed=24)
        a[33, 4] = float("nan")
        check_nan_kept(f"B5 NaN input row, M={m} {variant}",
                       pw.pairwise_l2_cuda(a, b, variant=variant),
                       pw.pairwise_l2_plain(a, b))
    return errs


# --------------------------------------------------------------------------
# phase 3: build a SIFT1M-sized index with the port
# --------------------------------------------------------------------------
def phase_build(work: str) -> dict:
    import numpy as np

    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.kernels.cuda_lib import LAUNCHES

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=N_BASE)
    t0 = time.perf_counter()
    x = make_vectors(spec)
    q_train, topk = make_queries(spec, 256)
    log(f"[build] corpus {x.shape} made in {time.perf_counter() - t0:.1f} s")
    cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                      coarse_per_task=5000, n_workers=2,
                      llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8))
    LAUNCHES.reset()
    t0 = time.perf_counter()
    index, llsp, report = build_index(
        x, cfg, os.path.join(work, "build"), queries=q_train,
        query_topk=np.minimum(topk, 50).astype(np.int32), device=DEVICE)
    build_s = time.perf_counter() - t0
    launches = path_launches("1M build (phase 3)")
    log(f"[build] {build_s:.1f} s stages "
        + " ".join(f"{k}={v:.1f}s" for k, v in report.stage_seconds.items())
        + f" n_clusters={report.n_clusters} "
          f"replication={report.replication:.4f} launches={launches}")
    split = split_summary(report.stage1_split)
    log(f"[build] stage 1 lockstep: {split}")
    # the splitter and enforce_size_bound's 2-means run on K23; K2 is left
    # with enforce_size_bound's reassignments, K3 with nothing
    for name in ("kmeans_batched", "kmeans_assign_update"):
        if launches[name] < 1:
            raise AssertionError(f"build never launched {name}")
    log(f"[build] launches: K23 {launches['kmeans_batched']} K2 "
        f"{launches['kmeans_assign_update']} K3 {launches['kmeans_mstep']}")
    for name in ("kmeans_assign_update", "kmeans_mstep"):
        if launches[name] > MAX_PER_NODE_LAUNCHES:
            raise AssertionError(f"build launched {name} "
                                 f"{launches[name]} times: per-node k-means "
                                 f"is back on the build's path")
    if llsp is None:
        raise AssertionError("build trained no LLSP models")
    from repro_torch.build.pipeline import index_content_hash
    digest = index_content_hash(index)[:16]
    log(f"[build] index_content_hash={digest}")
    stage2 = stage2_split(report)
    log(f"[build] stage 2 streamed: {stage2}")
    # on the card the dispatch returns with the assign in flight, so some
    # shard's load must land under the previous one's assign
    if DEVICE == "cuda" and not stage2["max_pair_overlap_s"] > 0.0:
        raise AssertionError(f"stage 2: no shard's load landed under the "
                             f"previous shard's assign: {stage2}")
    stage2["elastic"] = stage2_elastic(x, cfg, work, digest)
    log(f"[build] stage 2 elastic from the same stage-1 centroids: "
        f"{stage2['elastic']}")
    w0 = LAUNCHES.snapshot()
    compare_per_node(x, cfg, np.load(os.path.join(work, "build",
                                                  "stage1_centroids.npy")),
                     20)
    w1 = LAUNCHES.snapshot()
    witness = {k: w1[k] - w0[k] for k in w1 if w1[k] > w0[k]}
    log(f"[build] per-node witness launches: {witness}")
    return {"x": x, "spec": spec, "index": index, "llsp": llsp,
            "report": report, "build_s": build_s, "launches": launches,
            "cfg": cfg, "split": split, "witness_launches": witness,
            "stage2": stage2}


def stage2_split(report) -> dict:
    """Stage 2 of a streamed build from ``report.shard_stamps``: the
    per-shard median and p90 of load (host slice and pinning), stream (the
    copy to the card), assign (dispatch to done) and harvest (checkpoint
    write), the overlap, the bytes streamed, and the checkpoint reads plus
    ``build_postings`` after the shards."""
    import numpy as np

    from repro_torch.build.stream import pair_overlaps

    live = [t for t in report.shard_stamps if not t["resumed"]]
    if len(live) < 2:
        raise AssertionError(f"stage 2 streamed {len(live)} shards")
    parts = {"load": ("load_start", "load_end"),
             "stream": ("load_end", "stream_end"),
             "assign": ("assign_dispatch", "assign_done"),
             "harvest": ("assign_done", "harvest_end")}
    out = {"shards": len(live), "stage2_s": report.stage_seconds["stage2"],
           "postings_s": report.postings_s,
           "overlap": report.shard_overlap,
           "bytes_streamed": sum(t["bytes"] for t in live),
           "max_pair_overlap_s": max(pair_overlaps(live))}
    for name, (a, b) in parts.items():
        ms = np.array([t[b] - t[a] for t in live]) * 1e3
        out[f"{name}_ms_p50"] = float(np.percentile(ms, 50))
        out[f"{name}_ms_p90"] = float(np.percentile(ms, 90))
    return out


def stage2_elastic(x, cfg, work: str, digest: str) -> dict:
    """Stage 2 on the elastic-task branch from the streamed build's
    stage-1 centroids (copied into a workdir of its own): the index must
    hash the same; its stage-2 seconds beside the streamed branch's."""
    import shutil

    from repro_torch.build.pipeline import build_index, index_content_hash

    wd = os.path.join(work, "build-elastic")
    os.makedirs(wd)
    shutil.copy(os.path.join(work, "build", "stage1_centroids.npy"),
                os.path.join(wd, "stage1_centroids.npy"))
    index, _, rep = build_index(
        x, dataclasses.replace(cfg, stream_stage2=False), wd, device=DEVICE)
    got = index_content_hash(index)[:16]
    if got != digest or rep.resumed_stages != ["stage1"]:
        raise AssertionError(f"elastic stage 2: hash {got} (streamed "
                             f"{digest}), resumed {rep.resumed_stages}")
    return {"stage2_s": rep.stage_seconds["stage2"],
            "postings_s": rep.postings_s, "index_content_hash": got}


def split_summary(stats: list) -> dict:
    """Stage 1's lockstep groups summed: steps, sub-problems, K23 device ms
    (CUDA events, total, mean and largest per step), host seconds of
    bookkeeping and of waiting on the card, and each group's wall seconds
    (the groups run side by side; the rest of stage 1 is the merge and
    ``enforce_size_bound``)."""
    ms = [m for s in stats for m in s.kernel_ms]
    steps = sum(s.steps for s in stats)
    return {"groups": len(stats), "steps": steps,
            "steps_per_group": [s.steps for s in stats],
            "subproblems": sum(s.subproblems for s in stats),
            "k23_ms_total": sum(ms), "k23_ms_mean": sum(ms) / max(len(ms), 1),
            "k23_ms_max": max(ms, default=0.0),
            "host_bookkeeping_s": sum(s.host_s for s in stats),
            "host_wait_s": sum(s.wait_s for s in stats),
            "group_wall_s": [s.wall_s for s in stats]}


def per_cell_size_bound(x, cents, bound: int, seed: int):
    """``enforce_size_bound`` with one fused ``kmeans`` (K2, sort, K3) per
    oversized cell, on the card."""
    import numpy as np
    import torch

    from repro_torch.build.kmeans import kmeans
    from repro_torch.kernels import ops

    xd = torch.from_numpy(x).to(DEVICE)
    cents = cents.copy()
    for rnd in range(20):
        a, _, _, cnt = ops.kmeans_assign_update(
            xd, torch.from_numpy(cents).to(DEVICE))
        a, cnt = a.cpu().numpy(), cnt.cpu().numpy()
        over = np.nonzero(cnt > bound)[0]
        if over.size == 0:
            break
        order = np.argsort(a, kind="stable")
        starts = np.concatenate([[0], np.cumsum(cnt)])
        new_rows = []
        for c in over:
            sub, _, _ = kmeans(x[order[starts[c]:starts[c + 1]]], 2, iters=4,
                               seed=seed + 131 * rnd + int(c), device=DEVICE)
            cents[c] = sub[0]
            new_rows.append(sub[1])
        cents = np.concatenate([cents, np.stack(new_rows)], axis=0)
    return cents


def compare_per_node(x, cfg, stage1, n_chunks: int) -> None:
    """Stage 1 run per node on the card (K2 + sort + K3 per splitter node
    and per oversized cell) must give the lockstep build's
    stage-1 centroids bit for bit; stages 2 and 3 are deterministic, so the
    index hashes the same.  On the first chunks the lockstep splitter is
    timed beside the per-node one, and the per-node plain path on this
    machine's host CPU as a yardstick."""
    import numpy as np
    import torch

    from repro_torch.build.kmeans import balanced_hierarchical_kmeans, \
        balanced_hierarchical_kmeans_many

    per = cfg.coarse_per_task
    n_all = -(-len(x) // per)
    chunks = [x[i * per:(i + 1) * per] for i in range(n_all)]
    seeds = [cfg.seed + 1000 * i for i in range(n_all)]
    kw = dict(iters=cfg.kmeans_iters)
    t0 = time.perf_counter()
    node = [balanced_hierarchical_kmeans(c, cfg.max_cluster_size, seed=s,
                                         device=DEVICE, **kw)
            for c, s in zip(chunks, seeds)]
    torch.cuda.synchronize()
    t_node_all = time.perf_counter() - t0
    n_chunks = min(n_chunks, n_all)
    t0 = time.perf_counter()
    for c, s in zip(chunks[:n_chunks], seeds[:n_chunks]):
        balanced_hierarchical_kmeans(c, cfg.max_cluster_size, seed=s,
                                     device=DEVICE, **kw)
    torch.cuda.synchronize()
    t_node = time.perf_counter() - t0
    t0 = time.perf_counter()
    many = balanced_hierarchical_kmeans_many(
        chunks[:n_chunks], seeds[:n_chunks], cfg.max_cluster_size,
        device=DEVICE, **kw)
    t_many = time.perf_counter() - t0
    for i, ((mc, ma), (nc, na)) in enumerate(zip(many, node)):
        if not (np.array_equal(mc, nc) and np.array_equal(ma, na)):
            raise AssertionError(f"chunk {i}: the lockstep splitter differs "
                                 f"from the per-node splitter on the card")
    t0 = time.perf_counter()
    for c, s in zip(chunks[:n_chunks], seeds[:n_chunks]):
        balanced_hierarchical_kmeans(c, cfg.max_cluster_size, seed=s,
                                     device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    log(f"[build] first {n_chunks} chunks: lockstep K23 {t_many:.3f} s, "
        f"per-node K2+K3 on the card {t_node:.3f} s, bit-equal "
        f"({sum(len(c) for c, _ in many)} leaf centroids); per-node plain "
        f"path on the host CPU {t_cpu:.3f} s (host CPU, "
        f"{torch.get_num_threads()} torch threads)")
    t0 = time.perf_counter()
    want = per_cell_size_bound(
        x, np.concatenate([c for c, _ in node]).astype(np.float32),
        min(cfg.max_cluster_size, cfg.cluster_len), cfg.seed)
    t_bound = time.perf_counter() - t0
    if not np.array_equal(want, stage1):
        raise AssertionError("stage 1 per node on the card differs from the "
                             "lockstep build's stage-1 centroids")
    log(f"[build] stage 1 per node on the card (one worker): splitter "
        f"{t_node_all:.3f} s over {n_all} chunks, per-cell size bound "
        f"{t_bound:.3f} s; {want.shape[0]} centroids bit-equal to the "
        f"lockstep build's stage 1, so the index hash is the per-node "
        f"path's")


# --------------------------------------------------------------------------
# phase 4: serve through the q8 pipeline
# --------------------------------------------------------------------------
SERVE_CFG = dict(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)


def phase_serve(work: str, built: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.ivf import brute_force_topk
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import make_queries
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime.pipeline import make_quantized_pipeline, \
        rerank_overlap_efficiency

    x = built["x"]
    queries, _ = make_queries(built["spec"], N_BATCHES * BATCH, seed=7)
    batches = [(queries[i:i + BATCH], np.full(BATCH, 10, np.int32))
               for i in range(0, len(queries), BATCH)]
    scfg = SearchConfig(**SERVE_CFG)
    pipe = make_quantized_pipeline(
        built["index"], built["llsp"], scfg, vectors=x,
        flash_path=os.path.join(work, "flash-gpu.f32"), device=DEVICE)
    warm = pipe.warmup()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = pipe.run_pipelined(batches, depth=2)
    wall = time.perf_counter() - t0
    launches = path_launches("q8 streamed (phase 4)")
    ids = np.concatenate([o.ids for o in out])
    nprobe = np.concatenate([o.nprobe for o in out])
    if ids.shape != (len(queries), 10) or (ids < 0).any():
        raise AssertionError(f"served ids malformed: {ids.shape}")
    dists = np.concatenate([o.dists for o in out])
    if not np.isfinite(dists).all():
        raise AssertionError("served distances not finite")
    if launches["ivf_scan_q8_topk"] != len(batches):
        raise AssertionError(f"K1 launched {launches['ivf_scan_q8_topk']} "
                             f"times for {len(batches)} scan dispatches")
    _, true10 = brute_force_topk(torch.from_numpy(x).to(DEVICE),
                                 torch.from_numpy(queries).to(DEVICE), 10)
    true10 = true10.cpu().numpy()
    recall = recall_at_k(ids, true10)
    ceiling = probe_ceiling(pipe, batches, nprobe, true10)
    res = {**pipeline_stats(out, wall), "recall10": recall,
           "probe_ceiling": ceiling,
           "rerank_overlap": rerank_overlap_efficiency(
               [o.times for o in out]),
           "mean_nprobe": float(nprobe.mean()),
           "k1_launches": launches["ivf_scan_q8_topk"],
           "n_batches": len(batches), "warm": warm}
    res.update(scan_window_split(pipe, batches[:16]))
    log("[serve] " + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in res.items()))
    if recall < 0.95 * ceiling:
        raise AssertionError(f"recall@10 {recall} below 0.95 x the probe "
                             f"ceiling {ceiling}")
    return {"pipe": pipe, "batches": batches, "out": out, "true10": true10,
            **res}


def pipeline_stats(out, wall: float) -> dict:
    """QPS, batch latency percentiles, mean stage times, streamed rows and
    the gather/scan overlap of one pipelined run."""
    import numpy as np

    from repro_torch.runtime.pipeline import overlap_efficiency

    times = [o.times for o in out]
    lat = np.array([t.total for t in times]) * 1e3
    res = {"qps": sum(t.size for t in times) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "overlap": overlap_efficiency(times),
           "union_rows": float(np.mean([t.union_clusters for t in times]))}
    for stage, a, b in (("plan", "plan_start", "plan_end"),
                        ("gather", "gather_start", "gather_end"),
                        ("stream", "gather_end", "stream_end"),
                        ("scan", "scan_dispatch", "scan_done"),
                        ("rerank", "rerank_start", "rerank_end")):
        res[f"{stage}_ms"] = float(np.mean(
            [getattr(t, b) - getattr(t, a) for t in times]) * 1e3)
    return res


def profile_window(pipe, batches) -> dict:
    """Device busy share and the top kernels by device time over a short
    pipelined window (see :func:`profile_run`)."""
    return profile_run(lambda: pipe.run_pipelined(batches, depth=2),
                       f"{len(batches)} pipelined batches")


def scan_window_split(pipe, batches) -> dict:
    """:func:`profile_window` over phase 4's q8 pipeline, with each batch's
    scan window (``scan_dispatch`` to ``scan_done``) split on the host and
    on the card.  Host spans, from stamps this function puts around the
    pipeline's calls for the window's length: dispatch to K1's wrapper
    (the gather's join, the stream waits, the mask's copy), the wrapper
    (checks, allocations, K1's two launches), ``merge_candidate_topk``'s
    issue, the result copies' issue, the run loop's other work until the
    batch's harvest (under depth 2: the next batch's plan, prefetch and
    dispatch), and the harvest's wait for the scan.  Device ms a batch,
    from the trace: K1's scan kernel, its merge kernel, and the kernels
    that ``merge_candidate_topk`` launches (-1 where the trace shows none).
    Logged on a ``[serve] scan window`` line; returns the busy share and
    the split."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import pipeline as pl

    stamps = {k: [] for k in ("k1_in", "k1_out", "merge_out", "dispatch_out",
                              "harvest_in")}
    k1, merge = kops.ivf_scan_q8_topk, pl.merge_candidate_topk
    dispatch, harvest = pipe.dispatch, pipe.harvest

    def k1_stamped(*a, **kw):
        stamps["k1_in"].append(time.perf_counter())
        out = k1(*a, **kw)
        stamps["k1_out"].append(time.perf_counter())
        return out

    def merge_stamped(*a, **kw):
        with torch.profiler.record_function("merge_candidate_topk"):
            out = merge(*a, **kw)
        stamps["merge_out"].append(time.perf_counter())
        return out

    def dispatch_stamped(*a, **kw):
        out = dispatch(*a, **kw)
        stamps["dispatch_out"].append(time.perf_counter())
        return out

    def harvest_stamped(*a, **kw):
        stamps["harvest_in"].append(time.perf_counter())
        return harvest(*a, **kw)

    out = []
    device = {}

    def inspect(prof):
        n = len(batches)
        for part in K1_PARTS:
            device[part] = sum(
                getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages() if part in e.key) / 1e3 / n
        merged = [getattr(e, "device_time_total", 0.0) for e in prof.events()
                  if e.name == "merge_candidate_topk"
                  and not str(getattr(e, "device_type", "")).endswith("CUDA")]
        device["merge_candidate_topk"] = sum(merged) / 1e3 / n \
            if sum(merged) > 0 else -1.0
        return {}

    kops.ivf_scan_q8_topk, pl.merge_candidate_topk = k1_stamped, merge_stamped
    pipe.dispatch, pipe.harvest = dispatch_stamped, harvest_stamped
    try:
        res = profile_run(lambda: out.extend(pipe.run_pipelined(batches,
                                                                depth=2)),
                          f"{len(batches)} pipelined batches", inspect)
    finally:
        kops.ivf_scan_q8_topk, pl.merge_candidate_topk = k1, merge
        del pipe.dispatch, pipe.harvest
    times = [o.times for o in out]
    counts = {k: len(v) for k, v in stamps.items()}
    if any(c != len(times) for c in counts.values()):
        raise AssertionError(f"scan window stamps {counts} for "
                             f"{len(times)} batches")
    marks = np.array([[t.scan_dispatch for t in times], stamps["k1_in"],
                      stamps["k1_out"], stamps["merge_out"],
                      stamps["dispatch_out"], stamps["harvest_in"],
                      [t.scan_done for t in times]])
    spans = np.diff(marks, axis=0).mean(axis=1) * 1e3
    host = dict(zip(("dispatch_to_k1", "k1_wrapper", "merge_issue",
                     "copies_issue", "until_harvest", "harvest_wait"),
                    (float(v) for v in spans)))
    host["window"] = float((marks[-1] - marks[0]).mean() * 1e3)
    split = {"scan_window_host_ms": host, "scan_window_device_ms": device}
    log(f"[serve] scan window a batch over {len(times)} batches (host ms, "
        f"stamps): {host}; device ms a batch (torch.profiler): {device}")
    return {**res, **split}


def profile_run(run, what: str, inspect=None) -> dict:
    """Device busy share and the top kernels by device time over one call
    of ``run``, from torch.profiler (CUDA activity); ``inspect(prof)``, when
    given, adds its dict to the result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = device_busy_us(prof)
    if busy < 0:
        log("[profile] no device activity recorded: busy share not measured")
        return {"device_busy": -1.0}
    top = sorted((k for k in prof.key_averages()
                  if not getattr(k, "is_user_annotation", False)),
                 key=lambda k: -getattr(k, "self_device_time_total", 0.0))
    log(f"[profile] top device time over {what} "
        f"({wall_us / 1e3:.1f} ms wall): " + "; ".join(
            f"{k.key[:60]} {getattr(k, 'self_device_time_total', 0.0) / 1e3:.3f} ms"
            for k in top[:8]))
    return {"device_busy": busy / wall_us,
            **(inspect(prof) if inspect else {})}


def device_busy_us(prof) -> float:
    """Microseconds in which at least one device activity of the profile
    ran (the union of their intervals); -1 when none was recorded.  A
    ``record_function`` range also shows on the device's timeline, from
    its first kernel to its last; it is not an activity and is skipped."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return -1.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + cur_e - cur_s


def probe_ceiling(pipe, batches, nprobe, true10) -> float:
    """Recall@10 of an exact scan over the very clusters each query
    probed: the most any first pass plus re-rank could reach with this plan
    (the plan is recomputed with ``route``, which must repeat it)."""
    import numpy as np

    cids = np.concatenate([pipe.route(q, tk)[0] for q, tk in batches])
    routed_np = np.concatenate([pipe.route(q, tk)[1] for q, tk in batches])
    if not np.array_equal(routed_np, nprobe):
        raise AssertionError("route() disagrees with the served plan")
    return plan_ceiling(cids, nprobe, pipe.tier.posting_ids, true10)


def plan_ceiling(cids, nprobe, pids, true10) -> float:
    """Recall@10 of an exact scan over the first nprobe[b] clusters of
    cids[b] for every query b."""
    import numpy as np

    hits = 0
    for b in range(len(cids)):
        probed = pids[cids[b, : nprobe[b]]].ravel()
        hits += int(np.isin(true10[b], probed).sum())
    return hits / true10.size


# --------------------------------------------------------------------------
# phase 4b: the freshness merge on phase 4's q8 pipeline
# --------------------------------------------------------------------------
FRESH_CAPACITY = 65536           # delta rows: 32 MiB of f32 at D 128
FRESH_INSERTS = 4096
FRESH_DELETES = 4096


def fresh_vectors(spec, n: int, seed: int):
    """``n`` vectors drawn as the corpus is (the spec's modes and spread),
    from an explicit generator of their own."""
    import numpy as np

    modes = np.random.default_rng(spec.seed).normal(
        size=(spec.n_modes, spec.dim)).astype(np.float32)
    rng = np.random.default_rng(seed)
    which = rng.choice(spec.n_modes, size=n)
    v = modes[which] + spec.spread * rng.normal(size=(n, spec.dim))
    return v.astype(np.float32)


def fresh_deletes(true10):
    """FRESH_DELETES distinct main ids: phase 4's queries' true top-1, then
    top-2, ... (sorted)."""
    import numpy as np

    seen: dict = {}                     # insertion-ordered distinct ids
    for i in true10.T.ravel().tolist():
        if len(seen) == FRESH_DELETES:
            break
        seen.setdefault(int(i), None)
    dead = np.asarray(sorted(seen), np.int64)
    if len(dead) != FRESH_DELETES:
        raise AssertionError(f"{len(dead)} distinct ids to delete")
    return dead


def live_truth(x_dev, delta, dead, queries, k: int = 10):
    """Exact top-k ids over the live main rows and the live delta rows
    (ids: main row index, then n_main + delta row), on the card."""
    import numpy as np
    import torch

    from repro_torch.core.distance import squared_l2, topk_smallest

    allv = torch.cat([x_dev, delta])
    dead_t = torch.from_numpy(dead).to(x_dev.device).long()
    out = []
    for s in range(0, len(queries), 128):
        q = torch.from_numpy(queries[s:s + 128]).to(x_dev.device)
        d = squared_l2(q, allv)
        d[:, dead_t] = float("inf")
        out.append(topk_smallest(d, k)[1].cpu().numpy())
    return np.concatenate(out)


def phase_fresh(work: str, built: dict, served: dict) -> dict:
    """Phase 4's q8 pipeline with a freshness view attached: 4,096 seeded
    inserts, 4,096 deleted main ids (phase 4's queries' true top-1, then
    top-2, ... until 4,096 distinct), published to the card; 64 batches of
    32 with and without the merge, then a batch of self-queries.  Each
    self-query must find its minted id at rank 0, no tombstoned id may come
    back, and recall@10 against brute force over live main + delta must be
    >= 0.95 x the probe ceiling computed the same way."""
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.lifecycle import LiveFreshState

    pipe, batches = served["pipe"], served["batches"]
    x, spec = built["x"], built["spec"]
    n = x.shape[0]
    dead = fresh_deletes(served["true10"])
    ins = fresh_vectors(spec, FRESH_INSERTS, seed=4242)
    state = LiveFreshState(dim=x.shape[1], capacity=FRESH_CAPACITY, n_main=n,
                           device=DEVICE)
    minted = state.insert(ins)
    state.delete(dead)
    t0 = time.perf_counter()
    state.publish()
    publish_ms = (time.perf_counter() - t0) * 1e3
    runs = {}
    from repro_torch.kernels.cuda_lib import LAUNCHES
    try:
        for tag, source in (("without", None), ("with", state.snapshot)):
            pipe.fresh_source = source
            pipe.warmup()
            LAUNCHES.reset()
            t0 = time.perf_counter()
            out = pipe.run_pipelined(batches, depth=2)
            runs[tag] = (out, time.perf_counter() - t0)
            launches = path_launches(f"q8 streamed, freshness merge "
                                     f"{tag} (phase 4b)")
            if launches["ivf_scan_q8_topk"] != len(batches):
                raise AssertionError(f"fresh ({tag}): K1 launched "
                                     f"{launches['ivf_scan_q8_topk']} times "
                                     f"for {len(batches)} batches")
        pipe.fresh_source = state.snapshot
        self_out = pipe.run_sequential(
            [(ins[:BATCH], np.full(BATCH, 10, np.int32))])
    finally:
        pipe.fresh_source = None
    out, wall = runs["with"]
    ids = np.concatenate([o.ids for o in out])
    if any(o.fresh_seq != state.seq for o in out):
        raise AssertionError("a batch merged another snapshot")
    s_ids = np.concatenate([o.ids for o in self_out])
    s_d = np.concatenate([o.dists for o in self_out])
    want = minted[:len(s_ids)]
    if not (s_ids[:, 0] == want).all():
        bad = int((s_ids[:, 0] != want).sum())
        raise AssertionError(f"{bad} self-queries missed their minted id at "
                             f"rank 0")
    dead_set = set(dead.tolist())
    back = dead_set & set(np.concatenate([ids, s_ids]).ravel().tolist())
    if back:
        raise AssertionError(f"{len(back)} tombstoned ids came back")
    queries = np.concatenate([q for q, _ in batches])
    x_dev = torch.from_numpy(x).to(DEVICE)
    truth = live_truth(x_dev, torch.from_numpy(ins).to(DEVICE), dead,
                       queries)
    recall = recall_at_k(ids, truth)
    # the probe ceiling with the delta: the live members of the probed
    # clusters, and every live delta row (the merge scans them exactly)
    nprobe = np.concatenate([o.nprobe for o in out])
    cids = np.concatenate([pipe.route(q, tk)[0] for q, tk in batches])
    pids = pipe.tier.posting_ids
    hits = 0
    for b in range(len(queries)):
        probed = pids[cids[b, : nprobe[b]]].ravel()
        reach = np.isin(truth[b], probed) | (truth[b] >= n)
        hits += int(reach.sum())
    ceiling = hits / truth.size
    res = {"inserts": FRESH_INSERTS, "deletes": int(len(dead)),
           "capacity": FRESH_CAPACITY, "publish_ms": publish_ms,
           "recall10": recall, "probe_ceiling": ceiling,
           "self_queries": len(s_ids),
           "self_rank0_dist_max": float(s_d[:, 0].max()),
           "delta_in_results": int((ids >= n).sum())}
    for tag, (o, w) in runs.items():
        st = pipeline_stats(o, w)
        for key in ("qps", "p50_ms", "p99_ms", "scan_ms", "rerank_ms"):
            res[f"{key}_{tag}"] = st[key]
    log("[fresh] " + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in res.items()))
    if recall < 0.95 * ceiling:
        raise AssertionError(f"fresh: recall@10 {recall} below 0.95 x the "
                             f"probe ceiling {ceiling}")
    return res


# --------------------------------------------------------------------------
# phase 5: the same pipeline on the CPU (plain versions) must agree
# --------------------------------------------------------------------------
def phase_parity(work: str, built: dict, served: dict) -> dict:
    import numpy as np

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    cpu = make_quantized_pipeline(
        built["index"].to("cpu"), built["llsp"].to("cpu"),
        SearchConfig(**SERVE_CFG), vectors=built["x"],
        flash_path=os.path.join(work, "flash-cpu.f32"), device="cpu")
    sub = served["batches"][:PARITY_BATCHES]
    got = cpu.run_pipelined(sub, depth=2)
    cpu.close()
    c_ids = np.concatenate([o.ids for o in got])
    c_d = np.concatenate([o.dists for o in got])
    c_np = np.concatenate([o.nprobe for o in got])
    g = served["out"][:PARITY_BATCHES]
    g_ids = np.concatenate([o.ids for o in g])
    g_d = np.concatenate([o.dists for o in g])
    g_np = np.concatenate([o.nprobe for o in g])
    same_np = c_np == g_np
    flips = int((~same_np).sum())
    if flips > 0.02 * len(c_np):
        raise AssertionError(f"LLSP nprobe differs on {flips} queries")
    keep = np.nonzero(same_np)[0]
    candidates_match(c_d[keep], c_ids[keep], g_d[keep], g_ids[keep], 1e-5,
                     "CPU vs GPU pipeline ids")
    true = served["true10"][: len(c_ids)]
    gap = abs(recall_at_k(c_ids, true) - recall_at_k(g_ids, true))
    log(f"[parity] {len(c_ids)} queries: nprobe flips={flips}, ids match "
        f"up to ties on the rest, recall gap={gap:.4g}")
    if gap > 0.005:
        raise AssertionError(f"CPU/GPU recall gap {gap} > 0.005")
    return {"flips": flips, "recall_gap": gap}


# --------------------------------------------------------------------------
# phase 7: the resident serve path on the card
# --------------------------------------------------------------------------
def resident_plan(index, llsp, qd, tk, cfg):
    """serve_step's plan for one batch: (cids (B, P) int32, mask (B, P))."""
    import torch

    from repro_torch.core.search import centroid_scan, decide_nprobe

    cdists, cids = centroid_scan(index, qd, cfg.nprobe_max, cfg)
    nprobe = decide_nprobe(cfg, llsp, qd, tk, cdists)
    mask = (torch.arange(cfg.nprobe_max, device=qd.device)[None, :]
            < nprobe[:, None]) & (cids >= 0)
    return cids, mask


def phase_resident(built: dict, served: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.quantize import attach_quantized
    from repro_torch.core.search import SearchConfig, _auto_ncand, \
        centroid_scan, serve_leveled, serve_step
    from repro_torch.kernels import ivf_scan_q8 as q8m
    from repro_torch.kernels.cuda_lib import LAUNCHES

    index, llsp = built["index"], built["llsp"]
    batches, true10 = served["batches"], served["true10"]
    pids = index.posting_ids.cpu().numpy()
    qds = [torch.from_numpy(q).to(DEVICE) for q, _ in batches]
    tk = torch.full((BATCH,), 10, dtype=torch.int32, device=DEVICE)
    top16 = np.concatenate([centroid_scan(index, qd, 16)[1].cpu().numpy()
                            for qd in qds])

    def run(idx, cfg, what):
        serve_step(idx, llsp, qds[0], tk, cfg)            # warm
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        outs = [serve_step(idx, llsp, qd, tk, cfg) for qd in qds]
        ids = torch.cat([o["ids"] for o in outs]).cpu().numpy()
        wall = time.perf_counter() - t0
        launches = path_launches(f"resident {what} serve_step (phase 7)")
        dists = torch.cat([o["dists"] for o in outs]).cpu().numpy()
        nprobe = torch.cat([o["nprobe"] for o in outs]).cpu().numpy()
        if ids.shape != (len(qds) * BATCH, 10) or (ids < 0).any() \
                or not np.isfinite(dists).all():
            raise AssertionError(f"{what}: malformed result")
        recall = recall_at_k(ids, true10)
        ceiling = plan_ceiling(top16, nprobe, pids, true10)
        log(f"[resident] {what}: recall10={recall:.4g} "
            f"probe_ceiling={ceiling:.4g} qps={len(ids) / wall:.4g} "
            f"ms_per_batch={wall / len(qds) * 1e3:.4g} "
            f"mean_nprobe={nprobe.mean():.4g} launches={launches}")
        return {"ids": ids, "dists": dists, "nprobe": nprobe,
                "recall": recall, "ceiling": ceiling, "launches": launches,
                "ms_per_batch": wall / len(qds) * 1e3}

    def gate(res, what):
        if res["recall"] < 0.95 * res["ceiling"]:
            raise AssertionError(f"{what}: recall@10 {res['recall']} below "
                                 f"0.95 x the probe ceiling {res['ceiling']}")

    def launched(res, name, what):
        if res["launches"][name] != len(qds):
            raise AssertionError(f"{what}: {name} launched "
                                 f"{res['launches'][name]} times for "
                                 f"{len(qds)} serve_step calls")

    cfg = SearchConfig(**SERVE_CFG)
    fused = run(index, cfg, "f32 fused")
    gate(fused, "f32 fused")
    launched(fused, "ivf_scan_topk", "f32 fused")
    busy = profile_run(lambda: [serve_step(index, llsp, qd, tk, cfg)["ids"]
                                .cpu() for qd in qds[:16]],
                       "16 resident f32 serve_step calls")
    log(f"[resident] f32 fused device_busy={busy['device_busy']:.4g}")
    fused["device_busy"] = busy["device_busy"]
    legacy = run(index, dataclasses.replace(cfg, fused_topk=False),
                 "f32 legacy")
    launched(legacy, "ivf_scan", "f32 legacy")
    if not np.array_equal(legacy["nprobe"], fused["nprobe"]):
        raise AssertionError("legacy and fused plans differ")
    candidates_match(legacy["dists"], legacy["ids"], fused["dists"],
                     fused["ids"], F32_TOL, "legacy vs fused ids")

    LAUNCHES.reset()
    t0 = time.perf_counter()
    lev = [serve_leveled(index, llsp, q, tkq, cfg) for q, tkq in batches]
    lev_wall = time.perf_counter() - t0
    lev_launches = path_launches("resident serve_leveled (phase 7)")
    lev_ids = np.concatenate([r["ids"] for r in lev])
    lev_np = np.concatenate([r["nprobe"] for r in lev])
    leveled = {"recall": recall_at_k(lev_ids, true10),
               "ceiling": plan_ceiling(top16, lev_np, pids, true10)}
    log(f"[resident] serve_leveled: recall10={leveled['recall']:.4g} "
        f"probe_ceiling={leveled['ceiling']:.4g} "
        f"ms_per_batch={lev_wall / len(batches) * 1e3:.4g} "
        f"mean_nprobe={lev_np.mean():.4g} launches={lev_launches}")
    gate(leveled, "serve_leveled")
    if lev_launches["ivf_scan_topk"] < len(batches):
        raise AssertionError("serve_leveled did not run B2 per batch")

    qindex = attach_quantized(index)
    qcfg = dataclasses.replace(cfg, tier="q8")
    q8 = run(qindex, qcfg, "q8 fused (K1)")
    launched(q8, "ivf_scan_q8_topk", "q8 fused")
    cids, mask = resident_plan(qindex, llsp, qds[0], tk, qcfg)
    args = (qindex.q8, qindex.qscale, qindex.qnorm2, qindex.centroids,
            qindex.posting_ids, cids, mask, qds[0])
    k2 = _auto_ncand(10)
    gd, gi = q8m.ivf_scan_q8_topk_cuda(*args, k2=k2)
    wd, wi = q8m.ivf_scan_q8_topk_plain(*args, k2=k2)
    err = candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), Q8_TOL,
                           "K1 on the resident index")
    log(f"[resident] K1 on the resident q8 index matches its plain version "
        f"(max_abs_err={err:.3g})")
    cids, mask = resident_plan(index, llsp, qds[0], tk, cfg)
    return {"fused": fused, "legacy": legacy, "leveled": leveled, "q8": q8,
            "plan0": (cids, mask, qds[0]), "qindex": qindex,
            "index": (index.postings, index.posting_ids)}


# --------------------------------------------------------------------------
# phase 8: the streamed f32 tier
# --------------------------------------------------------------------------
def phase_streamed_f32(built: dict, served: dict, resident: dict) -> dict:
    import numpy as np

    from repro_torch.core.search import SearchConfig
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime.pipeline import PrefetchPipeline
    from repro_torch.storage.host_tier import TieredPostings

    index, llsp = built["index"], built["llsp"]
    batches = served["batches"]
    tier = TieredPostings(index.postings.cpu().numpy(),
                          index.posting_ids.cpu().numpy(), device=DEVICE)
    pipe = PrefetchPipeline(index, llsp, SearchConfig(**SERVE_CFG), tier,
                            device=DEVICE)
    warm = pipe.warmup()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = pipe.run_pipelined(batches, depth=2)
    wall = time.perf_counter() - t0
    launches = path_launches("f32 streamed (phase 8)")
    if launches["ivf_scan_topk"] != len(batches):
        raise AssertionError(f"B2 launched {launches['ivf_scan_topk']} times "
                             f"for {len(batches)} scan dispatches")
    ids = np.concatenate([o.ids for o in out])
    dists = np.concatenate([o.dists for o in out])
    nprobe = np.concatenate([o.nprobe for o in out])
    ref = resident["fused"]
    same = nprobe == ref["nprobe"]
    flips = int((~same).sum())
    if flips > 0.02 * len(nprobe):
        raise AssertionError(f"streamed and resident plans differ on "
                             f"{flips} queries")
    candidates_match(dists[same], ids[same], ref["dists"][same],
                     ref["ids"][same], F32_TOL, "streamed vs resident ids")
    res = {**pipeline_stats(out, wall), "b2_launches": launches[
        "ivf_scan_topk"], "nprobe_flips": flips, "warm": warm}
    res.update(profile_window(pipe, batches[:16]))
    log("[streamed-f32] " + " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items()) + " ids match the resident path up to ties")
    return {"pipe": pipe, "batch0": batches[0], "ids": ids, "dists": dists,
            "nprobe": nprobe, **res}


# --------------------------------------------------------------------------
# phase 9: the resident f32 path on the CPU must agree with the card
# --------------------------------------------------------------------------
def phase_cpu_resident(built: dict, served: dict, resident: dict) -> dict:
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.search import SearchConfig, serve_step

    index = built["index"].to("cpu")
    llsp = built["llsp"].to("cpu")
    cfg = SearchConfig(**SERVE_CFG)
    outs = [serve_step(index, llsp, torch.from_numpy(q),
                       torch.from_numpy(tk), cfg)
            for q, tk in served["batches"][:PARITY_BATCHES]]
    c_ids = torch.cat([o["ids"] for o in outs]).numpy()
    c_d = torch.cat([o["dists"] for o in outs]).numpy()
    c_np = torch.cat([o["nprobe"] for o in outs]).numpy()
    n = len(c_ids)
    g = resident["fused"]
    same = c_np == g["nprobe"][:n]
    flips = int((~same).sum())
    if flips > 0.02 * n:
        raise AssertionError(f"LLSP nprobe differs on {flips} queries")
    candidates_match(c_d[same], c_ids[same], g["dists"][:n][same],
                     g["ids"][:n][same], F32_TOL, "CPU vs GPU resident ids")
    true = served["true10"][:n]
    gap = abs(recall_at_k(c_ids, true) - recall_at_k(g["ids"][:n], true))
    log(f"[cpu-resident] {n} queries: nprobe flips={flips}, ids match up "
        f"to ties on the rest, recall gap={gap:.4g}")
    if gap > 0.005:
        raise AssertionError(f"CPU/GPU recall gap {gap} > 0.005")
    return {"flips": flips, "recall_gap": gap}


# --------------------------------------------------------------------------
# phase 10: the unfused build (pairwise_l2 + host float64 M-step)
# --------------------------------------------------------------------------
# (N, M, D) of every B5 launch of phase 10's unfused build, for phase 6
B5_SHAPES: list = []


def phase_unfused(work: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.ivf import brute_force_topk
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=N_UNFUSED)
    x = make_vectors(spec)
    q_train, topk = make_queries(spec, 256)
    log(f"[unfused] N={N_UNFUSED}, smaller than phase 3's: the unfused "
        f"path's host float64 scatter-add makes a 1M build slow")
    from repro_torch.kernels import pairwise_l2 as pw

    launch_b5 = pw.pairwise_l2_cuda

    def recording_b5(a, b):
        B5_SHAPES.append((a.shape[0], b.shape[0], a.shape[1]))
        return launch_b5(a, b)

    builds = {}
    for fused in (False, True):
        cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                          coarse_per_task=5000, n_workers=2,
                          fused_assign=fused,
                          llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8))
        LAUNCHES.reset()
        t0 = time.perf_counter()
        pw.pairwise_l2_cuda = launch_b5 if fused else recording_b5
        try:
            index, llsp, report = build_index(
                x, cfg, os.path.join(work, f"build-{N_UNFUSED}-{fused}"),
                queries=q_train,
                query_topk=np.minimum(topk, 50).astype(np.int32),
                device=DEVICE)
        finally:
            pw.pairwise_l2_cuda = launch_b5
        secs = time.perf_counter() - t0
        launches = path_launches(f"{'fused' if fused else 'unfused'} build "
                                 f"N={N_UNFUSED} (phase 10)")
        builds[fused] = {"index": index, "llsp": llsp, "launches": launches}
        log(f"[unfused] {'fused' if fused else 'unfused'} build: "
            f"{secs:.1f} s stages "
            + " ".join(f"{k}={v:.1f}s" for k, v in
                       report.stage_seconds.items())
            + f" n_clusters={report.n_clusters} "
              f"hash={index_content_hash(index)[:16]} launches={launches}")
    resume = stage2_partial_resume(x, os.path.join(
        work, f"build-{N_UNFUSED}-True"), builds[True]["index"])
    log(f"[unfused] fused build resumed after a deleted shard checkpoint: "
        f"{resume}")
    unf = builds[False]
    if unf["launches"]["pairwise_l2"] < 1:
        raise AssertionError("the unfused build never launched pairwise_l2")
    if len(B5_SHAPES) != unf["launches"]["pairwise_l2"]:
        raise AssertionError(f"recorded {len(B5_SHAPES)} B5 shapes for "
                             f"{unf['launches']['pairwise_l2']} launches")
    for name in ("kmeans_assign_update", "kmeans_batched"):
        if unf["launches"][name] != 0:
            raise AssertionError(f"the unfused build launched {name}")
    if builds[True]["launches"]["kmeans_batched"] < 1:
        raise AssertionError("the fused build never launched K23")
    queries, _ = make_queries(spec, PARITY_BATCHES * BATCH, seed=7)
    batches = [(queries[i:i + BATCH], np.full(BATCH, 10, np.int32))
               for i in range(0, len(queries), BATCH)]
    pipe = make_quantized_pipeline(
        unf["index"], unf["llsp"], SearchConfig(**SERVE_CFG), vectors=x,
        flash_path=os.path.join(work, "flash-unfused.f32"), device=DEVICE)
    try:
        LAUNCHES.reset()
        out = pipe.run_pipelined(batches, depth=2)
        path_launches("q8 streamed on the unfused build (phase 10)")
        ids = np.concatenate([o.ids for o in out])
        nprobe = np.concatenate([o.nprobe for o in out])
        _, true10 = brute_force_topk(torch.from_numpy(x).to(DEVICE),
                                     torch.from_numpy(queries).to(DEVICE), 10)
        true10 = true10.cpu().numpy()
        recall = recall_at_k(ids, true10)
        ceiling = probe_ceiling(pipe, batches, nprobe, true10)
    finally:
        pipe.close()
        pipe.flash.release()
    log(f"[unfused] served {len(ids)} queries through the q8 pipeline: "
        f"recall10={recall:.4g} probe_ceiling={ceiling:.4g}")
    if recall < 0.95 * ceiling:
        raise AssertionError(f"unfused build: recall@10 {recall} below 0.95 "
                             f"x the probe ceiling {ceiling}")
    return {"launches": unf["launches"], "recall": recall,
            "ceiling": ceiling}


def stage2_partial_resume(x, wd: str, index) -> dict:
    """Delete one shard checkpoint of the build in ``wd`` and build again:
    stage 1 resumes, stage 2 re-runs that shard alone
    (``stage2:partial``), and the index hashes the same."""
    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash

    shards = sorted(os.listdir(os.path.join(wd, "shards")))
    os.remove(os.path.join(wd, "shards", shards[len(shards) // 2]))
    cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                      coarse_per_task=5000, n_workers=2)
    again, _, rep = build_index(x, cfg, wd, device=DEVICE)
    want = index_content_hash(index)[:16]
    got = index_content_hash(again)[:16]
    reran = [t["shard"] for t in rep.shard_stamps if not t["resumed"]]
    if ("stage2:partial" not in rep.resumed_stages or got != want
            or len(reran) != 1):
        raise AssertionError(f"partial resume: resumed "
                             f"{rep.resumed_stages}, re-ran {reran}, hash "
                             f"{got} (before {want})")
    return {"shards": len(shards), "reran": reran,
            "resumed": rep.resumed_stages, "index_content_hash": got,
            "stage2_s": rep.stage_seconds["stage2"]}


# --------------------------------------------------------------------------
# phase 11: the serving engine at full width, under open-loop traffic
# --------------------------------------------------------------------------
ENGINE_POLICY = dict(max_batch=32, max_wait_s=0.05, shed="degrade",
                     degrade_nprobe=8, grouping="locality")
# (tag, fraction of phase 4's QPS, deadline s, quality stack on)
ENGINE_RUNS = (("a", 0.25, None, True), ("b", 0.75, 0.05, True),
               ("c", 0.25, None, False), ("d", 0.75, 0.05, False))


def engine_stack(dep, x, work: str, tag: str, quality: bool):
    """ServeEngine + DynamicBatcher over ``dep``'s pipeline with the quality
    stack of ``launch/serve.py`` (shadow lane on: one index) unless
    ``quality`` is false, tracing on, and a VersionManager bound, as
    ``run_single_node`` builds it."""
    import argparse

    from repro_torch.launch.serve import make_quality_stack
    from repro_torch.lifecycle import VersionManager
    from repro_torch.obs import Observability
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, ServeEngine

    args = argparse.Namespace(no_quality=not quality, shadow_rate=0.01,
                              duration=ENGINE_TRACE_S)
    obs = Observability(1.0, enabled=True)
    quality, harvest, slo = make_quality_stack(args, obs, vectors=x)
    batcher = DynamicBatcher(BatchPolicy(**ENGINE_POLICY), [dep.name])
    engine = ServeEngine({dep.name: dep.pipeline}, batcher, depth=2, obs=obs,
                         quality=quality)
    vm = VersionManager()
    vm.deploy(dep.name, dep.pipeline)
    vm.bind(engine)
    return {"engine": engine, "obs": obs, "quality": quality,
            "harvest": harvest, "slo": slo, "batcher": batcher,
            "health": os.path.join(work, f"health-{tag}.json"),
            "trace": os.path.join(work, f"trace-{tag}.json")}


def service_estimate_ms(batcher) -> float:
    """The batcher's service estimate for a full batch (its fixed overhead
    plus max_batch times the per-query EWMA): what admission holds each
    deadline against."""
    pol = batcher.policy
    return (pol.overhead_s + batcher.est_query_s * pol.max_batch) * 1e3


def replay_open_loop(stack, dep, what: str, rate: float, deadline_s,
                     seed: int, inserts=None) -> dict:
    """Replay one open-loop single-tenant trace (top-k 10-50) through the
    running engine, with torch.profiler (device activity only) over the
    window; returns the counts, rates and latencies of the run, the span
    over which the submitter really issued the arrivals, and the batcher's
    service estimate before and after.  ``inserts`` (an update lane, the
    insert times in s, the vectors) streams one-vector inserts into the
    lane beside the searches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime import TenantSpec, multi_tenant_trace

    engine, obs, batcher = stack["engine"], stack["obs"], stack["batcher"]
    trace = multi_tenant_trace(
        [TenantSpec(dep.name, rate, topk_lo=10, topk_hi=50,
                    deadline_s=deadline_s, n_queries=len(dep.queries))],
        ENGINE_TRACE_S, seed=seed)
    est0 = service_estimate_ms(batcher)
    LAUNCHES.reset()
    torch.cuda.synchronize()
    late = 0.0
    lane, ins_t, ins_v = inserts if inserts is not None else (None, [], [])
    j = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for arr in trace:
            while j < len(ins_t) and ins_t[j] <= arr.t:
                lane.submit_insert(ins_v[j:j + 1])
                j += 1
            lag = t0 + arr.t - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            else:
                late = max(late, -lag)
            engine.submit(dep.queries[arr.qrow], arr.topk, index=dep.name,
                          deadline_s=arr.deadline_s)
        for j in range(j, len(ins_t)):       # the stream's tail
            lane.submit_insert(ins_v[j:j + 1])
        span = time.monotonic() - t0
        st = engine.stats
        # a rejected arrival never entered the SQ (submit returned -1)
        if st.submitted + st.rejected != len(trace):
            raise AssertionError(f"{len(trace)} arrivals, {st.submitted} "
                                 f"submitted, {st.rejected} rejected")
        while st.completed < st.submitted and time.monotonic() - t0 < 120.0:
            engine.qp.poll()
            time.sleep(0.005)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
    launches = path_launches(f"engine run ({what}) (phase 11)")
    engine.qp.poll()
    busy_us = device_busy_us(prof)
    busy = busy_us / (wall * 1e6) if busy_us >= 0 else -1.0
    pct = obs.metrics.histogram("engine.latency_s").summary_ms()
    bs = batcher.stats
    served = st.completed - st.shed
    return {"offered_qps": len(trace) / ENGINE_TRACE_S,
            "arrival_span_s": span, "arrived_qps": len(trace) / span,
            "max_submit_late_ms": late * 1e3,
            "completed_qps": served / wall, "p50_ms": pct["p50_ms"],
            "p99_ms": pct["p99_ms"], "arrivals": len(trace),
            "submitted": st.submitted, "completed": st.completed,
            "shed": st.shed, "shed_admission": bs.shed_admission,
            "shed_formation": bs.shed_deadline, "degraded": st.degraded,
            "rejected": st.rejected, "failed": st.failed,
            "batches": st.batches,
            "mean_batch": served / max(st.batches, 1),
            "locality_batches": bs.locality_batches,
            "max_queue_wait_ms": bs.max_queue_wait_s * 1e3,
            "service_est_start_ms": est0,
            "service_est_end_ms": service_estimate_ms(batcher),
            "device_busy": busy, "wall_s": wall,
            "drain_s": wall - span,
            "k1_launches": launches["ivf_scan_q8_topk"]}


UPDATE_RATE = 100.0              # one-vector inserts a second in (c)
UPDATE_CAPACITY = 4096           # the lane's delta rows (2 MiB at D 128)


def attach_update_lane(stack, dep, spec):
    """An UpdateLane over a fresh LiveFreshState for ``dep``, attached to
    the stack's engine, with the pipeline reading the state's snapshots;
    returns (lane, (lane, insert times, vectors)) for a Poisson stream of
    UPDATE_RATE inserts a second over the trace, from a seed."""
    import numpy as np

    from repro_torch.lifecycle import LiveFreshState, UpdateLane

    rng = np.random.default_rng(77)
    times = np.cumsum(rng.exponential(1.0 / UPDATE_RATE,
                                      size=int(3 * UPDATE_RATE
                                               * ENGINE_TRACE_S)))
    times = times[times < ENGINE_TRACE_S]
    vecs = fresh_vectors(spec, len(times), seed=78)
    state = LiveFreshState(dim=spec.dim, capacity=UPDATE_CAPACITY,
                           n_main=spec.n, device=DEVICE)
    lane = UpdateLane(state, obs=stack["obs"])
    dep.pipeline.fresh_source = state.snapshot
    stack["engine"].add_update_lane(dep.name, lane)
    return lane, (lane, times.tolist(), vecs)


def update_lane_stats(lane, n_sent: int) -> dict:
    """The lane's counts and insert-to-visible percentiles; nothing sent
    may be lost, rejected, shed or left unapplied."""
    st = lane.stats
    vis = lane.visibility_stats()
    out = {"sent": n_sent, "submitted": st.submitted,
           "applied_inserts": st.applied_inserts, "rejected": st.rejected,
           "rejected_full": st.rejected_full, "shed": st.shed_deadline,
           "pumps": st.pumps, "publishes": st.publishes,
           "visible": vis["n_visible"], "pending": vis["n_pending"],
           "insert_to_visible_ms": vis["insert_to_visible"]}
    if (st.submitted != n_sent or st.applied_inserts != n_sent
            or st.rejected or st.rejected_full or st.shed_deadline
            or vis["n_visible"] + vis["n_pending"] != n_sent
            or vis["n_visible"] < 1):
        raise AssertionError(f"update lane lost or refused ops: {out}")
    return out


def finish_stack(stack, what: str) -> dict:
    """Stop the engine (drain), then the gates every run shares: nothing
    lost, nothing failed, one harvest record per batched completion, the
    health snapshot parses, the Perfetto export is well nested."""
    import json as _json

    from repro_torch.obs import check_well_nested, health_snapshot, \
        write_health

    engine = stack["engine"]
    engine.stop(drain=True)
    engine.qp.poll()
    st = engine.stats
    if st.submitted != st.completed or st.failed:
        raise AssertionError(f"{what}: submitted {st.submitted} != completed "
                             f"{st.completed}, failed {st.failed}")
    q, h, slo = stack["quality"], stack["harvest"], stack["slo"]
    out = {}
    if q is not None:
        q.drain()
        batched = st.completed - st.shed
        if h.appended != batched or len(h) != min(batched, h.capacity):
            raise AssertionError(f"{what}: harvest {h.appended} appended, "
                                 f"{len(h)} held, for {batched} completions")
        slo.tick()
        write_health(stack["health"], health_snapshot(
            slo=slo, quality=q, registry=stack["obs"].metrics))
        with open(stack["health"]) as f:
            doc = _json.load(f)
        summary = q.summary()
        q.close()
        out = {"harvest": len(h), "audits": summary["audits_done"],
               "proxy_p50": summary["proxy"]["p50"],
               "alerts": sorted(n for n, a in doc["alerts"].items()
                                if a["state"] == "firing")}
    doc_t = stack["obs"].trace.export(stack["trace"])
    check_well_nested(doc_t["traceEvents"])
    # the poller's host time per batch, by stage, from the trace's spans
    spans: dict = {}
    for e in doc_t["traceEvents"]:
        if e.get("ph") == "X":
            n, tot = spans.get(e["name"], (0, 0.0))
            spans[e["name"]] = (n + 1, tot + e.get("dur", 0.0))
    stage_ms = {k: tot / n / 1e3 for k, (n, tot) in sorted(spans.items())}
    svc = stack["obs"].metrics.histogram("engine.batch_service_s").summary_ms()
    return {**out, "trace_events": len(doc_t["traceEvents"]),
            "service_p50_ms": svc["p50_ms"], "service_p99_ms": svc["p99_ms"],
            "stage_ms": stage_ms}


def phase_engine(work: str, built: dict, served: dict) -> dict:
    import numpy as np

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import make_queries
    from repro_torch.launch.serve import deploy_built, probe_completions, \
        undeploy, warm_batch_sizes
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime import BatchPolicy
    from repro_torch.storage import ChunkArena

    x, spec = built["x"], built["spec"]
    scfg = SearchConfig(**SERVE_CFG, use_kernel=True, fused_topk=True)
    # the arena's default 64 MiB chunks: serve.py's 1 MiB chunk is sized for
    # its dim-32 corpora, and a flash extent of 4096 rows of D 128 is 2 MiB
    arena = ChunkArena(n_devices=12, device_bytes=1 << 30)
    probes, _ = make_queries(spec, ENGINE_PROBES, seed=7)
    dep = deploy_built(arena, spec.name, spec, os.path.join(work, "engine"),
                       8, scfg, built["index"], built["llsp"], x, probes,
                       device=DEVICE)
    pipe = dep.pipeline
    warm = warm_batch_sizes(BatchPolicy(**ENGINE_POLICY), pipe.pad_batch)
    pipe.warmup(batch_sizes=warm)
    out = {"deploy": {"clusters": dep.meta.n_clusters,
                      "extents": len(dep.meta.extents),
                      "arena_free_mib": arena.free_bytes >> 20,
                      "striping_rows": dep.striping.rows_per_shard,
                      "replicated": int((dep.replica_map.replicas[:, 1]
                                         >= 0).sum()),
                      "warm_sizes": list(warm)}}
    log(f"[engine] deployed {spec.name}: " + str(out["deploy"]))
    base = served["qps"]
    try:
        # (c) and (d) replay (a)'s and (b)'s traces without the quality
        # stack (no shadow audits over the 1M corpus, no harvest, no SLO),
        # to show what it costs at each rate
        for tag, frac, deadline, quality in ENGINE_RUNS:
            stack = engine_stack(dep, x, work, tag, quality)
            lane = inserts = None
            if tag == "c":
                lane, inserts = attach_update_lane(stack, dep, spec)
            stack["engine"].start()
            try:
                res = replay_open_loop(stack, dep, tag, frac * base, deadline,
                                       seed=31 + int(frac * 4),
                                       inserts=inserts)
                if tag == "a":
                    LAUNCHES.reset()
                    comps, rows = probe_completions(
                        stack["engine"], probes, dep.name, timeout_s=120.0)
                    probe_launches = path_launches(
                        "engine recall probes (phase 11)")["ivf_scan_q8_topk"]
            finally:
                stack["engine"].stop(drain=True)
                pipe.fresh_source = None
            res.update(finish_stack(stack, f"engine ({tag})"))
            if lane is not None:
                res["updates"] = update_lane_stats(lane, len(inserts[1]))
            res["deadline_ms"] = None if deadline is None else deadline * 1e3
            log(f"[engine] ({tag}) {frac}x phase-4 QPS: " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in res.items()))
            if res["k1_launches"] != res["batches"]:
                raise AssertionError(f"engine ({tag}): K1 launched "
                                     f"{res['k1_launches']} times for "
                                     f"{res['batches']} scan dispatches")
            if deadline is None and (res["shed"] or res["degraded"]):
                raise AssertionError(f"engine ({tag}): best-effort traffic "
                                     f"was shed {res['shed']} / degraded "
                                     f"{res['degraded']}")
            out[tag] = res
        # the engine's ids against run_sequential on the same queries
        seq = pipe.run_sequential(
            [(probes[i:i + BATCH], np.full(len(probes[i:i + BATCH]), 10,
                                           np.int32))
             for i in range(0, len(probes), BATCH)])
        if len(rows) != len(probes):
            raise AssertionError(f"engine probes: {len(rows)} of "
                                 f"{len(probes)} completed")
        s_ids = np.concatenate([o.ids for o in seq])
        s_d = np.concatenate([o.dists for o in seq])
        s_np = np.concatenate([o.nprobe for o in seq])
        e_ids = np.stack([c.ids for c in comps])
        e_d = np.stack([c.dists for c in comps])
        e_np = np.array([c.nprobe for c in comps])
        same = e_np == s_np
        flips = int((~same).sum())
        if flips > 0.02 * len(s_np):
            raise AssertionError(f"engine vs run_sequential: {flips} nprobe "
                                 f"flips")
        candidates_match(e_d[same], e_ids[same], s_d[same], s_ids[same],
                         F32_TOL, "engine vs run_sequential ids")
        true10 = dep.true10
        r_e, r_s = recall_at_k(e_ids, true10), recall_at_k(s_ids, true10)
        log(f"[engine] probes through the engine: {len(rows)} queries, "
            f"recall10={r_e:.4g} (run_sequential {r_s:.4g}), nprobe "
            f"flips={flips}, K1 launches={probe_launches}")
        if abs(r_e - r_s) > 0.005:
            raise AssertionError(f"engine recall {r_e} vs run_sequential "
                                 f"{r_s}")
        out["probe"] = {"recall10": r_e, "seq_recall10": r_s,
                        "flips": flips}
    finally:
        undeploy(arena, dep)
    arena.validate()
    return out


# --------------------------------------------------------------------------
# phase 13: the live delta rebuild on phase 3's index
# --------------------------------------------------------------------------
REBUILD_FILL = 0.05              # delta_fill_frac: below the preload's
                                 # 4,096 / 65,536 = 0.0625
REBUILD_SELF = 32                # self-queries a window
REBUILD_WAIT_S = 300.0           # bound on the swap and the epoch retire
REBUILD_TAIL_S = 2.0             # trace seconds replayed after the swap


def collect(engine, into: dict) -> None:
    """Drain the engine's CQ into ``into`` (req_id -> completion)."""
    for c in engine.qp.poll():
        into[c.req_id] = c


def await_ids(engine, comps: dict, rids, timeout_s: float = 120.0) -> None:
    """Collect completions until every request of ``rids`` has one."""
    t_end = time.monotonic() + timeout_s
    while not all(r in comps for r in rids):
        if time.monotonic() > t_end:
            raise AssertionError(f"{sum(r not in comps for r in rids)} "
                                 f"requests never completed")
        engine.qp.wait_completions(1, timeout=0.05)
        collect(engine, comps)


def window_of(c, rep) -> str:
    """Which side of the rebuild a completion landed on."""
    if c.completed < rep.t_start:
        return "before"
    return "during" if c.completed < rep.t_swapped else "after"


def submit_all(engine, name: str, queries) -> list:
    return [engine.submit(q, 10, index=name, block=True) for q in queries]


# the last phase 13 run's windows, set before its checks (read by
# tools/rebuild_gaps.py, which samples the threads' stacks over them)
REBUILD_WINDOWS: dict = {}


def rebuild_windows(rep, t_end: float) -> dict:
    """The rebuild's windows as (start, end) on the monotonic clock."""
    return {"before": (-float("inf"), rep.t_start),
            "snapshot": (rep.t_start, rep.t_snapshot),
            "build": (rep.t_snapshot, rep.t_built),
            "swap": (rep.t_built, rep.t_swapped),
            "after": (rep.t_swapped, t_end)}


def poll_gaps(drains, rep, t_end: float) -> tuple:
    """(the poller's longest gap between two SQ drains, in ms, and the
    SQ's peak length: the most submissions one drain took) for each
    rebuild window, from the engine's ``drain_log`` of (time, taken); a
    gap counts in every window it overlaps."""
    wins = rebuild_windows(rep, t_end)
    gap = {w: 0.0 for w in wins}
    peak = {w: 0 for w in wins}
    drains = list(drains)
    for (a, _), (b, _) in zip(drains, drains[1:]):
        for w, (lo, hi) in wins.items():
            if a < hi and b > lo:
                gap[w] = max(gap[w], (b - a) * 1e3)
    for t, n in drains:
        for w, (lo, hi) in wins.items():
            if lo <= t < hi:
                peak[w] = max(peak[w], n)
    return ({w: round(v, 3) for w, v in gap.items()}, peak)


def phase_rebuild(work: str, built: dict, served: dict) -> dict:
    """The live delta rebuild on phase 3's corpus and centroids (module
    doc, phase 13)."""
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k, squared_l2
    from repro_torch.core.search import SearchConfig
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.launch.serve import warm_batch_sizes
    from repro_torch.lifecycle import (
        CorpusStore, DriftMonitor, LiveFreshState, RebuildPolicy,
        RebuildScheduler, UpdateLane, VersionManager, delta_build,
        q8_rebuild_hook)
    from repro_torch.obs import Observability, check_well_nested
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, \
        ServeEngine, TenantSpec, multi_tenant_trace

    x, spec, index, cfg = built["x"], built["spec"], built["index"], \
        built["cfg"]
    n = x.shape[0]
    cents = index.centroids.cpu().numpy()
    wd = os.path.join(work, "rebuild")
    build_kw = dict(cluster_len=cfg.cluster_len, eps=cfg.closure_eps,
                    max_replicas=cfg.max_replicas,
                    per_task=cfg.coarse_per_task)
    corpus = CorpusStore(x)
    t0 = time.perf_counter()
    cold, cold_stats = delta_build(corpus.view(), cents, wd, device=DEVICE,
                                   **build_kw)
    cold_s = time.perf_counter() - t0
    if not (torch.equal(cold.postings, index.postings)
            and torch.equal(cold.posting_ids, index.posting_ids)):
        raise AssertionError("cold delta_build differs from phase 3's index")
    log(f"[rebuild] cold delta_build {cold_s:.3f} s: "
        f"{cold_stats['shards_total']} shards streamed, postings and ids "
        f"bit-equal to phase 3's index")
    # the deployment: q8 + flash re-rank over the cold build, a 65,536-row
    # delta preloaded with 4,096 inserts and 4,096 deletes
    scfg = SearchConfig(**SERVE_CFG, use_kernel=True, fused_topk=True)
    policy = BatchPolicy(**ENGINE_POLICY)
    flash_dir = os.path.join(work, "rebuild-flash")
    os.makedirs(flash_dir, exist_ok=True)
    hook = q8_rebuild_hook(corpus, built["llsp"], scfg, flash_dir=flash_dir,
                           name=spec.name,
                           warm_sizes=warm_batch_sizes(policy, 16),
                           device=DEVICE)
    state = LiveFreshState(dim=x.shape[1], capacity=FRESH_CAPACITY,
                           n_main=n, device=DEVICE)
    ins = fresh_vectors(spec, FRESH_INSERTS, seed=4343)
    dead = fresh_deletes(served["true10"])
    minted = state.insert(ins)
    state.delete(dead)
    state.publish()
    obs = Observability(1.0, enabled=True)
    drift = DriftMonitor(cents, metrics=obs.metrics, trace=obs.trace)
    near = torch.argmin(squared_l2(torch.from_numpy(ins).to(DEVICE),
                                   index.centroids), dim=1)
    drift.observe(ins, near.cpu().numpy())
    pipe0 = hook(cold, state)
    old_pids = pipe0.tier.posting_ids  # the tier drops it when it retires
    comps: dict = {}                   # req_id -> completion (main thread)
    selfq: dict = {}                   # window -> req_ids
    stamps: dict = {}                  # the hook's start and end
    own = ins[:REBUILD_SELF]

    def build_then_query(index, new_state):
        """The scheduler's hook: build the new epoch, then, before the swap,
        run the self-queries through the engine on the old epoch."""
        stamps["hook0"] = time.monotonic()
        pipe = hook(index, new_state)
        stamps["hook1"] = time.monotonic()
        selfq["during"] = submit_all(engine, spec.name, own)
        t_end = time.monotonic() + 120.0
        while not all(r in comps for r in selfq["during"]) \
                and time.monotonic() < t_end:
            time.sleep(0.01)
        stamps["selfq1"] = time.monotonic()
        return pipe

    vm = VersionManager()
    ep0 = vm.deploy(spec.name, pipe0, fresh=state)
    lane = UpdateLane(state, obs=obs)
    engine = ServeEngine({spec.name: pipe0},
                         DynamicBatcher(policy, [spec.name]), depth=2,
                         obs=obs, update_lanes={spec.name: lane},
                         drain_log=1 << 20)
    vm.bind(engine)
    sched = RebuildScheduler(
        name=spec.name, corpus=corpus, centroids=cents, workdir=wd,
        lane=lane, versions=vm, make_pipeline=build_then_query,
        cluster_len=cfg.cluster_len, closure_eps=cfg.closure_eps,
        max_replicas=cfg.max_replicas,
        policy=RebuildPolicy(delta_fill_frac=REBUILD_FILL,
                             per_task=cfg.coarse_per_task),
        drift=drift, obs=obs)
    if sched.due() != "delta_fill":
        raise AssertionError(f"rebuild not due on the preload: "
                             f"{sched.due()!r}")
    pool = np.concatenate([q for q, _ in served["batches"]])
    tenant = TenantSpec(spec.name, 0.25 * served["qps"], topk_lo=10,
                        topk_hi=50, n_queries=len(pool))
    trace = multi_tenant_trace([tenant], ENGINE_TRACE_S, seed=41)
    # traffic after the swap, whenever it comes: the same rate, 2 s
    tail = multi_tenant_trace([tenant], REBUILD_TAIL_S, seed=42)
    rng = np.random.default_rng(79)
    ins_t = np.cumsum(rng.exponential(1.0 / UPDATE_RATE, size=int(
        3 * UPDATE_RATE * ENGINE_TRACE_S)))
    ins_t = ins_t[ins_t < ENGINE_TRACE_S].tolist()
    ins_v = fresh_vectors(spec, len(ins_t), seed=80)
    search: dict = {}                  # req_id -> (pool row, topk)

    def arrive(t0, arr):
        """Submit one trace arrival at its time."""
        lag = t0 + arr.t - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        rid = engine.submit(pool[arr.qrow], arr.topk, index=spec.name)
        if rid >= 0:
            search[rid] = (arr.qrow, arr.topk)
        collect(engine, comps)

    LAUNCHES.reset()
    engine.start()
    try:
        selfq["before"] = submit_all(engine, spec.name, own)
        await_ids(engine, comps, selfq["before"])
        t0 = time.monotonic()
        j = 0
        started = False
        for arr in trace:
            if not started and time.monotonic() - t0 >= 1.0:
                sched.start(poll_s=0.05)
                started = True
            if "after" not in selfq and sched.swapped.is_set():
                selfq["after"] = submit_all(engine, spec.name, own)
            while j < len(ins_t) and ins_t[j] <= arr.t:
                lane.submit_insert(ins_v[j:j + 1])
                drift.observe(ins_v[j:j + 1])
                j += 1
            arrive(t0, arr)
        for j in range(j, len(ins_t)):
            lane.submit_insert(ins_v[j:j + 1])
        span = time.monotonic() - t0
        while not sched.swapped.wait(0.05):
            collect(engine, comps)
            if time.monotonic() - t0 > REBUILD_WAIT_S:
                raise AssertionError(f"no swap within {REBUILD_WAIT_S} s; "
                                     f"failures {sched.failures}")
        if "after" not in selfq:
            selfq["after"] = submit_all(engine, spec.name, own)
        t1 = time.monotonic()
        for arr in tail:
            arrive(t1, arr)
        await_ids(engine, comps,
                  [r for v in selfq.values() for r in v] + list(search))
        if not ep0.finalized.wait(REBUILD_WAIT_S):
            raise AssertionError("the old epoch never retired")
    finally:
        sched.stop()
        engine.stop(drain=True)
        collect(engine, comps)
    t_end = time.monotonic()
    if sched.reports:
        REBUILD_WINDOWS.update(rebuild_windows(sched.reports[0], t_end))
    torch.cuda.synchronize()
    launches = path_launches("live rebuild, both epochs (phase 13)")
    if sched.failures:
        raise AssertionError(f"rebuild attempts failed: {sched.failures}")
    if len(sched.reports) != 1:
        raise AssertionError(f"{len(sched.reports)} rebuilds, not 1")
    rep = sched.reports[0]
    pipe1 = vm.current(spec.name).pipeline
    st = engine.stats
    lane_st = update_lane_stats(lane, len(ins_t))
    checks = {
        "trigger": rep.trigger == "delta_fill", "tier": rep.tier == "q8",
        "carried": rep.carried_ops > 0,
        "reused": rep.shards_reused == cold_stats["shards_total"],
        "streamed": rep.shards_streamed == 1,
        "dropped": st.submitted - st.rejected - st.completed == 0
        and st.rejected == 0,
        "failed": st.failed == 0, "shed": st.shed == 0 and st.degraded == 0,
        "folded": rep.folded_inserts >= FRESH_INSERTS
        and rep.folded_deletes == FRESH_DELETES,
        "flash": pipe1.flash.n == n + rep.folded_inserts}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"rebuild checks {bad} failed: {rep}, "
                             f"engine {st}")
    k1 = launches["ivf_scan_q8_topk"]
    warm_new = sum(hook.warmed[1:])
    if k1 != st.batches + warm_new:
        raise AssertionError(f"rebuild: K1 launched {k1} times for "
                             f"{st.batches} batches + {warm_new} warm scans "
                             f"of the new epoch")
    # self-queries at rank 0 before, during and after; after the swap from
    # the main postings with the exact re-rank distance (0 for itself)
    for win, rids in selfq.items():
        got = np.stack([comps[r].ids for r in rids])
        miss = int((got[:, 0] != minted[:REBUILD_SELF]).sum())
        if miss:
            raise AssertionError(f"rebuild ({win}): {miss} self-queries "
                                 f"missed rank 0")
    d0 = np.array([comps[r].dists[0] for r in selfq["after"]])
    if (d0 != 0.0).any():
        raise AssertionError(f"rebuild: self-query distance after the swap "
                             f"{d0.max()}, not the exact 0")
    if any(window_of(comps[r], rep) != "during" for r in selfq["during"]):
        raise AssertionError("a 'during' self-query completed outside the "
                             "build")
    new_pids = pipe1.tier.posting_ids
    if not np.isin(minted, new_pids).all():
        raise AssertionError("folded inserts missing from the new postings")
    all_ids = np.concatenate([c.ids for c in comps.values()
                              if c.ids is not None])
    if set(dead.tolist()) & set(all_ids.tolist()):
        raise AssertionError("a tombstoned id came back")
    # a second, full-mode rebuild of the same corpus: the same postings
    tomb = np.zeros(corpus.n, bool)
    tomb[dead] = True
    t1 = time.perf_counter()
    full, _ = delta_build(corpus.view(), cents, wd, tombstone=tomb,
                          use_manifest=False, device=DEVICE, **build_kw)
    full_s = time.perf_counter() - t1
    if not (torch.equal(full.postings, pipe1.index.postings)
            and np.array_equal(full.posting_ids.cpu().numpy(), new_pids)):
        raise AssertionError("full-mode rebuild differs from the delta one")
    del full
    # recall and latency before, during and after the swap, against the
    # live corpus at the end (main + every insert, minus the deletes)
    rid_list = list(search)
    rows = np.array([search[r][0] for r in rid_list])
    tks = np.array([search[r][1] for r in rid_list], np.int32)
    truth = live_truth(torch.from_numpy(x).to(DEVICE),
                       torch.from_numpy(np.concatenate([ins, ins_v])).to(
                           DEVICE), dead, pool[rows])
    cids = np.concatenate([pipe0.route(pool[rows[i:i + 256]],
                                       tks[i:i + 256])[0]
                           for i in range(0, len(rows), 256)])
    shard_stamps = rep.stage2["shard_stamps"]
    gaps, sq_peak = poll_gaps(engine.drain_log, rep, t_end)
    if len(engine.drain_log) == engine.drain_log.maxlen \
            or max(sq_peak.values()) != st.sq_peak \
            or abs(max(gaps.values()) - st.drain_gap_max_s * 1e3) > 1e-3:
        raise AssertionError(f"rebuild: the drain log ({len(engine.drain_log)}"
                             f" drains) disagrees with the engine's stats "
                             f"{st}: {gaps}, {sq_peak}")
    res = {"cold_s": cold_s, "full_s": full_s,
           "snapshot_s": rep.t_snapshot - rep.t_start,
           "build_s": rep.t_built - rep.t_snapshot,
           "swap_s": rep.t_swapped - rep.t_built,
           "io_cut_x": rep.io_cut_x, "folded_inserts": rep.folded_inserts,
           "carried_ops": rep.carried_ops,
           "shards_streamed": rep.shards_streamed,
           "shards_reused": rep.shards_reused,
           "bytes_streamed": rep.bytes_streamed,
           "stage2_load_s": sum(s["load_end"] - s["load_start"]
                                for s in shard_stamps),
           "stage2_stream_s": sum(s["stream_end"] - s["load_end"]
                                  for s in shard_stamps),
           "stage2_assign_s": sum(s["assign_done"] - s["assign_dispatch"]
                                  for s in shard_stamps),
           "stage2_harvest_s": sum(s["harvest_end"] - s["assign_done"]
                                   for s in shard_stamps),
           "postings_s": rep.stage2["postings_s"],
           "assign_load_s": rep.stage2["assign_load_s"],
           "hook_s": stamps["hook1"] - stamps["hook0"],
           "selfq_s": stamps["selfq1"] - stamps["hook1"],
           "poll_gap_ms": gaps, "sq_peak": sq_peak,
           "offered_qps": len(trace) / ENGINE_TRACE_S,
           "arrival_span_s": span, "tail_arrivals": len(tail),
           "submitted": st.submitted,
           "completed": st.completed, "batches": st.batches,
           "k1_launches": k1, "warm_new_epoch": warm_new,
           "drift_max_shift": drift.summary()["max_shift"],
           "drift_advisories": drift.advisories, "updates": lane_st}
    low = []
    for win in ("before", "during", "after"):
        idx = [i for i, r in enumerate(rid_list)
               if window_of(comps[r], rep) == win]
        if not idx:
            low.append(f"no search completed {win}")
            continue
        ids = np.stack([comps[rid_list[i]].ids for i in idx])
        npb = [comps[rid_list[i]].nprobe for i in idx]
        pids = new_pids if win == "after" else old_pids
        first_delta = n + rep.folded_inserts if win == "after" else n
        hits = 0
        for a, i in enumerate(idx):
            probed = pids[cids[i, : npb[a]]].ravel()
            hits += int((np.isin(truth[i], probed)
                         | (truth[i] >= first_delta)).sum())
        recall = recall_at_k(ids, truth[idx])
        ceiling = hits / (len(idx) * truth.shape[1])
        lat = np.array([comps[rid_list[i]].latency for i in idx]) * 1e3
        res[win] = {"queries": len(idx), "recall10": recall,
                    "probe_ceiling": ceiling,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99))}
        if recall < 0.95 * ceiling:
            low.append(f"{win}: recall@10 {recall} below 0.95 x the probe "
                       f"ceiling {ceiling}")
    log("[rebuild] " + " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items()))
    if low:
        raise AssertionError(f"rebuild: {low}")
    check_well_nested(obs.trace.export()["traceEvents"])
    for p in (pipe0, pipe1):
        p.close()
        p.flash.release()
    return res


# --------------------------------------------------------------------------
# phase 14: the sharded fabric on phase 3's index
# --------------------------------------------------------------------------
FABRIC_SHARDS = 8
FABRIC_KILL_AT = 2.0             # seconds into the live trace
FABRIC_CLOSED = 2048             # queries of the closed-loop measurement


def fabric_sync(fab, batches) -> tuple:
    """``scan_sync`` over ``batches``: (ids, dists, nprobe, partial)."""
    import numpy as np

    outs = [fab.scan_sync(q, tk) for q, tk in batches]
    return tuple(np.concatenate([getattr(o, f) for o in outs])
                 for f in ("ids", "dists", "nprobe", "partial"))


def same_bits(a: tuple, b: tuple, what: str) -> None:
    import numpy as np

    for name, x, y in zip(("ids", "dists"), a, b):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} differ in "
                                 f"{int((x != y).any(axis=1).sum())} rows")


def fabric_closed_qps(fab, name: str, queries) -> float:
    """The rate ``fab`` sustains through the engine with every query in the
    SQ at once.  Its heartbeat never declares a shard dead: at full load a
    shard's task (numpy, the workers share one interpreter lock) can run
    longer than three ticks."""
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, ServeEngine

    fab.warmup()
    fab.start()
    engine = ServeEngine({name: fab}, DynamicBatcher(
        BatchPolicy(**ENGINE_POLICY), [name]), depth=2)
    engine.start()
    comps: dict = {}
    try:
        t0 = time.monotonic()
        rids = submit_all(engine, name, queries)
        await_ids(engine, comps, rids, timeout_s=300.0)
        qps = len(rids) / (time.monotonic() - t0)
    finally:
        engine.stop(drain=True)
        fab.close()
    st = engine.stats
    if st.completed != st.submitted or st.failed or st.partial \
            or fab.stats.failovers:
        raise AssertionError(f"fabric closed loop: {st}, failovers "
                             f"{fab.stats.failovers}")
    log(f"[fabric] closed loop: {len(queries)} queries at {qps:.1f} q/s, "
        f"tasks {fab.stats.tasks_per_shard.tolist()}, busy_s "
        f"{[round(b, 3) for b in fab.stats.busy_s.tolist()]}, hedges "
        f"{fab.stats.hedges}")
    return qps


def phase_fabric(built: dict, served: dict, streamed: dict) -> dict:
    """The fabric on phase 3's index (module doc, phase 14)."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.search import SearchConfig
    from repro_torch.distributed import FaultInjector, ShardedFabric
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, \
        ServeEngine, TenantSpec, multi_tenant_trace

    index, llsp = built["index"], built["llsp"]
    scfg = SearchConfig(**SERVE_CFG, use_kernel=True, fused_topk=True)
    batches = served["batches"][:PARITY_BATCHES]
    t0 = time.perf_counter()
    one = ShardedFabric(index, llsp, scfg, n_shards=1, device=DEVICE)
    setup1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = fabric_sync(one, batches)
    sync1_s = time.perf_counter() - t0
    one.close()
    del one
    gc.collect()
    # S = 1 against phase 8's f32 streamed path: the same probed clusters
    # scanned exactly, so ids agree up to ties where the plans agree
    nb = len(ref[0])
    same = ref[2] == streamed["nprobe"][:nb]
    flips = int((~same).sum())
    if flips > 0.02 * nb:
        raise AssertionError(f"fabric vs phase 8: {flips} nprobe flips")
    candidates_match(ref[1][same], ref[0][same], streamed["dists"][:nb][same],
                     streamed["ids"][:nb][same], F32_TOL,
                     "fabric S=1 vs the f32 streamed path")
    def s8(**kw):
        return ShardedFabric(index, llsp, scfg, n_shards=FABRIC_SHARDS,
                             n_replicas=2, device=DEVICE,
                             hot_clusters=np.arange(index.n_clusters), **kw)

    # the drill's fabric: hedging off, so every batch that holds a task on
    # the silent victim waits for the heartbeat's verdict (3 ticks of
    # 50 ms) and is requeued, whatever the traffic's timing
    t0 = time.perf_counter()
    fab = s8(hedge_after_s=30.0)
    setup8 = time.perf_counter() - t0
    out = {"setup_s": {"S1": setup1, f"S{FABRIC_SHARDS}": setup8},
           "sync1_s": sync1_s, "flips_vs_phase8": flips}
    try:
        same_bits(fabric_sync(fab, batches), ref,
                  f"scan_sync S={FABRIC_SHARDS} vs S=1")
        log(f"[fabric] scan_sync S={FABRIC_SHARDS} R=2 bit-equal to S=1 on "
            f"{nb} queries; S=1 matches phase 8 up to ties ({flips} nprobe "
            f"flips); setup {setup1:.2f} / {setup8:.2f} s")
        name = built["spec"].name
        pool = np.concatenate([q for q, _ in served["batches"]])
        closed_qps = fabric_closed_qps(s8(miss_threshold=1 << 30), name,
                                       pool[:FABRIC_CLOSED])
        rate = 0.5 * closed_qps
        fab.warmup()
        fab.start()
        engine = ServeEngine({name: fab}, DynamicBatcher(
            BatchPolicy(**ENGINE_POLICY), [name]), depth=2)
        engine.start()
        comps: dict = {}
        LAUNCHES.reset()
        try:
            trace = multi_tenant_trace(
                [TenantSpec(name, rate, topk_lo=10, topk_hi=50,
                            n_queries=len(pool))], ENGINE_TRACE_S, seed=43)
            inj = FaultInjector(seed=0).kill(FABRIC_KILL_AT, shard=1)
            fab.injector = inj
            live: list = []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                inj.arm(t0)
                for arr in trace:
                    lag = t0 + arr.t - time.monotonic()
                    if lag > 0:
                        time.sleep(lag)
                    live.append(engine.submit(pool[arr.qrow], arr.topk,
                                              index=name))
                    collect(engine, comps)
                span = time.monotonic() - t0
                await_ids(engine, comps, [r for r in live if r >= 0],
                          timeout_s=300.0)
                wall = time.monotonic() - t0
                torch.cuda.synchronize()
        finally:
            engine.stop(drain=True)
            fab.stop()
            collect(engine, comps)
        launches = path_launches("fabric drill (phase 14)")
        st, fs = engine.stats, fab.stats
        retired = fab.epochs[1].finalized.wait(60.0) \
            and fab.nodes[1].tier.released
        lat = np.array([comps[r].latency for r in live if r >= 0]) * 1e3
        busy_us = device_busy_us(prof)
        out.update({
            "closed_qps": closed_qps, "offered_qps": len(trace) /
            ENGINE_TRACE_S, "arrival_span_s": span, "wall_s": wall,
            "submitted": st.submitted, "completed": st.completed,
            "rejected": st.rejected, "partial": st.partial,
            "failed": st.failed, "shed": st.shed,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "kills": [(k, s) for _, k, s in inj.log],
            "failovers": fs.failovers, "timeouts": fs.timeouts,
            "hedges": fs.hedges, "requeued": fs.requeued_tasks,
            "dead_replies": fs.dead_replies,
            "tasks_per_shard": fs.tasks_per_shard.tolist(),
            "busy_s_per_shard": [round(b, 4) for b in fs.busy_s.tolist()],
            "planner_device_busy": (busy_us / (wall * 1e6)
                                    if busy_us >= 0 else -1.0),
            "retired": bool(retired)})
        log("[fabric] " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in out.items()))
        checks = {
            "dropped": st.submitted - st.rejected - st.completed == 0
            and st.rejected == 0,
            "partial": st.partial == 0 and fs.partial_queries == 0,
            "failed": st.failed == 0, "timeouts": fs.timeouts == 0,
            "kill": out["kills"] == [("kill", 1)],
            "failover": [f["shard"] for f in fs.failovers] == [1]
            and fs.failovers[0]["lost"] == 0,
            "retired": retired,
            "no kernel": not any(launches.values())}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"fabric drill checks {bad} failed")
        same_bits(fabric_sync(fab, batches), ref,
                  "scan_sync after the failover vs S=1")
        log(f"[fabric] after the failover scan_sync is bit-equal to S=1")
    finally:
        fab.close()
    return out


# --------------------------------------------------------------------------
# phase 15: the mesh (sharded serve f32 and q8, the sharded Lloyd step, the
# collectives) on torch.distributed, and the graph baseline
# --------------------------------------------------------------------------
MESH_A_BACKEND = "nccl"          # (a): one rank, one card
MESH_MODEL = 4                   # (b): clusters padded to a multiple of it
MESH_TIMEOUT_S = 300             # each spawn's bound
ONLINE_CFG = dict(k=100, nprobe_max=256, pruning="none")   # serve_online's
ONLINE_BATCHES, ONLINE_BATCH = 8, 512                      # query params
LLOYD_ROWS = 1 << 20             # rows a rank: 2^24 over 16 data shards
LLOYD_K = 4096                   # k_coarse of the build_step cell
LLOYD_RANKS = 4
GRAPH_N, GRAPH_Q = 10_000, 64
MIND_ROWS, MIND_DIM, MIND_SEQ = 1 << 22, 64, 50     # (f): MIND's table
TRAIN_BATCH = 65536              # the recsys train_batch shape


def mesh_write(path: str, arrays: dict) -> None:
    import numpy as np

    os.makedirs(path, exist_ok=True)
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), a)


def mesh_launches(results, what: str) -> dict:
    """Sum the ranks' launch counts of one job into ``PATH_RUNS``; returns
    the kernels that launched."""
    total: dict = {}
    for r in results:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    PATH_RUNS[what] = total
    return {k: v for k, v in total.items() if v}


def mesh_agreement(res, ref: dict, tol: float, what: str,
                   max_flips: float) -> dict:
    """Ids up to ties on the queries whose nprobe agrees with ``ref``'s;
    the share of nprobe flips at most ``max_flips``."""
    import numpy as np

    same = res["nprobe"] == ref["nprobe"]
    flips = float((~same).mean())
    if flips > max_flips:
        raise AssertionError(f"{what}: nprobe flips {flips} > {max_flips}")
    candidates_match(res["dists"][same], res["ids"][same],
                     ref["dists"][same], ref["ids"][same], tol, what)
    return {"flips": flips, "n_flips": int((~same).sum())}


def phase_mesh(work: str, built: dict, served: dict, resident: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.search import SearchConfig, serve_step
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    if DEVICE == "cuda":
        cuda_lib.library()           # built here, before any rank loads it
    index, qindex, llsp = built["index"], resident["qindex"], built["llsp"]
    batches, true10 = served["batches"], served["true10"]
    mw = os.path.join(work, "mesh")
    arrays = {"centroids": index.centroids, "postings": index.postings,
              "posting_ids": index.posting_ids, "q8": qindex.q8,
              "qscale": qindex.qscale, "qnorm2": qindex.qnorm2}
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    queries = np.concatenate([q for q, _ in batches])
    topk = np.concatenate([tk for _, tk in batches])
    c = arrays["centroids"].shape[0]
    pad = -c % MESH_MODEL
    padded = {
        "centroids": np.concatenate([arrays["centroids"], np.full(
            (pad, arrays["centroids"].shape[1]), 1e6, np.float32)]),
        **{k: np.concatenate([arrays[k], np.zeros(
            (pad, *arrays[k].shape[1:]), arrays[k].dtype)])
           for k in ("postings", "q8", "qnorm2")},
        "qscale": np.concatenate([arrays["qscale"],
                                  np.ones((pad, 1, 1), np.float32)]),
        "posting_ids": np.concatenate([arrays["posting_ids"], np.full(
            (pad, arrays["posting_ids"].shape[1]), -1, np.int32)])}
    spec = built["spec"]
    from repro_torch.data.synthetic import make_queries

    online_q, _ = make_queries(spec, ONLINE_BATCHES * ONLINE_BATCH, seed=9)
    online_tk = np.full(len(online_q), ONLINE_CFG["k"], np.int32)
    # one copy serves (a) and (b): the padded clusters' centroids lie at
    # 1e6, so no query probes them
    pb = os.path.join(mw, "b")
    t0 = time.perf_counter()
    mesh_write(pb, {**padded, "queries": queries, "topk": topk,
                    "online": online_q, "online_topk": online_tk})
    mesh_jobs.save_llsp(os.path.join(pb, "llsp.npz"), llsp)
    del arrays, padded
    log(f"[mesh] wrote the index (C={c}, padded to {c + pad} for model "
        f"{MESH_MODEL}) in {time.perf_counter() - t0:.1f} s")
    serve_cfg = dict(SERVE_CFG, use_kernel=True)
    engines = (("f32", False, resident["fused"]),
               ("f32", True, resident["fused"]),
               ("q8", False, resident["q8"]))

    def serve_jobs(path, shape):
        return [{"kind": "serve", "shape": shape, "work": path,
                 "engine": e, "cfg": dict(serve_cfg, shard_centroids=sc),
                 "batch": BATCH} for e, sc, _ in engines]

    def line(tag, r, ref, extra):
        return (f"[mesh] {tag}: ms_per_batch={r['ms_per_batch']:.4g} "
                f"(phase 7: {ref['ms_per_batch']:.4g}) "
                f"collectives_share_replayed="
                f"{r['collective_share_replay']:.4g} " + extra)

    # ---- (a) one rank, NCCL --------------------------------------------
    t0 = time.perf_counter()
    res_a = spawn(mesh_jobs.run, (1,), ("data",), backend=MESH_A_BACKEND,
                  device=DEVICE, args=(serve_jobs(pb, (1, 1)),),
                  timeout_s=MESH_TIMEOUT_S)[0]
    spawn_a = time.perf_counter() - t0
    out = {"a": [], "b": {}}
    for (e, sc, ref), r in zip(engines, res_a):
        tag = f"{e}{' shard_centroids' if sc else ''}"
        launches = mesh_launches([r], f"mesh (a) {tag} (phase 15)")
        if not np.array_equal(r["nprobe"], ref["nprobe"]):
            raise AssertionError(f"mesh (a) {tag}: nprobe differs from "
                                 f"phase 7")
        err = candidates_match(r["dists"], r["ids"], ref["dists"],
                               ref["ids"], F32_TOL if e == "f32" else Q8_TOL,
                               f"mesh (a) {tag} vs phase 7")
        recall = recall_at_k(r["ids"], true10)
        log(line(f"(a) 1 rank {MESH_A_BACKEND} {tag}", r, ref,
                 f"nprobe_flips=0 max_abs_err={err:.3g} "
                 f"recall10={recall:.4g} launches={launches}"))
        out["a"].append({"tag": tag, "ms": r["ms_per_batch"],
                         "share": r["collective_share_replay"],
                         "recall": recall})
    log(f"[mesh] (a) spawn and run {spawn_a:.1f} s")

    # ---- (b), (c), (d): four gloo ranks sharing the card ----------------
    from repro_torch.data.synthetic import make_vectors

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    # one seeded draw a rank's block, four at once (numpy's fills release
    # the interpreter lock)
    with ThreadPoolExecutor(LLOYD_RANKS) as pool:
        x = np.concatenate(list(pool.map(
            lambda r: make_vectors(dataclasses.replace(
                spec, n=LLOYD_ROWS, seed=41 + r)), range(LLOYD_RANKS))))
    rng = np.random.default_rng(43)
    cents = x[np.sort(rng.choice(len(x), LLOYD_K, replace=False))].copy()
    mesh_write(os.path.join(mw, "c"), {"x": x, "cents": cents})
    log(f"[mesh] (c) {x.shape} rows drawn and written in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(32, 8)).astype(np.float32),
            "b": [rng.normal(size=(64,)).astype(np.float32)]}
    from repro_torch.data.synthetic import recsys_batch

    t0 = time.perf_counter()
    mind_table = np.random.default_rng(51).standard_normal(
        (MIND_ROWS, MIND_DIM), dtype=np.float32)
    mind_ids = recsys_batch(TRAIN_BATCH, 1, MIND_ROWS, seq_len=MIND_SEQ,
                            seed=52)["hist_ids"]
    mesh_write(os.path.join(mw, "f"), {"table": mind_table, "ids": mind_ids})
    log(f"[mesh] (f) MIND's table {mind_table.shape} and train_batch history "
        f"ids {mind_ids.shape} drawn and written in "
        f"{time.perf_counter() - t0:.1f} s")
    jobs = (serve_jobs(pb, (2, 2)) + serve_jobs(pb, (1, MESH_MODEL))
            + [{"kind": "serve", "shape": (1, MESH_MODEL), "work": pb,
                "engine": "q8", "cfg": dict(ONLINE_CFG, use_kernel=True),
                "batch": ONLINE_BATCH, "queries": "online",
                "topk": "online_topk"},
               {"kind": "kmeans", "shape": (LLOYD_RANKS, 1), "steps": 3,
                "work": os.path.join(mw, "c")},
               {"kind": "kmeans", "shape": (LLOYD_RANKS, 1), "fused": False,
                "warm": False, "work": os.path.join(mw, "c")},
               {"kind": "collectives", "shape": (LLOYD_RANKS, 1),
                "tree": tree, "bucket_bytes": 128},
               {"kind": "recsys", "shape": (1, MESH_MODEL),
                "work": os.path.join(mw, "f"), "embedding": True}])
    t0 = time.perf_counter()
    res4 = spawn(mesh_jobs.run, (4,), ("data",), backend="gloo",
                 device=DEVICE, args=(jobs,), timeout_s=MESH_TIMEOUT_S)
    spawn_b = time.perf_counter() - t0
    by_job = list(zip(*res4))                    # job -> the ranks' results
    staged = by_job[0][0]["host_staged"]
    log(f"[mesh] (b)-(d) 4 gloo processes time-sharing one card: spawn "
        f"and run {spawn_b:.1f} s; collectives staged through host memory: "
        f"{staged}")
    for j, (shape, (e, sc, ref)) in enumerate(
            [(s, eng) for s in ((2, 2), (1, MESH_MODEL)) for eng in engines]):
        ranks = by_job[j]
        r = ranks[0]
        tag = f"{shape[0]}x{shape[1]} {e}{' shard_centroids' if sc else ''}"
        launches = mesh_launches(ranks, f"mesh (b) {tag} (phase 15)")
        agree = mesh_agreement(r, ref, F32_TOL if e == "f32" else Q8_TOL,
                               f"mesh (b) {tag} vs phase 7", 0.02)
        recall = recall_at_k(r["ids"], true10)
        if abs(recall - ref["recall"]) > 0.005:
            raise AssertionError(f"mesh (b) {tag}: recall@10 {recall} vs "
                                 f"phase 7's {ref['recall']}")
        log(line(f"(b) 4 processes time-sharing one H100 {tag}", r, ref,
                 f"nprobe_flips={agree['n_flips']} ({agree['flips']:.4g}) "
                 f"recall10={recall:.4g} (phase 7: {ref['recall']:.4g}) "
                 f"launches={launches}"))
        out["b"][tag] = {"ms": r["ms_per_batch"],
                         "share": r["collective_share_replay"],
                         "recall": recall,
                         **agree}
    # serve_online's query parameters against serve_step at that config
    j = 2 * len(engines)
    r = by_job[j][0]
    launches = mesh_launches(by_job[j], "mesh (b) serve_online q8 "
                                        "(phase 15)")
    ocfg = SearchConfig(**ONLINE_CFG, tier="q8")
    qd = torch.from_numpy(online_q).to(DEVICE)
    tkd = torch.from_numpy(online_tk).to(DEVICE)
    want = [serve_step(qindex, None, qd[s:s + ONLINE_BATCH],
                       tkd[s:s + ONLINE_BATCH], ocfg)
            for s in range(0, len(online_q), ONLINE_BATCH)]
    want = {k: torch.cat([w[k] for w in want]).cpu().numpy()
            for k in ("ids", "dists", "nprobe")}
    if not (r["nprobe"] == ONLINE_CFG["nprobe_max"]).all():
        raise AssertionError("serve_online pass: nprobe below nprobe_max")
    err = candidates_match(r["dists"], r["ids"], want["dists"], want["ids"],
                           Q8_TOL, "mesh (b) serve_online q8 vs serve_step")
    log(f"[mesh] (b) 4 processes time-sharing one H100 1x{MESH_MODEL} q8 at "
        f"serve_online's parameters (k=100, P=256, k2=200, "
        f"{ONLINE_BATCHES} batches of {ONLINE_BATCH}): ms_per_batch="
        f"{r['ms_per_batch']:.4g} collectives_share_replayed="
        f"{r['collective_share_replay']:.4g} ids equal serve_step's up to "
        f"ties "
        f"(max_abs_err={err:.3g}) launches={launches}")
    out["online"] = {"ms": r["ms_per_batch"],
                     "share": r["collective_share_replay"]}

    # ---- (c) the sharded Lloyd step against one process -----------------
    fused_r, unfused_r = by_job[j + 1], by_job[j + 2]
    launches = mesh_launches(fused_r, "mesh (c) kmeans_sharded_step "
                                      "(phase 15)")
    mesh_launches(unfused_r, "mesh (c) unfused step (phase 15)")
    from repro_torch.kernels import ops as kops

    xd = torch.from_numpy(x).to(DEVICE)
    cd = torch.from_numpy(cents).to(DEVICE)
    _, _, sums, counts = kops.kmeans_assign_update(xd, cd)
    cf = counts.to(torch.float32)[:, None]
    want_c = torch.where(cf > 0, sums / torch.clamp_min(cf, 1.0), cd)
    want_c = want_c.cpu().numpy()
    counts = counts.cpu().numpy()
    single_ms = time_ms(lambda: kops.kmeans_assign_update(xd, cd), n=3,
                        warm=1) if DEVICE == "cuda" else float("nan")
    del xd
    r = fused_r[0]
    if not np.array_equal(r["counts"], counts):
        raise AssertionError("mesh (c): counts differ from one process's")
    np.testing.assert_allclose(r["centroids"], want_c, rtol=1e-5, atol=1e-5,
                               err_msg="mesh (c) centroids")
    dc = float(np.abs(r["centroids"] - want_c).max())
    u = unfused_r[0]
    moved = int(np.abs(u["counts"].astype(np.int64) - counts).sum())
    du = float(np.abs(u["centroids"] - r["centroids"]).max())
    if moved > 1e-3 * len(x):
        raise AssertionError(f"mesh (c): the unfused step moved {moved} "
                             f"rows against the fused one")
    log(f"[mesh] (c) 4 processes time-sharing one H100, mesh "
        f"({LLOYD_RANKS}, 1), {LLOYD_ROWS} x {x.shape[1]} rows a rank, "
        f"K={LLOYD_K}: ms_per_step={r['ms_per_step']:.4g} (one process's K2 "
        f"over all {len(x)} rows: {single_ms:.4g} ms) counts equal, "
        f"max_abs_err={dc:.3g}; unfused (one-hot) ms_per_step="
        f"{u['ms_per_step']:.4g}, count L1 {moved} against fused, max "
        f"centroid diff {du:.3g}; launches={launches}")
    out["c"] = {"ms": r["ms_per_step"], "single_k2_ms": single_ms,
                "err": dc, "unfused_ms": u["ms_per_step"], "moved": moved}

    # ---- (d) collectives on the card's tensors over the gloo group ------
    worst = [0.0, 0.0]
    for rr in by_job[j + 3]:
        for g, w in zip(_leaves(rr["compressed"]), _leaves(tree)):
            np.testing.assert_allclose(g, w, atol=3e-2)
            worst[0] = max(worst[0], float(np.abs(g - w).max()))
        for g, w in zip(_leaves(rr["bucketed"]), _leaves(tree)):
            w = w * (LLOYD_RANKS + 1) / 2
            np.testing.assert_allclose(g, w, atol=1e-5)
            worst[1] = max(worst[1], float(np.abs(g - w).max()))
    log(f"[mesh] (d) compressed_psum_tree max_abs_err={worst[0]:.3g} "
        f"(atol 3e-2), bucketed_psum max_abs_err={worst[1]:.3g} (atol "
        f"1e-5) over {LLOYD_RANKS} gloo ranks, staged={staged}")
    out["d"] = {"compressed": worst[0], "bucketed": worst[1]}
    out["f"] = mesh_recsys(by_job[j + 4], os.path.join(mw, "f"), mind_table,
                           mind_ids, staged)
    del mind_table

    # ---- (e) the graph baseline's kNN pass on the card ------------------
    from repro_torch.core.graph_baseline import batch_search, \
        build_nsw_graph
    from repro_torch.core.ivf import brute_force_topk

    t0 = time.perf_counter()
    xs = built["x"][:GRAPH_N]
    g = build_nsw_graph(xs, degree=24, device=DEVICE)
    build_s = time.perf_counter() - t0
    gq = queries[:GRAPH_Q]
    _, gt = brute_force_topk(torch.from_numpy(xs).to(DEVICE),
                             torch.from_numpy(gq).to(DEVICE), 10)
    ids, st = batch_search(g, gq, 10, beam=64)
    grecall = recall_at_k(ids, gt.cpu().numpy())
    log(f"[mesh] (e) build_nsw_graph {GRAPH_N} rows degree 24 in "
        f"{build_s:.1f} s; recall10={grecall:.4g} hops={st.hops} "
        f"evals={st.evals} over {GRAPH_Q} queries")
    if not (grecall > 0.7 and st.hops > 10):
        raise AssertionError(f"graph baseline: recall {grecall}, hops "
                             f"{st.hops}")
    out["e"] = {"recall": grecall, "hops": st.hops, "build_s": build_s}
    out["gh"] = mesh_lm_gnn(work, CARD[0])
    mesh_runs = [v for k, v in PATH_RUNS.items() if k.startswith("mesh ")]
    out["launches"] = {k: sum(r[k] for r in mesh_runs) for k in mesh_runs[0]}
    log(f"[mesh] phase 15 launches over every rank: {out['launches']}")
    if DEVICE == "cuda":
        for name in ("ivf_scan_q8_topk", "ivf_scan_topk",
                     "kmeans_assign_update"):
            if out["launches"][name] < 1:
                raise AssertionError(f"phase 15 never launched {name}")
        for name in NO_PATH:
            if out["launches"][name]:
                raise AssertionError(f"phase 15 launched {name}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 15 {out['seconds']:.1f} s")
    return out


MOE_TOKENS = (2, 4096)           # phase 15 (g): qwen2-moe's prefill batch
MOE_CAPACITY = 4.0
MOE_BF16_TOL = 2e-2              # four bf16 roundings of partial sums on
                                 # each side (2^-8 each), of the scale
ROWDP_TOL = 1e-4                 # phase 15 (h)


def rowdp_graph(n: int, e: int, shards: int, seed: int):
    """Edges whose dst fall e / shards in each shard's row range, sorted by
    dst (the data pipeline's contract for ``forward_rowdp``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows, per = n // shards, e // shards
    dst = np.concatenate([rng.integers(r * rows, (r + 1) * rows, size=per)
                          for r in range(shards)]).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def mesh_lm_gnn(work: str, card: str) -> dict:
    """Phase 15 (g) and (h): expert parallelism of one full-width qwen2-moe
    MoE layer, and GraphCast's row-sharded forward at minibatch_lg's
    sizes, each at mesh (1, 4) over four gloo processes sharing the card,
    against one process on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.gnn import forward, init_params
    from repro_torch.models.lm.moe import moe_ffn, moe_param_shapes

    path = os.path.join(work, "mesh", "gh")
    os.makedirs(path, exist_ok=True)
    # capacity 4 (tests/test_multidevice.py part 3): no expert overflows,
    # so the two sides route alike; at the config's 1.25 they may not, as
    # the capacity race's float32 key keeps a token's probability only for
    # the lowest expert ids (ROADMAP section 3), and a rank's local ids
    # are lower than the global ones
    lcfg = get("qwen2_moe").config
    lcfg = dataclasses.replace(lcfg, moe=dataclasses.replace(
        lcfg.moe, capacity_factor=MOE_CAPACITY))
    moe, d = lcfg.moe, lcfg.d_model
    g = torch.Generator().manual_seed(43)
    layer = {}
    for k, s in sorted(moe_param_shapes(moe, d, (), lcfg.dtype).items()):
        x = torch.randn(s.shape, generator=g) / np.sqrt(s.shape[-2])
        layer[k] = x.to(s.dtype)
    torch.save(layer, os.path.join(path, "moe_layer.pt"))
    x = (torch.randn((*MOE_TOKENS, d), generator=g)).to(torch.bfloat16)
    np.save(os.path.join(path, "x.npy"), x.float().numpy())
    gcfg = get("graphcast").config
    shape = get("graphcast").shapes["minibatch_lg"]
    n, e, f = (shape.get(k) for k in ("n_nodes", "n_edges", "d_feat"))
    src, dst = rowdp_graph(n, e, 4, seed=47)
    feats = np.random.default_rng(53).normal(size=(n, f)).astype(np.float32)
    gparams = init_params(gcfg, f, torch.Generator().manual_seed(59), "cpu")
    torch.save(gparams, os.path.join(path, "gnn.pt"))
    mesh_write(path, {"node_feats": feats, "src": src, "dst": dst})
    jobs = [{"kind": "moe", "work": path, "cfg": lcfg, "params": "moe_layer",
             "layer": True, "out": "moe_bf16", "shape": (1, 4)},
            {"kind": "moe", "work": path, "cfg": lcfg, "params": "moe_layer",
             "layer": True, "dtype": torch.float32, "out": "moe_f32",
             "shape": (1, 4)},
            {"kind": "gnn_rowdp", "work": path, "cfg": gcfg, "params": "gnn",
             "out": "rowdp", "shape": (1, 4)}]
    t0 = time.perf_counter()
    ranks = spawn(mesh_jobs.run, (1, 4), ("data", "model"), backend="gloo",
                  device=DEVICE, args=(jobs,), timeout_s=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    by_job = list(zip(*ranks))
    for i, what in enumerate(("mesh (g) MoE bf16", "mesh (g) MoE f32",
                              "mesh (h) GraphCast row-DP")):
        mesh_launches(by_job[i], f"{what} (phase 15)")
    out = {"spawn_s": spawn_s}
    dev_layer = {k: v.to(DEVICE) for k, v in layer.items()}
    with torch.no_grad():
        from repro_torch.models.lm.moe import router

        _, _, top_e = router(x.to(DEVICE), dev_layer, moe)
        load = int(torch.bincount(top_e.reshape(-1), minlength=moe.e).max())
        cap = int(np.ceil(x.shape[0] * x.shape[1] * moe.top_k / moe.e
                          * moe.capacity_factor))
        if load > cap:
            raise AssertionError(f"mesh (g): an expert overflows ({load} > "
                                 f"{cap}): the sides may route apart")
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            lp = dev_layer if dt == torch.bfloat16 else {
                k: v.float() for k, v in dev_layer.items()}
            want = moe_ffn(x.to(DEVICE, dt), lp, moe, None).float().cpu()
            got = torch.from_numpy(np.load(os.path.join(path,
                                                        f"moe_{tag}.npy")))
            err = rel_err(got, want)
            if tag == "f32":
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=2e-3, atol=2e-3,
                                           err_msg="mesh (g) f32")
            elif err >= MOE_BF16_TOL:
                raise AssertionError(f"mesh (g) bf16: {err}")
            out[f"g_{tag}"] = {"rel": err, "seconds": max(
                r["seconds"] for r in by_job[0 if tag == "bf16" else 1])}
        del dev_layer, lp
        from repro_torch.distributed.collectives import tree_map

        gp = tree_map(lambda t: t.to(DEVICE), gparams)
        t1 = time.perf_counter()
        want = forward(gp, torch.from_numpy(feats).to(DEVICE),
                       torch.from_numpy(src).to(DEVICE),
                       torch.from_numpy(dst).to(DEVICE), gcfg).cpu().numpy()
        dense_s = time.perf_counter() - t1
    got = np.load(os.path.join(path, "rowdp.npy"))
    np.testing.assert_allclose(got, want, rtol=ROWDP_TOL, atol=ROWDP_TOL,
                               err_msg="mesh (h) forward_rowdp")
    out["h"] = {"max_abs_err": float(np.abs(got - want).max()),
                "seconds": max(r["seconds"] for r in by_job[2]),
                "dense_s": dense_s}
    log(f"[mesh] (g) one qwen2-moe MoE layer at its published widths (64 "
        f"experts, 16 a rank, d 2048, d_ff 1408, 4 shared) over "
        f"{MOE_TOKENS[0]} x {MOE_TOKENS[1]} tokens (capacity factor "
        f"{MOE_CAPACITY}: largest expert load {load} of {cap}), 4 processes "
        f"time-sharing one {card}, mesh (1, 4): bf16 against one process "
        f"{out['g_bf16']['rel']:.3g} of the scale (< {MOE_BF16_TOL}), a "
        f"float32 copy within rtol 2e-3 ({out['g_f32']['rel']:.3g}); "
        f"{out['g_bf16']['seconds']:.3f} s a rank (bf16)")
    log(f"[mesh] (h) GraphCast forward_rowdp at mesh (1, 4), {n} nodes, {e} "
        f"dst-sorted edges, d_feat {f}, 16 layers of 512: against the "
        f"dense forward max_abs_err {out['h']['max_abs_err']:.3g} (< "
        f"{ROWDP_TOL}); {out['h']['seconds']:.3f} s a rank, dense "
        f"{dense_s:.3f} s; spawn {spawn_s:.1f} s")
    return out


def mesh_recsys(ranks, path: str, table, ids, staged: bool) -> dict:
    """Phase 15 (f): the four ranks' sharded lookup and bag over MIND's
    table against one process's unsharded functions on the card: the
    lookup bit-equal (one rank holds each row, the others add zeros), the
    bag within rtol 1e-5 and atol 1e-5 (tests/test_multidevice.py part
    2's)."""
    import numpy as np
    import torch

    from repro_torch.models.recsys import embedding_bag, embedding_lookup

    mesh_launches(ranks, "mesh (f) recsys tables (phase 15)")
    td = torch.from_numpy(table).to(DEVICE)
    idd = torch.from_numpy(ids).to(DEVICE)
    with torch.no_grad():
        want = embedding_lookup(td, idd)
        got = torch.from_numpy(np.load(os.path.join(path, "lookup.npy"))
                               ).to(DEVICE)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("mesh (f): the sharded lookup is not "
                                 "bit-equal to the unsharded one")
        del got, want
        want = embedding_bag(td, idd).cpu().numpy()
    got = np.load(os.path.join(path, "bag.npy"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               err_msg="mesh (f) bag")
    err = float(np.abs(got - want).max())
    secs = {k: max(r["seconds"][k] for r in ranks)
            for k in ("lookup", "bag")}
    log(f"[mesh] (f) 4 processes time-sharing one H100, mesh (1, "
        f"{MESH_MODEL}), MIND's table {table.shape[0]} x {table.shape[1]} "
        f"({table.shape[0] // MESH_MODEL} rows, "
        f"{table.nbytes // MESH_MODEL >> 20} MiB a rank), ids "
        f"{ids.shape}: embedding_lookup_sharded bit-equal to the unsharded "
        f"lookup in {secs['lookup']:.3f} s, embedding_bag_sharded within "
        f"rtol 1e-5 (max_abs_err={err:.3g}) in {secs['bag']:.3f} s "
        f"(slowest rank, the staged all-reduce included; staged={staged})")
    return {"lookup_s": secs["lookup"], "bag_s": secs["bag"], "bag_err": err}


def _leaves(tree) -> list:
    from repro_torch.distributed.collectives import tree_flatten

    return tree_flatten(tree)[0]


# --------------------------------------------------------------------------
# phase 12: the port's CLI with the reference's own defaults
# --------------------------------------------------------------------------
def phase_cli(work: str) -> dict:
    import re

    outs = {k: os.path.join(work, f"cli-{k}") for k in
            ("health.json", "harvest.npz", "trace.json")}
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           DEVICE, "--indexes", "2", "--duration", "6", "--n", str(CLI_N),
           "--fail-shard", "3",
           "--rebuild", "--health-out", outs["health.json"],
           "--harvest-out", outs["harvest.npz"],
           "--trace-out", outs["trace.json"]]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    text = proc.stdout
    for line in text.splitlines():
        if line.startswith(("[deploy]", "[serve] replaying", "[fault]",
                            "[swap]", "[health]", "[done]", "[batcher]",
                            "[quality]")):
            log(f"[cli] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}:\n"
                             f"{text[-3000:]}\n{proc.stderr[-3000:]}")
    done = [ln for ln in text.splitlines() if ln.startswith("[done]")]
    swap = [ln for ln in text.splitlines()
            if ln.startswith("[swap]") and "retired=True" in ln]
    hb = re.search(r"heartbeat-detected failures at shutdown: \[([\d, ]*)\]"
                   r" \(injected: \[([\d, ]*)\]\)", text)
    recalls = dict(re.findall(r"\[health\] (\w+): recall@10=([\d.]+)",
                              text))
    if not done or not swap:
        raise AssertionError("serve CLI: no [done] line or no retired swap")
    injected = [int(v) for v in hb.group(2).split(",")] if hb else []
    detected = [int(v) for v in hb.group(1).split(",") if v.strip()] \
        if hb else []
    if not injected or not set(injected) <= set(detected):
        raise AssertionError(f"serve CLI: heartbeat reported {detected} for "
                             f"injected {injected}")
    if set(recalls) != {"sift", "redsrch"}:
        raise AssertionError(f"serve CLI: recall lines for {recalls}")
    log(f"[cli] {done[0]} ({secs:.1f} s including three builds of "
        f"{CLI_N} vectors)")
    return {"seconds": secs, "done": done[0], "recalls": recalls,
            "heartbeat_failed": detected, "fabric": phase_cli_fabric(env)}


def phase_cli_fabric(env: dict) -> dict:
    """The CLI's fabric mode: 4 shards, R = 2, a seeded kill at 2 s; it
    must exit 0, fail over once with nothing lost and drop nothing."""
    import re

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           DEVICE, "--shards", "4", "--replicas", "2", "--kill-shard-at",
           "2", "--duration", "6", "--n", str(CLI_N)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    text = proc.stdout
    for line in text.splitlines():
        if line.startswith(("[deploy]", "[fabric]", "[fault]", "[health]",
                            "[quality]")):
            log(f"[cli-fabric] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"fabric CLI exited {proc.returncode}:\n"
                             f"{text[-3000:]}\n{proc.stderr[-3000:]}")
    health = re.search(r"\[health\] \w+: recall@10=([\d.]+) through the "
                       r"engine, dropped=(-?\d+)", text)
    fails = re.findall(r"\[fault\] shard (\d+) failed over: (\d+) clusters "
                       r"moved to replicas, (\d+) lost", text)
    done = re.search(r"\[fabric\] (\d+) completions .* shed=(\d+) "
                     r"partial=(\d+) failed=(\d+)", text)
    if not health or int(health.group(2)) != 0:
        raise AssertionError("fabric CLI: dropped requests or no [health]")
    if len(fails) != 1 or fails[0][2] != "0":
        raise AssertionError(f"fabric CLI: failovers {fails}")
    if not done or done.group(3) != "0" or done.group(4) != "0":
        raise AssertionError("fabric CLI: partial or failed completions")
    log(f"[cli-fabric] exit 0 in {secs:.1f} s, one failover, 0 lost, "
        f"0 dropped")
    return {"seconds": secs, "recall10": float(health.group(1)),
            "completions": int(done.group(1)), "failover": fails[0]}


# --------------------------------------------------------------------------
# phase 16: train the recsys family, then index and serve MIND's table
# --------------------------------------------------------------------------
# (arch, batch): the published widths and configured table rows, at the
# train_batch shape; xDeepFM's CIN keeps a (B, 200 * 39, 10) f32 tensor a
# layer for the backward (about 20 GB at 65,536), so its batch is cut
TRAIN_ARCHS = (("mind", TRAIN_BATCH), ("din", TRAIN_BATCH),
               ("wide_deep", TRAIN_BATCH), ("xdeepfm", 8192))
TRAIN_STEPS, TRAIN_FIXED = 10, 6
PARITY_ROWS, PARITY_BATCH = 2048, 512
STEP_PARAM_ATOL = 1e-5           # tests/_torch_port.py: the parameters
                                 # after one AdamW step, two implementations
TRAIN_CLI_TIMEOUT_S = 300
RETRIEVAL_ITEMS = (8192, 1 << 20)


def _tree_bytes(tree) -> int:
    from repro_torch.distributed.collectives import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def _same_bits(a, b) -> bool:
    """Every leaf of two trees of 4-byte tensors equal bit for bit."""
    import torch

    from repro_torch.distributed.collectives import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(la, lb))


def gather_determinism(table, ids, up) -> dict:
    """For each way to gather rows, whether the gradient of the gathered
    rows (times ``up``) comes out bit-equal in two runs on the card, with
    the ids' repeats (Zipf: hot rows in every batch); the port's
    ``embedding.gather_rows`` is ``F.embedding``."""
    import torch
    import torch.nn.functional as F

    ways = {"F.embedding": lambda t, i: F.embedding(i, t),
            "index_select": lambda t, i: torch.index_select(
                t, 0, i.reshape(-1)).reshape(*i.shape, -1),
            "advanced indexing": lambda t, i: t[i]}
    out = {}
    for name, fn in ways.items():
        grads = []
        for _ in range(2):
            t = table.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(t, ids), t, grad_outputs=up)
            grads.append(g.view(torch.int32))
        out[name] = {"bit_equal": bool(torch.equal(*grads)),
                     "rows_differing": int((grads[0] != grads[1]).any(dim=1)
                                           .sum())}
        del grads
    return out


def train_arch(name: str, batch: int, card: str) -> dict:
    """Phase 16 (a) for one arch at its published widths: 6 steps on one
    fixed batch from the seeded init (the loss must fall), then
    ``TRAIN_STEPS`` steps of fresh batches, each timed by CUDA events;
    for MIND also two identical steps from one state (bit-equal) and the
    gathers' determinism."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models.recsys import init_params, make_train_step
    from repro_torch.optim import adamw

    cfg = get(name).config
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_params(cfg, gen, DEVICE)
    opt = adamw.init(params)
    state_bytes = _tree_bytes(params) + _tree_bytes(opt)
    step = make_train_step(cfg)

    def feed(seed):
        b = recsys_batch(batch, cfg.n_sparse, cfg.table_rows,
                         seq_len=cfg.seq_len, seed=seed)
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}

    fixed = feed(10_000)
    fixed_losses = []
    for _ in range(TRAIN_FIXED):
        params, opt, m = step(params, opt, fixed)
        fixed_losses.append(float(m["loss"]))
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"train {name}: the loss on one fixed batch "
                             f"did not fall: {fixed_losses}")
    losses, ms = [], []
    for s in range(TRAIN_STEPS):
        b = feed(s)
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        params, opt, m = step(params, opt, b)
        e.record()
        e.synchronize()
        ms.append(a.elapsed_time(e))
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {name}: a loss is not finite")
    out = {"batch": batch, "table": [cfg.table_rows, cfg.embed_dim],
           "ms_first": ms[0], "ms_median": float(np.median(ms[1:])),
           "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": state_bytes, "fixed_losses": fixed_losses,
           "losses": losses}
    if name == "mind":
        x = step(params, opt, b)[:2]
        y = step(params, opt, b)[:2]
        out["two_steps_bit_equal"] = _same_bits(x, y)
        if not out["two_steps_bit_equal"]:
            raise AssertionError("train mind: two identical full-width "
                                 "steps differ")
        del x, y
        ids = b["hist_ids"].long()
        up = torch.randn((*ids.shape, cfg.embed_dim), device=DEVICE,
                         generator=gen)
        out["gathers"] = gather_determinism(params["table"], ids, up)
        if not out["gathers"]["F.embedding"]["bit_equal"]:
            raise AssertionError("F.embedding's backward is not "
                                 "deterministic on this card")
        del up
    log(f"[train] {name} at its published widths (table "
        f"{cfg.table_rows} x {cfg.embed_dim}, batch {batch}) on {card}: "
        f"ms a step {out['ms_median']:.4g} (median of steps 2-"
        f"{TRAIN_STEPS}; the first {ms[0]:.4g}), max_memory_allocated "
        f"{out['peak_bytes'] / 2**30:.3f} GiB, state (params + mu + nu) "
        f"{state_bytes / 2**30:.3f} GiB; fixed-batch losses "
        f"{[float(f'{v:.9g}') for v in fixed_losses]}; losses "
        f"{[float(f'{v:.6g}') for v in losses]}")
    if name == "mind":
        log(f"[train] mind: two identical full-width steps from one state "
            f"bit-equal (params and AdamWState): "
            f"{out['two_steps_bit_equal']}; gathers' backward over "
            f"{tuple(ids.shape)} Zipf ids, two runs: {out['gathers']}")
    return out


def train_parity(name: str) -> dict:
    """Phase 16 (b): one step at a 2,048-row table on the card against the
    same step on the CPU (plain torch) from the same params and batch."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed.collectives import tree_flatten, tree_map
    from repro_torch.models.recsys import init_params, make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get(name).config, table_rows=PARITY_ROWS)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = {k: torch.from_numpy(v) for k, v in recsys_batch(
        PARITY_BATCH, cfg.n_sparse, PARITY_ROWS, seq_len=cfg.seq_len,
        seed=3).items()}
    step = make_train_step(cfg)
    wp, wo, wm = step(params, adamw.init(params), b)
    cuda = lambda t: t.to(DEVICE)
    cp = tree_map(cuda, params)
    gp, go, gm = step(cp, adamw.init(cp), tree_map(cuda, b))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5, err_msg=f"parity {name} loss")
    err = 0.0
    for got, want in ((gp, wp), (go.mu, wo.mu), (go.nu, wo.nu)):
        for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            g = g.cpu().numpy()
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=STEP_PARAM_ATOL,
                                       err_msg=f"parity {name}")
            err = max(err, float(np.abs(g - w.numpy()).max()))
    return {"loss_card": float(gm["loss"]), "loss_cpu": float(wm["loss"]),
            "max_abs_err": err}


def train_cli(work: str, card: str) -> dict:
    """Phase 16 (c): the training CLI in subprocesses: a run that fails at
    step 12, its relaunch (which must resume from step 10), and an
    uninterrupted run whose final checkpoint's files the relaunch's must
    equal byte for byte."""
    import filecmp

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "mind", "--steps", "20", "--ckpt-every", "5", "--device", DEVICE]
    wa, wb = os.path.join(work, "train-a"), os.path.join(work, "train-b")
    runs = {}
    for tag, extra in (("fail", ["--fail-at", "12", "--workdir", wa]),
                       ("resume", ["--workdir", wa]),
                       ("straight", ["--workdir", wb])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=ROOT, env=env,
                              capture_output=True, text=True,
                              timeout=TRAIN_CLI_TIMEOUT_S)
        runs[tag] = (proc, time.perf_counter() - t0)
    fail, resume, straight = (runs[k][0] for k in ("fail", "resume",
                                                   "straight"))
    if fail.returncode == 0 or "simulated node failure at step 12" \
            not in fail.stderr:
        raise AssertionError(f"train CLI --fail-at 12 exited "
                             f"{fail.returncode}:\n{fail.stderr[-2000:]}")
    for tag in ("resume", "straight"):
        proc = runs[tag][0]
        if proc.returncode != 0:
            raise AssertionError(f"train CLI ({tag}) exited "
                                 f"{proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
    if "resumed from step 10 (cursor=10)" not in resume.stdout:
        raise AssertionError(f"train CLI: no resume line:\n{resume.stdout}")
    a = os.path.join(wa, "ckpt", "step_00000020")
    b = os.path.join(wb, "ckpt", "step_00000020")
    names = sorted(os.listdir(b))
    same, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    if mismatch or errors or sorted(os.listdir(a)) != names:
        raise AssertionError(f"train CLI: the resumed run's checkpoint "
                             f"differs in {mismatch + errors}")
    for line in resume.stdout.splitlines():
        log(f"[train-cli] {line}")
    log(f"[train-cli] on {card}: --fail-at 12 exited {fail.returncode} "
        f"({runs['fail'][1]:.1f} s); the relaunch resumed from step 10 "
        f"({runs['resume'][1]:.1f} s); its step-20 checkpoint, {len(same)} "
        f"files, byte-equal to an uninterrupted run's "
        f"({runs['straight'][1]:.1f} s)")
    return {"files": len(same),
            "seconds": {k: v[1] for k, v in runs.items()}}


def train_retrieval(card: str) -> dict:
    """Phase 16 (d): ``examples/train_retrieval_torch.py``'s ``run`` at its
    defaults and at a million items: recall@50 must equal the probe
    ceiling (an exact f32 scan reaches it), and K23, K2 and B2 must
    launch."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "train_retrieval_torch",
        os.path.join(ROOT, "examples", "train_retrieval_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    from repro_torch.kernels.cuda_lib import LAUNCHES

    out = {}
    LAUNCHES.reset()
    for items in RETRIEVAL_ITEMS:
        r = twin.run(types.SimpleNamespace(steps=500, items=items,
                                           device=DEVICE))
        if abs(r["recall"] - r["ceiling"]) > 1e-6:
            raise AssertionError(f"train retrieval at {items} items: "
                                 f"recall@50 {r['recall']} vs its probe "
                                 f"ceiling {r['ceiling']}")
        log(f"[train] retrieval flow at {items} items on {card}: final "
            f"loss {r['final_loss']:.4f} after {r['steps']} steps "
            f"({r['train_s']:.1f} s), {r['n_clusters']} clusters built in "
            f"{r['build_s']:.2f} s, recall@50 {r['recall']:.4f} = probe "
            f"ceiling {r['ceiling']:.4f}, scanned fraction "
            f"{r['scanned_frac']:.4f}")
        out[items] = r
    launches = path_launches("train retrieval (phase 16)")
    for k in ("kmeans_batched", "kmeans_assign_update", "ivf_scan_topk"):
        if DEVICE == "cuda" and launches[k] < 1:
            raise AssertionError(f"the retrieval flow never launched {k}")
    log(f"[train] retrieval flow launches: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out


def phase_train(work: str, card: str) -> dict:
    t0 = time.perf_counter()
    out = {"archs": {name: train_arch(name, batch, card)
                     for name, batch in TRAIN_ARCHS}}
    out["parity"] = {name: train_parity(name) for name, _ in TRAIN_ARCHS}
    log(f"[train] one step at {PARITY_ROWS} rows, batch {PARITY_BATCH}, "
        f"card against CPU: loss within rtol 1e-5, params and moments "
        f"within atol {STEP_PARAM_ATOL}: "
        f"{ {k: v['max_abs_err'] for k, v in out['parity'].items()} }")
    out["cli"] = train_cli(work, card)
    out["retrieval"] = train_retrieval(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 16 {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 17: the LM and GNN families at their published widths
# --------------------------------------------------------------------------
# (arch, batch, layers kept: None = all); llama4-scout's 48 layers hold
# 213.5 GB of bf16 weights, 8 of them 37.3 GB
LM_SERVE = (("phi4_mini", 2, None), ("gemma3_12b", 2, None),
            ("gemma3_27b", 2, None), ("qwen2_moe", 2, None),
            ("llama4_scout", 2, 8))
LM_PREFILL = 4096                # prefill_32k's 32 x 32,768, cut
LM_DECODE = 64                   # decode steps after the prefill: past a
                                 # 1,024-slot ring 4 times over
LM_ORACLE_CHUNK = 64             # 4,160 % 1,024 != 0 would run one chunk
LM_PREFILL_TOL = 2e-3            # tests/test_models_lm.py:88
LM_DECODE_TOL = 5e-2             # tests/test_models_lm.py:75, bf16
# the share of decode rows whose MoE picks all equal the oracle's, at
# least: near the share measured (25 and 116 of 128 rows, PR 23 calls 7-9,
# the same in each); the other rows must flip at a near tie (route_checks)
LM_ROUTE_AGREE = {"qwen2_moe": 0.18, "llama4_scout": 0.875}
LM_TRAIN = "phi4_mini"
LM_TRAIN_BATCHES = (4, 2, 1)     # train_4k's 256 x 4,096, cut: the
                                 # largest that fits
LM_TRAIN_STEPS = 6
GNN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_SEEDS = 1024                 # minibatch_lg's seed nodes
OGB_EDGES = 1 << 22              # ogb_products' 61,859,140 edges, cut
LM_PARITY_TOL = 1e-5             # tests/test_torch_lm.py's TOL


def rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want| (the reference's
    decode and prefill checks)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def cuda_ms(fn):
    """(fn's result, its milliseconds by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, a.elapsed_time(e)


def bits_digest(tree) -> list:
    """For each leaf, two int64 sums of its raw bits (plain and weighted by
    position mod 65,521), row block by row block: equal digests for a
    repeated step, where one flipped bit changes them."""
    import torch

    from repro_torch.distributed.collectives import tree_flatten

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_flatten(tree)[0]:
        v = t.contiguous().view(ints[t.element_size()]).reshape(-1)
        s1 = s2 = 0
        for i in range(0, v.numel(), 1 << 24):
            blk = v[i:i + (1 << 24)].to(torch.int64)
            w = (torch.arange(i, i + blk.numel(), device=blk.device)
                 % 65521) + 1
            s1 += int(blk.sum())
            s2 += int((blk * w).sum())
        out.append((s1, s2))
    return out


def contracted_fan_in(params: dict, cfg) -> None:
    """Rescale the attention projections in place from the reference's
    init rule to normal / sqrt(the contracted dim).  The rule takes
    shape[-2] as the fan-in, which for wq (D, H, Dh) is H: at the
    published widths q and k reach ~10-20 an element and the scores
    ~100-200, so softmax is a hard argmax, a one-ulp bf16 difference
    between a decode step's (B, D) products and the forward's (B x S, D)
    ones flips it (phi4-mini's decode came out 1.45 of the scale from its
    oracle, PR 23 call 2), and through 32 layers the gradient's norm
    reaches ~1e11, so the clipped AdamW step moves nothing (phi4-mini's
    fixed-batch loss stayed 12.21276 for 6 steps, call 5).  With the
    contracted dims the scores are ~1."""
    import math

    h, kv, d = cfg.heads_padded, cfg.n_kv, cfg.d_model
    for group in ("layers", "tail"):
        g = params.get(group)
        if g is None:
            continue
        g["wq"].mul_(math.sqrt(h / d))
        g["wk"].mul_(math.sqrt(kv / d))
        g["wv"].mul_(math.sqrt(kv / d))
        g["wo"].mul_(math.sqrt(1.0 / h))


class recorded_routes(list):
    """While open, each MoE router call's record from position ``start``
    on (the ``models/lm/moe.py`` router, wrapped): the expert picks (B, S,
    K) sorted, the router's input (B, S, D) and float32 logits (B, S, E),
    and the largest 2-norm of the router's expert columns."""

    def __init__(self, cfg, start: int = 0):
        super().__init__()
        self.on, self.start = cfg.moe is not None, start

    def __enter__(self):
        import torch

        from repro_torch.models.lm import moe

        if self.on:
            self._router = moe.router

            def router(x, lp, cfg):
                out = self._router(x, lp, cfg)
                st = self.start
                self.append({
                    "picks": torch.sort(out[2][:, st:], dim=-1).values,
                    "x": x[:, st:].float(),
                    "logits": out[0][:, st:].clone(),
                    "w_norm": lp["moe_router"].float().norm(dim=0).max()})
                return out
            moe.router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models.lm import moe

        if self.on:
            moe.router = self._router
        return False


def route_checks(dec_routes: list, orc_routes: list, moe) -> dict:
    """Each decode row's MoE routing against the oracle's at its position.
    A row agrees where every layer's picks equal the oracle's.  Up to and
    including the first layer whose picks differ, the router's input and
    its float32 logits are held to the oracle's (``x_err``, ``logit_err``:
    the largest over those layers of |decode - oracle| over the largest
    |oracle|).  At that layer the oracle's gap between its k-th and
    (k+1)-th logit must lie within what the drift moved two logits apart:
    a swap of a chosen expert a for an unchosen c needs logit_a - logit_c
    <= |d_a| + |d_c| <= 2 max |d| (``moved``), and the logits' drift must
    lie within what the input's drift can give, |d_e| <= ||dx||_2 *
    ||W_e||_2 (``reach``), each plus a float32 rounding slack of 1e-5 of
    the largest logit.  Returns arrays over (step, row) and the flipped
    rows' records.
    """
    import torch

    if not orc_routes:
        return {"agree": None, "x_err": 0.0, "logit_err": 0.0, "flips": [],
                "bad": 0}
    n, k = moe.n_experts, moe.top_k
    # (T, L, B, ...) for the decode steps and the oracle's positions
    stack = lambda key: torch.stack([torch.stack([d[key][:, 0]
                                                  for d in steps])
                                     for steps in dec_routes])
    pd, xd, ld = stack("picks"), stack("x"), stack("logits")[..., :n]
    po, xo, lo = (torch.stack([o[key] for o in orc_routes]).permute(
        2, 0, 1, 3) for key in ("picks", "x", "logits"))
    lo = lo[..., :n]
    w_norm = torch.stack([o["w_norm"] for o in orc_routes])      # (L,)
    flipped = (pd != po).any(-1)                                 # (T, L, B)
    agree = ~flipped.any(1)                                      # (T, B)
    before = flipped.long().cumsum(1) - flipped.long() == 0      # <= first
    first = flipped & before
    rel = lambda a, b: (a - b).abs().amax(-1) / (b.abs().amax(-1) + 1e-6)
    x_err, logit_err = rel(xd, xo), rel(ld, lo)
    srt = lo.sort(dim=-1, descending=True).values
    gap = srt[..., k - 1] - srt[..., k]
    moved = (ld - lo).abs().amax(-1)
    reach = (xd - xo).norm(dim=-1) * w_norm[None, :, None]
    slack = 1e-5 * lo.abs().amax(-1)
    bad = first & ((gap > 2 * moved + slack) | (moved > reach + slack))
    flips = [{"step": int(t), "row": int(b), "layer": int(l),
              "gap": float(gap[t, l, b]), "moved": float(moved[t, l, b]),
              "reach": float(reach[t, l, b]),
              "x_err": float(x_err[t, l, b])}
             for t, l, b in first.nonzero().tolist()]
    return {"agree": agree.cpu(), "x_err": float(x_err[before].max()),
            "logit_err": float(logit_err[before].max()), "flips": flips,
            "bad": int(bad.sum())}


def extend_cache(cache: dict, cfg, batch: int, seq: int) -> dict:
    """Caches of ``seq`` positions holding a prefill's: the global caches
    copied into the first positions, the rings as they are."""
    from repro_torch.models.lm import init_cache

    out = init_cache(cfg, batch, seq, device=DEVICE)
    for k, v in cache.items():
        if k in ("k_g", "v_g"):
            out[k][:, :, :v.shape[2]] = v
        else:
            out[k].copy_(v)
    return out


def lm_serve(name: str, batch: int, layers, card: str) -> dict:
    """Phase 17 (a) for one arch: prefill, 64 decode steps and the
    forward oracle at the published widths in bf16 (module doc)."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import decode_step, forward, init_params, \
        prefill_step

    cfg = get(name).config
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    free_card()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    contracted_fan_in(params, cfg)
    weights = _tree_bytes(params)
    total = LM_PREFILL + LM_DECODE
    toks = torch.from_numpy(token_batch(batch, total, cfg.vocab, seed=17)
                            ).to(DEVICE)
    pre = toks[:, :LM_PREFILL]
    emb = params["embed"]
    with torch.no_grad():
        (logits, cache), pre_ms = cuda_ms(
            lambda: prefill_step(params, pre, cfg))
        # the reference's prefill check: forward over the same tokens at
        # the config's own chunking and capacity
        h = forward(params, pre, cfg)
        want = (h[:, -1] @ emb.T).float()
        pre_err = rel_err(logits, want)
        del h, want
        # decode and its oracle with MoE capacity 16, so that routing
        # cannot differ between a batch of 2 and one of 2 x 4,160 tokens
        dcfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        dlogits = logits
        if cfg.moe is not None:
            del cache
            dlogits, cache = prefill_step(params, pre, dcfg)
        cache = extend_cache(cache, cfg, batch, total)
        dec, ms, dec_routes = [], [], []
        for i in range(LM_DECODE):
            pos = LM_PREFILL + i
            with recorded_routes(cfg) as r:
                (lg, cache), t = cuda_ms(lambda: decode_step(
                    params, cache, toks[:, pos], pos, dcfg))
            dec.append(lg)
            dec_routes.append(r)
            ms.append(t)
        del cache
        ocfg = dataclasses.replace(dcfg, q_chunk=LM_ORACLE_CHUNK)
        with recorded_routes(cfg, LM_PREFILL) as orc_routes:
            h = forward(params, toks, ocfg)[:, LM_PREFILL - 1:]
        oracle = (h @ emb.T).float()                 # (B, 65, V)
        del h
    oracle_pre_err = rel_err(dlogits, oracle[:, 0])
    # a one-ulp bf16 difference in a router's input flips a pick at a near
    # tie of the k-th and (k+1)-th logit, and a flipped row's logits follow
    # other experts from there: hold the routing up to the flip instead
    routes = route_checks(dec_routes, orc_routes, cfg.moe)
    del dec_routes, orc_routes
    agree = routes["agree"]
    if agree is None:
        agree = torch.ones(LM_DECODE, batch, dtype=torch.bool)
    errs = [[rel_err(lg[b], oracle[b, i + 1]) for b in range(batch)]
            for i, lg in enumerate(dec)]
    pairs = [(i, b) for i in range(LM_DECODE) for b in range(batch)]
    dec_err = max(errs[i][b] for i, b in pairs if agree[i, b]) \
        if bool(agree.any()) else float("inf")
    all_err = max(errs[i][b] for i, b in pairs)
    share = float(agree.float().mean())
    floor = LM_ROUTE_AGREE.get(name, 1.0)
    flips = routes["flips"]
    gap_moved = max((f["gap"] / max(2 * f["moved"], 1e-30) for f in flips),
                    default=0.0)
    moved_reach = max((f["moved"] / max(f["reach"], 1e-30) for f in flips),
                      default=0.0)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in dec)
    out = {"batch": batch, "layers": cfg.n_layers, "weights_bytes": weights,
           "prefill_ms": pre_ms,
           "prefill_tokens_per_s": batch * LM_PREFILL / (pre_ms / 1e3),
           "decode_ms_per_token": float(np.median(ms[1:])),
           "decode_ms_first": ms[0], "prefill_err": pre_err,
           "oracle_prefill_err": oracle_pre_err, "decode_err": dec_err,
           "decode_err_all": all_err, "route_agreement": share,
           "router_x_err": routes["x_err"],
           "router_logit_err": routes["logit_err"],
           "flipped_rows": len(flips), "flip_gap_over_moved": gap_moved,
           "flip_moved_over_reach": moved_reach,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, oracle, dec, logits, dlogits, emb, toks
    free_card()
    log(f"[lm] {name} at its published widths ({cfg.n_layers} of "
        f"{get(name).config.n_layers} layers, d_model {cfg.d_model}, "
        f"{weights / 1e9:.2f} GB of bf16 weights, batch {batch}) on "
        f"{card}: prefill {LM_PREFILL} tokens {pre_ms:.4g} ms "
        f"({out['prefill_tokens_per_s']:.4g} tokens/s), decode "
        f"{out['decode_ms_per_token']:.4g} ms a token (median of steps "
        f"2-{LM_DECODE}; the first {ms[0]:.4g}), max_memory_allocated "
        f"{out['peak_bytes'] / 2**30:.3f} GiB; prefill against forward "
        f"{pre_err:.3g} (< {LM_PREFILL_TOL}), against the "
        f"{total}-token oracle {oracle_pre_err:.3g}, decode against it "
        f"{dec_err:.3g} (< {LM_DECODE_TOL}) over the steps' rows whose "
        f"MoE picks all equal the oracle's ({share:.4g} of them, at least "
        f"{floor}; every row: {all_err:.3g})")
    if cfg.moe is not None:
        log(f"[lm] {name} routing: up to each decode row's first flipped "
            f"layer the router's input within {routes['x_err']:.3g} and its "
            f"float32 logits within {routes['logit_err']:.3g} of the "
            f"oracle's (< {LM_DECODE_TOL}); {len(flips)} rows flipped, each "
            f"at a k-th/(k+1)-th logit gap within 2 x its logits' drift "
            f"(largest gap / 2 drift {gap_moved:.3g}), a drift within the "
            f"input drift's reach (largest drift / reach "
            f"{moved_reach:.3g}); {routes['bad']} beyond; first flips by "
            f"layer "
            f"{dict(sorted(collections.Counter(f['layer'] for f in flips).items()))}")
    if not finite:
        raise AssertionError(f"lm {name}: a logit is not finite")
    if pre_err >= LM_PREFILL_TOL:
        raise AssertionError(f"lm {name}: prefill {pre_err} against "
                             f"forward")
    if share < floor:
        raise AssertionError(f"lm {name}: MoE picks agree on {share} of the "
                             f"decode rows")
    if routes["bad"] or max(routes["x_err"], routes["logit_err"]) \
            >= LM_DECODE_TOL:
        raise AssertionError(f"lm {name}: routing {routes}")
    if max(dec_err, oracle_pre_err) >= LM_DECODE_TOL:
        raise AssertionError(f"lm {name}: decode {dec_err}, prefill "
                             f"{oracle_pre_err} against the oracle")
    return out


def lm_train(card: str) -> dict:
    """Phase 17 (b): phi4-mini at full width, bf16 params and grads,
    remat per block, the step donating its state; 6 steps on one fixed
    batch at the largest batch that fits, then the first step repeated
    from the same seeded state."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, make_train_step
    from repro_torch.optim import adamw

    cfg = get(LM_TRAIN).config
    step = make_train_step(cfg, donate=True)

    def fresh():
        p = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
        contracted_fan_in(p, cfg)
        return p, adamw.init(p)

    tried = []
    for batch in LM_TRAIN_BATCHES:
        free_card()
        toks = torch.from_numpy(token_batch(batch, 4097, cfg.vocab,
                                            seed=23)).to(DEVICE)
        params = opt = None
        try:
            params, opt = fresh()
            d0 = bits_digest(params)
            losses, ms, gnorms = [], [], []
            for s in range(LM_TRAIN_STEPS):
                (params, opt, m), t = cuda_ms(lambda: step(params, opt,
                                                           toks))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                ms.append(t)
                if s == 0:
                    d1 = bits_digest((params, opt))
            break
        except torch.OutOfMemoryError as e:
            tried.append((batch, str(e).splitlines()[0]))
            del params, opt, toks
            continue
    else:
        raise AssertionError(f"lm train: no batch fits: {tried}")
    peak = torch.cuda.max_memory_allocated()
    state = _tree_bytes(params) + _tree_bytes(opt)
    del params, opt
    free_card()
    params, opt = fresh()
    same_init = bits_digest(params) == d0
    params, opt, _ = step(params, opt, toks)
    repeat = bits_digest((params, opt)) == d1
    del params, opt, toks
    free_card()
    out = {"batch": batch, "oom": tried, "losses": losses, "ms": ms,
           "grad_norms": gnorms,
           "ms_median": float(np.median(ms[1:])), "peak_bytes": peak,
           "state_bytes": state, "repeat_bit_equal": repeat and same_init,
           "n_params": cfg.n_params}
    log(f"[lm] train {LM_TRAIN} at full width ({cfg.n_params / 1e9:.3f} B "
        f"params, bf16 params and grads, remat per block) on {card}: "
        f"batch {batch} x 4,096 tokens (out of memory at "
        f"{[b for b, _ in tried]}); ms a step {out['ms_median']:.5g} (median of steps "
        f"2-{LM_TRAIN_STEPS}; the first {ms[0]:.5g}), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB, state (params + mu "
        f"+ nu, float32 moments) {state / 2**30:.3f} GiB; fixed-batch "
        f"losses {[float(f'{v:.7g}') for v in losses]} (gradient norms "
        f"{[float(f'{v:.4g}') for v in gnorms]}); the first step "
        f"repeated from the same seeded state bit-equal (params and "
        f"AdamWState, digests of every leaf): {out['repeat_bit_equal']}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"lm train: the loss did not fall: {losses}")
    if not out["repeat_bit_equal"]:
        raise AssertionError("lm train: a repeated step differs")
    return out


def gnn_batch(shape, cfg, seed: int) -> dict:
    """A seeded ``random_graph`` at one of GraphCast's registry shapes,
    with its padded edges masked, targets, and for ``minibatch_lg`` the
    seed-node mask."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_graph

    n, e, f = (shape.get(k) for k in ("n_nodes", "n_edges", "d_feat"))
    rng = np.random.default_rng(seed)
    if shape.get("mode") == "batched":
        b = shape.batch
        feats = rng.normal(size=(b, n, f)).astype(np.float32)
        src = rng.integers(0, n, size=(b, e)).astype(np.int32)
        dst = rng.integers(0, n, size=(b, e)).astype(np.int32)
        tgt = rng.normal(size=(b, n, cfg.n_vars)).astype(np.float32)
        arrays = {"node_feats": feats, "src": src, "dst": dst,
                  "targets": tgt}
    else:
        real = min({"full_graph_sm": 10556}.get(shape.name, e), e)
        src, dst, feats = random_graph(n, real, f, seed=seed)
        pad = e - real
        arrays = {"node_feats": feats,
                  "src": np.pad(src, (0, pad)), "dst": np.pad(dst, (0, pad)),
                  "edge_mask": np.arange(e) < real,
                  "targets": rng.normal(size=(n, cfg.n_vars)).astype(
                      np.float32)}
        if shape.get("mode") == "sampled":
            mask = np.zeros(n, bool)
            mask[rng.choice(n, GNN_SEEDS, replace=False)] = True
            arrays["node_mask"] = mask
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEVICE)
            for k, v in arrays.items()}


def gnn_train(card: str) -> dict:
    """Phase 17 (c): GraphCast at full width on three registry shapes (6
    steps on a fixed batch each; the full_graph_sm step repeated from one
    state bit-equal), then ogb_products' forward."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models.gnn import forward, init_params, make_train_step
    from repro_torch.optim import adamw

    arch = get("graphcast")
    cfg = arch.config
    out = {}
    for name in GNN_SHAPES:
        shape = arch.shapes[name]
        free_card()
        batch = gnn_batch(shape, cfg, seed=31)
        params = init_params(cfg, shape.get("d_feat"),
                             torch.Generator(device=DEVICE).manual_seed(0),
                             DEVICE)
        opt = adamw.init(params)
        step = make_train_step(cfg, batched=shape.get("mode") == "batched")
        if name == "full_graph_sm":
            x = step(params, opt, batch)[:2]
            y = step(params, opt, batch)[:2]
            out["repeat_bit_equal"] = _same_bits(x, y)
            del x, y
        losses, ms = [], []
        for _ in range(LM_TRAIN_STEPS):
            (params, opt, m), t = cuda_ms(lambda: step(params, opt, batch))
            losses.append(float(m["loss"]))
            ms.append(t)
        out[name] = {"losses": losses, "ms": ms,
                     "ms_median": float(np.median(ms[1:])),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "edges": int(batch["src"].numel())}
        log(f"[gnn] graphcast {name} (16 layers, d_hidden 512, n_vars 227, "
            f"float32; {shape.get('n_nodes')} nodes"
            f"{' x ' + str(shape.batch) if shape.batch > 1 else ''}, "
            f"{out[name]['edges']} edges, d_feat {shape.get('d_feat')}) on "
            f"{card}: ms a step {out[name]['ms_median']:.4g} (median of "
            f"steps 2-{LM_TRAIN_STEPS}; the first {ms[0]:.4g}), "
            f"max_memory_allocated "
            f"{out[name]['peak_bytes'] / 2**30:.3f} GiB, losses "
            f"{[float(f'{v:.6g}') for v in losses]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"gnn {name}: the loss did not fall")
        del params, opt, batch
    log(f"[gnn] full_graph_sm: one step repeated from one state bit-equal "
        f"(params and AdamWState): {out['repeat_bit_equal']}")
    if not out["repeat_bit_equal"]:
        raise AssertionError("gnn: a repeated step differs")
    shape = arch.shapes["ogb_products"]
    free_card()
    n, f = shape.get("n_nodes"), shape.get("d_feat")
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(37)
    feats = torch.randn((n, f), generator=g, device=DEVICE)
    src = torch.randint(0, n, (OGB_EDGES,), generator=g, device=DEVICE)
    dst = torch.randint(0, n, (OGB_EDGES,), generator=g, device=DEVICE)
    params = init_params(cfg, f, torch.Generator(device=DEVICE).manual_seed(
        0), DEVICE)
    make_s = time.perf_counter() - t0
    with torch.no_grad():
        pred, ms = cuda_ms(lambda: forward(params, feats, src, dst, cfg))
    ok = bool(torch.isfinite(pred).all()) and pred.shape == (n, cfg.n_vars)
    out["ogb_products"] = {"ms": ms, "edges": OGB_EDGES, "make_s": make_s,
                           "peak_bytes": torch.cuda.max_memory_allocated()}
    del pred, feats, src, dst, params
    free_card()
    log(f"[gnn] ogb_products forward only ({n} nodes, d_feat {f}, "
        f"{OGB_EDGES} edges of 61,859,140, cut) on {card}: {ms:.5g} ms, "
        f"max_memory_allocated "
        f"{out['ogb_products']['peak_bytes'] / 2**30:.3f} GiB, predictions "
        f"finite: {ok}")
    if not ok:
        raise AssertionError("gnn ogb_products: bad predictions")
    return out


def adamw_step_gap(mu_a, nu_a, mu_b, nu_b, cfg) -> "torch.Tensor":
    """lr * |u_a - u_b| elementwise, u = mhat / (sqrt(vhat) + eps) of
    AdamW's first step from moments a and b (tests/_torch_port.py's
    ``adamw_step_gap``): where |g| is near eps the update g / (|g| + eps)
    magnifies the two gradients' difference by up to 1 / (4 eps)."""
    import torch

    u = lambda m, v: (m.double() / (1 - cfg.b1)) / (
        torch.sqrt(v.double() / (1 - cfg.b2)) + cfg.eps)
    return cfg.lr * (u(mu_a, nu_a) - u(mu_b, nu_b)).abs()


def lm_gnn_parity() -> dict:
    """Phase 17 (d): one step of each LM arch at ``scaled_lm_config(.,
    0.02)`` and of GraphCast at 4 x 64 on the card against the same step
    on the CPU, from the same params and batch.  The LM params are drawn
    on the CPU and rescaled by ``contracted_fan_in`` (tests/test_torch_lm.py
    holds the port to the reference on the same rescale); the loss and the
    gradient norm agree within rtol 1e-5, the moments within 1e-5 of the
    largest, and every parameter within STEP_PARAM_ATOL beyond
    ``adamw_step_gap``."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data.synthetic import random_graph, token_batch
    from repro_torch.distributed.collectives import tree_flatten, tree_map
    from repro_torch.launch.train import scaled_lm_config
    from repro_torch.models import gnn, lm
    from repro_torch.optim import adamw

    cuda = lambda t: t.to(DEVICE)
    opt = adamw.AdamWConfig()
    out = {}
    for name, _, _ in LM_SERVE:
        cfg = scaled_lm_config(get(name).config, 0.02)
        params = lm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        contracted_fan_in(params, cfg)
        toks = torch.from_numpy(token_batch(2, 33, cfg.vocab, seed=5))
        step = lm.make_train_step(cfg)
        wp, wo, wm = step(params, adamw.init(params), toks)
        cp = tree_map(cuda, params)
        gp, go, gm = step(cp, adamw.init(cp), cuda(toks))
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                                   rtol=LM_PARITY_TOL,
                                   err_msg=f"parity {name}")
        np.testing.assert_allclose(float(gm["grad_norm"]),
                                   float(wm["grad_norm"]),
                                   rtol=LM_PARITY_TOL,
                                   err_msg=f"parity {name}")
        leaves = lambda tree: [t.cpu() for t in tree_flatten(tree)[0]]
        g_mu, g_nu, w_mu, w_nu = (leaves(t) for t in (go.mu, go.nu, wo.mu,
                                                       wo.nu))
        rec = {"loss": float(gm["loss"])}
        for what, got_m, want_m in (("mu_rel", g_mu, w_mu),
                                    ("nu_rel", g_nu, w_nu)):
            scale = max(float(w.abs().max()) for w in want_m)
            rec[what] = max(float((g - w).abs().max())
                            for g, w in zip(got_m, want_m)) / scale
        err = excess = 0.0
        for g, w, gmu, gnu, wmu, wnu in zip(leaves(gp), leaves(wp), g_mu,
                                            g_nu, w_mu, w_nu):
            d = (g - w).abs().double()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - adamw_step_gap(
                gmu, gnu, wmu, wnu, opt)).max()))
        rec.update(max_abs_err=err, max_excess=excess)
        out[name] = rec
        if max(rec["mu_rel"], rec["nu_rel"]) > LM_PARITY_TOL \
                or excess > STEP_PARAM_ATOL:
            raise AssertionError(f"parity {name}: {rec}")
    cfg = dataclasses.replace(get("graphcast").config, n_layers=4,
                              d_hidden=64)
    src, dst, feats = random_graph(512, 2048, 32, seed=0)
    tgt = np.random.default_rng(1).normal(size=(512, cfg.n_vars)).astype(
        np.float32)
    b = {k: torch.from_numpy(v) for k, v in (
        ("node_feats", feats), ("src", src), ("dst", dst), ("targets", tgt))}
    params = gnn.init_params(cfg, 32, torch.Generator().manual_seed(5), "cpu")
    step = gnn.make_train_step(cfg)
    wp, wo, wm = step(params, adamw.init(params), b)
    cp = tree_map(cuda, params)
    gp, go, gm = step(cp, adamw.init(cp), tree_map(cuda, b))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5, err_msg="parity graphcast")
    err = 0.0
    for got, want in ((gp, wp), (go.mu, wo.mu), (go.nu, wo.nu)):
        for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            g = g.cpu().numpy()
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=STEP_PARAM_ATOL,
                                       err_msg="parity graphcast")
            err = max(err, float(np.abs(g - w.numpy()).max()))
    out["graphcast"] = {"loss": float(gm["loss"]), "max_abs_err": err}
    log(f"[lm] one step card against CPU (scaled 0.02 with the contracted "
        f"fan-in, float32; GraphCast 4 x 64): loss and gradient norm within "
        f"rtol {LM_PARITY_TOL}, moments within {LM_PARITY_TOL} of the "
        f"largest, params within {STEP_PARAM_ATOL} beyond adamw_step_gap "
        f"(GraphCast: params and moments within atol {STEP_PARAM_ATOL}): "
        f"{ {k: {kk: float(f'{vv:.3g}') for kk, vv in v.items()} for k, v in out.items()} }")
    return out


def lm_cli(work: str, card: str) -> dict:
    """Phase 17 (d): the training CLI in subprocesses: qwen2-moe's
    --fail-at 12 run, its relaunch (which must resume from step 10 and
    write a step-20 checkpoint byte-equal to an uninterrupted run's),
    phi4-mini with --accum 2 (finite losses) and GraphCast (6 steps).  The
    runs that do not wait on another start together."""
    import filecmp
    import re

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            DEVICE]
    wa, wb = os.path.join(work, "lm-a"), os.path.join(work, "lm-b")
    moe = ["--arch", "qwen2_moe", "--steps", "20", "--ckpt-every", "5"]
    runs = {"fail": moe + ["--fail-at", "12", "--workdir", wa],
            "straight": moe + ["--workdir", wb],
            "accum": ["--arch", "phi4_mini", "--accum", "2", "--steps", "4",
                      "--workdir", os.path.join(work, "lm-c")],
            "gnn": ["--arch", "graphcast", "--steps", "6", "--workdir",
                    os.path.join(work, "lm-d")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(base + v, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, v in runs.items()}
    done = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=TRAIN_CLI_TIMEOUT_S)
            done[k] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(base + moe + ["--workdir", wa], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=TRAIN_CLI_TIMEOUT_S)
    done["resume"] = (proc.returncode, proc.stdout, proc.stderr)
    resume_s = time.perf_counter() - t0
    rc, _, err = done["fail"]
    if rc == 0 or "simulated node failure at step 12" not in err:
        raise AssertionError(f"lm CLI --fail-at 12 exited {rc}:\n"
                             f"{err[-2000:]}")
    for k in ("straight", "resume", "accum", "gnn"):
        if done[k][0] != 0:
            raise AssertionError(f"lm CLI ({k}) exited {done[k][0]}:\n"
                                 f"{done[k][2][-3000:]}")
    if "resumed from step 10 (cursor=10)" not in done["resume"][1]:
        raise AssertionError("lm CLI: no resume line")
    a = os.path.join(wa, "ckpt", "step_00000020")
    b = os.path.join(wb, "ckpt", "step_00000020")
    names = sorted(os.listdir(b))
    same, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    if mismatch or errors or sorted(os.listdir(a)) != names:
        raise AssertionError(f"lm CLI: the resumed qwen2-moe checkpoint "
                             f"differs in {mismatch + errors}")
    losses = {k: [float(v) for v in re.findall(r"loss=([-\d.naif]+)",
                                               done[k][1])]
              for k in ("accum", "gnn")}
    import math

    if not losses["accum"] or not all(math.isfinite(v)
                                      for v in losses["accum"]):
        raise AssertionError(f"lm CLI --accum 2: losses {losses['accum']}")
    for k in ("resume", "accum", "gnn"):
        for line in done[k][1].splitlines():
            log(f"[lm-cli] {k}: {line}")
    log(f"[lm-cli] on {card}: qwen2_moe --fail-at 12 exited {rc}; the "
        f"relaunch resumed from step 10 ({resume_s:.1f} s); its step-20 "
        f"checkpoint, {len(same)} files, byte-equal to an uninterrupted "
        f"run's; phi4_mini --accum 2 losses {losses['accum']}; graphcast "
        f"losses {losses['gnn']} (the first four runs together "
        f"{first_s:.1f} s)")
    return {"files": len(same), "losses": losses, "resume_s": resume_s,
            "first_s": first_s}


def combine_determinism() -> dict:
    """For the MoE combine (each token's K expert outputs added into its
    row) at qwen2-moe's prefill shape, whether two runs on the card give
    the same bits: the port's inverse permutation and ordered sum, and
    the two scatter-adds (``index_add_``, ``index_put_(accumulate=True)``);
    the same for ``segment_sum``'s ``index_put_`` at minibatch_lg's
    edges."""
    import torch

    from repro_torch.models.gnn.graphcast import segment_sum

    g = torch.Generator(device=DEVICE).manual_seed(41)
    t, k, d = 2 * LM_PREFILL, 4, 2048
    contrib = torch.randn((t * k, d), generator=g, device=DEVICE).to(
        torch.bfloat16)
    order = torch.randperm(t * k, generator=g, device=DEVICE)
    token_of = order // k

    def permuted():
        where = torch.empty_like(order)
        where[order] = torch.arange(t * k, device=DEVICE)
        pos = torch.sort(where.view(t, k), dim=1).values
        per = contrib[pos]
        out = torch.zeros((t, d), dtype=contrib.dtype, device=DEVICE)
        for j in range(k):
            out = out + per[:, j]
        return out

    ways = {"inverse permutation + ordered sum": permuted,
            "index_add_": lambda: torch.zeros(
                (t, d), dtype=contrib.dtype, device=DEVICE).index_add_(
                0, token_of, contrib),
            "index_put_(accumulate=True)": lambda: torch.zeros(
                (t, d), dtype=contrib.dtype, device=DEVICE).index_put_(
                (token_of,), contrib, accumulate=True)}
    out = {}
    for name, fn in ways.items():
        a, b = fn(), fn()
        out[name] = bool(torch.equal(a.view(torch.int16),
                                     b.view(torch.int16)))
    m = torch.randn((179200, 512), generator=g, device=DEVICE)
    dst = torch.randint(0, 184320, (179200,), generator=g, device=DEVICE)
    a, b = segment_sum(m, dst, 184320), segment_sum(m, dst, 184320)
    out["segment_sum"] = bool(torch.equal(a.view(torch.int32),
                                          b.view(torch.int32)))
    return out


def phase_lm(work: str, card: str) -> dict:
    """Phase 17: the LM and GNN families (module doc)."""
    from repro_torch.kernels.cuda_lib import LAUNCHES

    t0 = time.perf_counter()
    LAUNCHES.reset()
    out = {"serve": {}}
    for name, batch, layers in LM_SERVE:
        try:
            out["serve"][name] = lm_serve(name, batch, layers, card)
        except Exception as e:  # noqa: BLE001 — only an OOM is retried
            import torch

            if not isinstance(e, torch.OutOfMemoryError) or batch == 1:
                raise
            log(f"[lm] {name}: batch {batch} does not fit ({e}); batch 1")
            free_card()
            out["serve"][name] = lm_serve(name, 1, layers, card)
    out["train"] = lm_train(card)
    out["gnn"] = gnn_train(card)
    out["parity"] = lm_gnn_parity()
    out["cli"] = lm_cli(work, card)
    out["determinism"] = combine_determinism()
    log(f"[lm] two runs on the card bit-equal: {out['determinism']}")
    for way in ("inverse permutation + ordered sum", "segment_sum"):
        if not out["determinism"][way]:
            raise AssertionError(f"{way} is not deterministic on the card")
    launches = path_launches("LM and GNN families (phase 17)")
    if any(launches.values()):
        raise AssertionError(f"phase 17 launched a kernel of the library: "
                             f"{launches}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[lm] phase 17 {out['seconds']:.1f} s; kernel launches "
        f"{launches} (no kernel of the library on this path)")
    return out


# --------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# --------------------------------------------------------------------------
def phase_times(built: dict, served: dict, kernel_errs: dict,
                resident: dict, streamed: dict) -> list:
    import numpy as np
    import torch

    from repro_torch.core.search import _auto_ncand
    from repro_torch.kernels import ivf_scan_q8 as q8m
    from repro_torch.kernels import kmeans_assign as am
    from repro_torch.kernels import kmeans_mstep as mm

    rows = []
    pipe = served["pipe"]
    # K1: one real batch of the serving run (its plan and streamed union)
    # through the wrapper, which builds no plan and issues nothing on the
    # card but K1's two kernels
    queries, topk = served["batches"][0]
    plan = pipe.plan(queries, topk)
    fetched = pipe._gather(plan)
    pmask = torch.from_numpy(plan.pmask).cuda()
    args = (*fetched.tensors(), pmask, plan.queries_dev)
    k2 = _auto_ncand(pipe.cfg.k)
    b, p = pmask.shape
    chunks = q8m.k1_chunks(b, p, k2, pmask.device)
    t = time_two_ways(lambda: q8m.ivf_scan_q8_topk_cuda(*args, k2=k2), n=200)
    one = time_two_ways(lambda: q8m.ivf_scan_q8_topk_cuda(
        *args, k2=k2, chunks=1), n=200)
    split = kernel_split_ms(lambda: q8m.ivf_scan_q8_topk_cuda(*args, k2=k2),
                            K1_PARTS, n=20)
    log(f"[times] K1 on one phase-4 batch: {b} queries x {chunks} chunks = "
        f"{b * chunks} blocks, {t['events']:.4f} ms by events, "
        f"{t['queued']:.4f} ms queued (ms a launch by kernel: {split}); one "
        f"block a query {one['events']:.4f} / {one['queued']:.4f} ms")
    plain = time_ms(lambda: q8m.ivf_scan_q8_topk_plain(*args, k2=k2), n=20)
    _, l, d = fetched.q8.shape
    remap = fetched.remap.cpu().numpy()
    live = plan.pmask & (remap >= 0)
    qi, pi = np.nonzero(live)
    pairs = len(set(zip(qi.tolist(), remap[qi, pi].tolist())))
    used = np.unique(remap[live]).size
    nbytes = used * (l * d + 8 * l + 4 + 4 * d) + b * d * 4 \
        + plan.pmask.size * 5 + b * k2 * 8
    flops = pairs * (2 * l * d + 4 * l + 3 * d)
    rows.append(_row("ivf_scan_q8_topk", "src/repro_torch/csrc/ivf_scan_q8.cu",
                     "src/repro/kernels/ivf_scan_q8.py:174",
                     kernel_errs["ivf_scan_q8_topk"],
                     t["events"], plain, nbytes, flops,
                     "no single PyTorch call computes a unique-by-id top-k2 "
                     "over int8 residual codes",
                     f"B={b} P={p} R={fetched.q8.shape[0]} "
                     f"used_rows={used} L={l} D={d} k2={k2}",
                     device_ms=t["queued"], wrapper_ms=t["events"],
                     blocks=b * chunks, chunks=chunks, split_ms=split,
                     one_block_a_query_ms=one))
    # K2: the build's largest call, all points against the final centroids
    x = torch.from_numpy(built["x"]).cuda()
    cents = built["index"].centroids.contiguous()
    n, d = x.shape
    k = cents.shape[0]
    t = time_two_ways(lambda: am.kmeans_assign_update_cuda(x, cents), n=5,
                      warm=1)
    plain = time_ms(lambda: am.kmeans_assign_update_plain(x, cents), n=3,
                    warm=1)
    split = kernel_split_ms(lambda: am.kmeans_assign_update_cuda(x, cents),
                            K2_PARTS, n=3)
    log(f"[times] K2 split at N={n} K={k} D={d} (ms a launch, "
        f"torch.profiler; Memset: each of its three): {split}")
    nbytes = (n * d + k * d) * 4 + n * 8 + (k * d + k) * 4
    xs, cs = kmeans_inputs(5000, 8, 128, seed=21)
    small = time_ms(lambda: am.kmeans_assign_update_cuda(xs, cs), n=50)
    log(f"[times] K2 at the splitter's shape before K23, N=5000 K=8 "
        f"D=128: {small:.4f} ms")
    rows.append(_row("kmeans_assign_update",
                     "src/repro_torch/csrc/kmeans_assign.cu",
                     "src/repro/kernels/kmeans_assign.py:108",
                     kernel_errs["kmeans_assign_update"], t["events"], plain,
                     nbytes, 2 * n * k * d,
                     "no single PyTorch call fuses the argmin with the "
                     "per-cluster sums and counts",
                     f"N={n} K={k} D={d} (enforce_size_bound)",
                     device_ms=t["queued"], splitter_shape_ms=small,
                     split_ms=split))
    rows.append(k3_row(built, kernel_errs))
    rows.append(k23_row(built, kernel_errs))
    rows.append(b2_row(streamed, resident, kernel_errs))
    rows.append(b6a_row(resident, kernel_errs))
    rows.append(b5_row(built, kernel_errs))
    rows.append(b6b_row(resident, kernel_errs))
    rows.append(b7_row(resident, kernel_errs))
    for r in rows:
        if r["name"] in NO_PATH:
            # a launch on a main path would be news
            if r["launches"]:
                raise AssertionError(f"{r['name']} launched on a main path: "
                                     f"{r['launches_by_path']}")
        elif r["launches"] < 1:
            raise AssertionError(f"{r['name']} launched on no main path")
    return rows


# K2's kernels, by a part of the name the profiler shows
K2_PARTS = ("row_norms_kernel", "assign_kernel", "segment_hist_kernel",
            "column_scan_kernel", "offsets_kernel", "scatter_kernel",
            "segment_sum_kernel", "Memset")


# B2's two kernels: the scan of each (tile, chunk) and the merge
B2_PARTS = ("f32_topk_kernel", "f32_topk_merge_kernel")
# K1's two kernels: the scan of each (query, chunk) and the same merge
K1_PARTS = ("q8_topk_chunk_kernel", "f32_topk_merge_kernel")


def kernel_split_ms(run, parts, n: int) -> dict:
    """Device ms a launch of each kernel whose profiler name contains one
    of ``parts`` (its device time over its launches, in n calls of ``run``
    under torch.profiler after a warm call).  A trace that misses a part
    is taken again (the H100's profiler once dropped every launch of one
    kernel of K2); the third miss fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        total = dict.fromkeys(parts, 0.0)
        count = dict.fromkeys(parts, 0)
        for ev in prof.key_averages():
            for part in parts:
                if part in ev.key:
                    total[part] += getattr(ev, "self_device_time_total", 0.0)
                    count[part] += ev.count
                    break
        missed = [p for p in parts if not count[p]]
        if not missed:
            return {p: total[p] / 1e3 / count[p] for p in parts}
        log(f"[times] trace {attempt + 1} recorded no launch of {missed}")
    raise AssertionError(f"the profiler recorded no launch of {missed}")


# K3's timed shapes (K, D, empty clusters): the splitter's 8-means,
# enforce_size_bound's 2-means (the per-node witness runs both) and the 1M
# index's centroid count, where bytes bind
K3_SHAPES = ((8, 128, 2), (2, 128, 1), (20614, 128, 322))


def k3_bytes(k: int, d: int, n_empty: int) -> int:
    """Bytes K3 must move: sums and the output once, the counts, and one
    reseed row per empty cluster."""
    return (2 * k * d + k + n_empty * d) * 4


def k3_shape_times(time_two_ways) -> dict:
    """K3 at each of K3_SHAPES through ``kmeans_mstep_cuda`` (int32 counts,
    as K2 returns them), by both timers, beside its plain version and its
    byte bound."""
    from repro_torch.kernels import kmeans_mstep as mm

    out = {}
    for k, d, n_empty in K3_SHAPES:
        sums, counts, reseed = k3_inputs(k, d, n_empty, seed=22 + k,
                                         int_counts=True)
        # n = 200: the parent tree's K3 issues three kernels a call, and
        # more than about 1,000 queued launches fill the launch queue behind
        # the sleep, so the queued timer would read the host
        t = time_two_ways(lambda: mm.kmeans_mstep_cuda(sums, counts, reseed),
                          n=200)
        out[f"K{k} D{d}"] = {
            "events_ms": t["events"], "device_ms": t["queued"],
            "plain_ms": time_ms(lambda: mm.kmeans_mstep_plain(
                sums, counts, reseed), n=200),
            "bound_ms": bound_ms(k3_bytes(k, d, n_empty), k * d),
            "n_empty": n_empty}
    return out


def launch_floor_times() -> dict:
    """The empty kernel (``csrc/launch_floor.cu``) by both timers: the
    device time of the least launch (queued) and the host's issue time a
    launch through ctypes (events)."""
    import torch

    from repro_torch.kernels import cuda_lib

    dev = torch.device("cuda")
    t = time_two_ways(lambda: cuda_lib.launch_floor(dev), n=500)
    return {"events_ms": t["events"], "device_ms": t["queued"]}


def k3_row(built: dict, kernel_errs: dict) -> dict:
    """K3 at K3_SHAPES by both timers, the launch floor beside it, its
    launches on the main paths (none: K23 took its calls) and in phase 3's
    per-node witness."""
    shapes = k3_shape_times(time_two_ways)
    floor = launch_floor_times()
    log(f"[times] launch floor (empty kernel, one block of one thread): "
        f"{floor['events_ms']:.6f} ms by events, {floor['device_ms']:.6f} "
        f"ms queued")
    log(f"[times] K3: {shapes}")
    main = shapes["K8 D128"]
    k, d, _ = K3_SHAPES[0]
    return _row("kmeans_mstep", "src/repro_torch/csrc/kmeans_mstep.cu",
                "src/repro/kernels/kmeans_mstep.py:90",
                kernel_errs["kmeans_mstep"], main["events_ms"],
                main["plain_ms"], k3_bytes(k, d, main["n_empty"]), k * d,
                "no single PyTorch call ranks the empty clusters, gathers "
                "their reseed rows and divides the rest",
                "K=8 D=128 (the splitter's shape), int32 counts",
                device_ms=main["device_ms"], shapes=shapes,
                launch_floor_ms=floor,
                witness_launches=built.get("witness_launches", {}))


def k23_row(built: dict, kernel_errs: dict) -> dict:
    """K23 on the 1M build's largest step: the first step of stage 1's
    first group (its chunks' roots, 5000 points and k 8 each), timed alone
    with CUDA events around the launch; and the build's own steps."""
    import numpy as np
    import torch

    from repro_torch.kernels import kmeans_batched as kb

    cfg = built["cfg"]
    per = cfg.coarse_per_task
    n_chunks = -(-len(built["x"]) // per)
    first = int(np.linspace(0, n_chunks, max(1, min(cfg.n_workers,
                                                    n_chunks)) + 1)[1])
    x = torch.from_numpy(built["x"][:first * per]).cuda()
    t_n, d = x.shape
    pts = torch.arange(t_n, dtype=torch.int32)
    offs = torch.arange(0, t_n + 1, per, dtype=torch.int32)
    k = min(8, -(-per // cfg.max_cluster_size))
    ks = torch.full((first,), k, dtype=torch.int32)
    init = torch.zeros((first, 16), dtype=torch.int32)
    for i in range(first):
        init[i, :k] = torch.from_numpy(np.random.default_rng(
            cfg.seed + 1000 * i + 1).choice(per, k, replace=False))
    it = cfg.kmeans_iters

    def run():
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        kb.kmeans_batched_cuda(x, pts, offs, ks, init, it, events=ev)
        return ev

    run()
    evs = [run() for _ in range(5)]
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in evs) / len(evs)
    wrapper = time_two_ways(lambda: kb.kmeans_batched_cuda(
        x, pts, offs, ks, init, it), n=5, warm=1)
    plain = time_ms(lambda: kb.kmeans_batched_plain(x, pts, offs, ks, init,
                                                    it), n=1, warm=1)
    nbytes = t_n * d * 4 + t_n * 4 + (2 * first + 1) * 4 + first * 64 \
        + t_n * 8 + first * 16 * (d * 4 + 4)
    split = built["split"]
    return _row("kmeans_batched", "src/repro_torch/csrc/kmeans_batched.cu",
                "src/repro/kernels/kmeans_assign.py:108 + "
                "src/repro/kernels/kmeans_mstep.py:90 (splitter shapes)",
                kernel_errs["kmeans_batched"], ms, plain, nbytes,
                2 * t_n * k * d * it,
                "no single PyTorch call runs Lloyd iterations over many "
                "sub-problems",
                f"first step of group 0: S={first} N={per} each, k={k}, "
                f"D={d}, iters={it}", device_ms=ms,
                wrapper_ms=wrapper["events"],
                wrapper_queued_ms=wrapper["queued"],
                build_steps=split["steps"],
                build_ms_per_step=split["k23_ms_mean"],
                build_ms_total=split["k23_ms_total"],
                host_bookkeeping_s=split["host_bookkeeping_s"])


def b2_work(tile_cids, qsel, l, d, b, k2):
    """(bytes, flops, used rows, pairs) of B2 on one plan: each used row
    read once with its ids, the queries and the plan read, the candidates
    written; a dot per (query, row) pair and a norm per used row."""
    live = qsel.ne(0)
    pairs = int(live.sum())
    used = int(tile_cids[live.any(dim=2)].unique().numel())
    nbytes = used * l * (d * 4 + 4) + b * d * 4 + tile_cids.numel() * 4 \
        + qsel.numel() * 4 + b * k2 * 8
    return nbytes, (pairs + used) * l * 2 * d, used, pairs


def b2_row(streamed: dict, resident: dict, kernel_errs: dict) -> dict:
    """B2 on one real phase-8 batch (packed union) and on one resident
    batch (the whole index), each alone on a prebuilt tile plan, through
    the wrapper (the design ``b2_design`` picks) and by cluster."""
    import torch

    from repro_torch.core.search import _auto_ncand
    from repro_torch.kernels import ivf_scan as scan

    k2 = _auto_ncand(10)
    pipe = streamed["pipe"]
    plan = pipe.plan(*streamed["batch0"])
    fetched = pipe._gather(plan)
    pmask = torch.from_numpy(plan.pmask).cuda()
    post, ids, remap = fetched.tensors()
    pc, pm, pq = scan._pad_tile(remap, pmask, plan.queries_dev, scan.BQ)
    tc, qs = scan.plan_tile_probes(pc, pm, scan.BQ, post.shape[0])
    chunks = scan.b2_chunks(tc.shape[0], tc.shape[1], k2, tc.device)
    t = time_two_ways(lambda: scan.ivf_scan_topk_planned(
        post, ids, tc, qs, pq, k2=k2), n=100)
    ms = t["events"]
    one_block = time_ms(lambda: scan.ivf_scan_topk_planned(
        post, ids, tc, qs, pq, k2=k2, chunks=1), n=100)
    split = kernel_split_ms(lambda: scan.ivf_scan_topk_planned(
        post, ids, tc, qs, pq, k2=k2), B2_PARTS, n=20)
    log(f"[times] B2 on one phase-8 batch: {tc.shape[0]} tiles x {chunks} "
        f"chunks = {tc.shape[0] * chunks} blocks, {ms:.4f} ms (ms a launch "
        f"by kernel: {split}); one block a tile {one_block:.4f} ms")
    wrapper = time_ms(lambda: scan.ivf_scan_topk_cuda(
        post, ids, remap, pmask, plan.queries_dev, k2=k2), n=100)
    by_cluster = time_two_ways(lambda: scan.ivf_scan_topk_cuda(
        post, ids, remap, pmask, plan.queries_dev, k2=k2,
        design="by_cluster"), n=100)
    plain = time_ms(lambda: scan.ivf_scan_topk_plain(
        post, ids, remap, pmask, plan.queries_dev, k2=k2), n=10)
    _, l, d = post.shape
    b = plan.queries_dev.shape[0]
    nbytes, flops, used, pairs = b2_work(tc, qs, l, d, b, k2)
    # one resident batch: the plan of phase 7's first batch on the index
    cids, mask, qd = resident["plan0"]
    index_post, index_ids = resident["index"]
    rc, rm, rq = scan._pad_tile(cids, mask, qd, scan.BQ)
    rtc, rqs = scan.plan_tile_probes(rc, rm, scan.BQ, index_post.shape[0])
    r_ms = time_ms(lambda: scan.ivf_scan_topk_planned(
        index_post, index_ids, rtc, rqs, rq, k2=k2), n=100)
    r_wrapper = time_ms(lambda: scan.ivf_scan_topk_cuda(
        index_post, index_ids, cids, mask, qd, k2=k2), n=100)
    r_by_cluster = time_two_ways(lambda: scan.ivf_scan_topk_cuda(
        index_post, index_ids, cids, mask, qd, k2=k2, design="by_cluster"),
        n=100)
    r_plain = time_ms(lambda: scan.ivf_scan_topk_plain(
        index_post, index_ids, cids, mask, qd, k2=k2), n=10)
    r_bytes, r_flops, r_used, r_pairs = b2_work(rtc, rqs, l, d,
                                                qd.shape[0], k2)
    r_bound = bound_ms(r_bytes, r_flops)
    return _row("ivf_scan_topk", "src/repro_torch/csrc/ivf_scan_topk.cu",
                "src/repro/kernels/ivf_scan.py:332",
                kernel_errs["ivf_scan_topk"], ms, plain, nbytes, flops,
                "no single PyTorch call computes a unique-by-id top-k2 over "
                "the probed posting rows",
                f"phase-8 batch: B={b} P={pmask.shape[1]} R={post.shape[0]} "
                f"used_rows={used} pairs={pairs} L={l} D={d} k2={k2} bq=8",
                device_ms=t["queued"], wrapper_ms=wrapper,
                blocks=tc.shape[0] * chunks,
                tiles=tc.shape[0], chunks=chunks, split_ms=split,
                one_block_a_tile_ms=one_block,
                design=scan.b2_design(b, pmask.shape[1], post.shape[0], l,
                                      d, k2),
                by_cluster_ms=by_cluster,
                resident={"ms": r_ms, "wrapper_ms": r_wrapper,
                          "design": scan.b2_design(
                              *cids.shape, index_post.shape[0], l, d, k2),
                          "by_cluster_ms": r_by_cluster,
                          "plain_ms": r_plain, "bound_ms": r_bound,
                          "shape": f"B={qd.shape[0]} "
                                   f"C={index_post.shape[0]} "
                                   f"used_rows={r_used} pairs={r_pairs}"})


def b6a_row(resident: dict, kernel_errs: dict) -> dict:
    """B6a on one resident batch (phase 7's first batch plan), beside
    torch.cdist of each query against its probed blocks gathered
    beforehand, (P * L, D) rows a query (Euclidean, no gather, no mask: the
    basis of B6b's row)."""
    import torch

    from repro_torch.kernels import ivf_scan as scan

    cids, mask, qd = resident["plan0"]
    post, _ = resident["index"]
    t = time_two_ways(lambda: scan.ivf_scan_cuda(post, cids, mask, qd),
                      n=100)
    plain = time_ms(lambda: scan.ivf_scan_plain(post, cids, mask, qd), n=10)
    _, l, d = post.shape
    b, p = cids.shape
    g = post[cids.long().clamp(0, post.shape[0] - 1)].reshape(
        b, p * l, d).contiguous()
    q3 = qd.contiguous()[:, None, :]
    lib = time_two_ways(lambda: torch.cdist(q3, g), n=100)
    live = int(mask.sum())
    uniq = int(cids[mask].unique().numel())
    nbytes = uniq * l * d * 4 + b * d * 4 + b * p * 5 + b * p * l * 4
    flops = (live + uniq) * l * 2 * d
    return _row("ivf_scan", "src/repro_torch/csrc/ivf_scan.cu",
                "src/repro/kernels/ivf_scan.py:111",
                kernel_errs["ivf_scan"], t["events"], plain, nbytes, flops,
                "torch.cdist of each query against its gathered (P*L, D) "
                "rows (gather and mask not included)",
                f"resident batch: B={b} P={p} C={post.shape[0]} live={live} "
                f"unique_clusters={uniq} L={l} D={d}", device_ms=t["queued"],
                library_ms=lib["events"], library_device_ms=lib["queued"])


# kernels that no main path of the port runs, so their rows must count no
# launch: B6b and B7 (as in the reference) and K3, whose calls in the
# splitter and in enforce_size_bound's 2-means went to K23
NO_PATH = ("ivf_scan_clustermajor", "ivf_scan_q8", "kmeans_mstep")


def b6b_union(cids, mask) -> tuple:
    """B6b's work on one resident batch plan: the clusters its live probes
    touch (``active``, A of them) and, for each, the queries that probe it
    (``qsel``, (A, B) bool)."""
    import torch

    live = mask & (cids >= 0)
    active = torch.unique(cids[live]).to(torch.int32).contiguous()
    qsel = ((cids[None, :, :] == active[:, None, None])
            & live[None]).any(dim=-1).contiguous()
    return active, qsel


def b6b_times(post, active, qsel, qd) -> dict:
    """B6b by both timers on (active, qsel), then with every (cluster,
    query) pair selected at the same shape, and torch.cdist on the blocks
    g = postings[clamp(active)] gathered beforehand."""
    import torch

    from repro_torch.kernels import ivf_scan as scan

    every = torch.ones_like(qsel)
    g = post[active.long().clamp(0, post.shape[0] - 1)].contiguous()
    return {
        "union": time_two_ways(lambda: scan.ivf_scan_clustermajor_cuda(
            post, active, qsel, qd), n=100),
        "all_selected": time_two_ways(lambda: scan.ivf_scan_clustermajor_cuda(
            post, active, every, qd), n=100),
        "cdist": time_two_ways(lambda: torch.cdist(g, qd[None]), n=100)}


def b6b_row(resident: dict, kernel_errs: dict) -> dict:
    """B6b on the probed-cluster union of one resident batch (phase 7's
    first plan): every row of each active cluster against all 32 queries,
    then with every (cluster, query) pair selected at the same shape.  The
    yardstick is torch.cdist on the blocks gathered beforehand."""
    from repro_torch.kernels import ivf_scan as scan

    cids, mask, qd = resident["plan0"]
    post, _ = resident["index"]
    active, qsel = b6b_union(cids, mask)
    qd = qd.contiguous()
    times = b6b_times(post, active, qsel, qd)
    t, dense, lib = times["union"], times["all_selected"], times["cdist"]
    plain = time_ms(lambda: scan.ivf_scan_clustermajor_plain(
        post, active, qsel, qd), n=10)
    a_n = active.numel()
    _, l, d = post.shape
    b = qd.shape[0]
    nbytes = a_n * l * d * 4 + b * d * 4 + a_n * 4 + a_n * b \
        + a_n * l * b * 4
    flops = a_n * l * b * 2 * d + a_n * l * 2 * d + b * 2 * d
    log(f"[times] B6b resident union A={a_n}: {t['queued']:.5f} ms device, "
        f"all pairs selected {dense['queued']:.5f} ms, torch.cdist on the "
        f"gathered blocks {lib['queued']:.5f} ms (device)")
    return _row("ivf_scan_clustermajor",
                "src/repro_torch/csrc/ivf_scan_clustermajor.cu",
                "src/repro/kernels/ivf_scan.py:160",
                kernel_errs["ivf_scan_clustermajor"], t["events"], plain,
                nbytes, flops, "torch.cdist(g, queries[None]) on the blocks "
                "g = postings[clamp(active)] gathered beforehand: Euclidean, "
                "not squared, no gather and no mask",
                f"resident batch union: A={a_n} L={l} D={d} B={b} "
                f"selected_pairs={int(qsel.sum())}", device_ms=t["queued"],
                library_ms=lib["events"], library_device_ms=lib["queued"],
                all_selected={"ms": dense["events"],
                              "device_ms": dense["queued"],
                              "selected_pairs": a_n * b})


def b7_work(cids, mask, l: int, d: int) -> tuple:
    """B7's bytes (each distinct probed block, its norms, centroid and
    scale once, the queries, the plan and the output) and operations."""
    b, p = cids.shape
    live = int(mask.sum())
    uniq = int(cids[mask].unique().numel())
    nbytes = uniq * (l * d + l * 4 + d * 4 + 4) + b * d * 4 + b * p * 5 \
        + b * p * l * 4
    return nbytes, live * (l * (2 * d + 3) + 3 * d), live, uniq


def b7_args(qi, cids, mask, qd) -> tuple:
    """B7's arguments for one resident batch plan over the q8 payload
    ``qi`` of the resident index."""
    return (qi.q8, qi.qscale, qi.qnorm2, qi.centroids, cids.contiguous(),
            mask.contiguous(), qd.contiguous())


def b7_row(resident: dict, kernel_errs: dict) -> dict:
    """B7 on one resident batch (phase 7's first plan) over the q8
    payload of the resident index, in the variant its codes take and on a
    copy of them at 16k+4 bytes (vec4), and on seeded inputs at a batch of
    several waves (B 256, P 16, C 8192)."""
    from repro_torch.kernels import ivf_scan_q8 as q8m

    cids, mask, qd = resident["plan0"]
    qi = resident["qindex"]
    args = b7_args(qi, cids, mask, qd)
    t = time_two_ways(lambda: q8m.ivf_scan_q8_cuda(*args), n=100)
    v4 = (vec4_codes(args[0]),) + args[1:]
    vec4 = time_two_ways(lambda: q8m.ivf_scan_q8_cuda(*v4), n=100)
    plain = time_ms(lambda: q8m.ivf_scan_q8_plain(*args), n=10)
    _, l, d = qi.q8.shape
    b, p = cids.shape
    nbytes, flops, live, uniq = b7_work(cids, mask, l, d)
    big = b7_waves()
    return _row("ivf_scan_q8", "src/repro_torch/csrc/ivf_scan_q8_legacy.cu",
                "src/repro/kernels/ivf_scan_q8.py:83",
                kernel_errs["ivf_scan_q8"], t["events"], plain, nbytes,
                flops, "no single PyTorch call gathers each query's probed "
                "int8 blocks and computes the residual-form distances",
                f"resident batch: B={b} P={p} C={qi.q8.shape[0]} live={live} "
                f"unique_clusters={uniq} L={l} D={d} variant="
                f"{q8m.ivf_scan_q8_variant(d, qi.q8.data_ptr())}",
                device_ms=t["queued"], vec4_device_ms=vec4["queued"],
                waves=big)


B7_WAVES = (8192, 128, 128, 256, 16)     # C, L, D, B, P


def b7_waves() -> dict:
    """B7 at a batch that is not one wave, on seeded q8_legacy_inputs."""
    from repro_torch.kernels import ivf_scan_q8 as q8m

    c, l, d, b, p = B7_WAVES
    args = q8_legacy_inputs(c, l, d, b, p, seed=1807)
    t = time_two_ways(lambda: q8m.ivf_scan_q8_cuda(*args), n=50)
    nbytes, flops, live, uniq = b7_work(args[4], args[5], l, d)
    bound = bound_ms(nbytes, flops)
    out = {"ms": t["events"], "device_ms": t["queued"], "bound_ms": bound,
           "shape": f"B={b} P={p} C={c} live={live} unique_clusters={uniq} "
                    f"L={l} D={d}"}
    log(f"[times] B7 at {out['shape']}: {t['queued']:.5f} ms device, bound "
        f"{bound:.5f} ms ({bound / t['queued']:.1%})")
    return out


def b5_row(built: dict, kernel_errs: dict) -> dict:
    """B5 on one 16,384-row build chunk against the final 1M centroids,
    with torch.cdist as the library yardstick, and over every launch of
    phase 10's unfused build."""
    import torch

    from repro_torch.kernels import pairwise_l2 as pw

    a = torch.from_numpy(built["x"][:16384]).cuda()
    b = built["index"].centroids.contiguous()
    t = time_two_ways(lambda: pw.pairwise_l2_cuda(a, b), n=10, warm=2)
    plain = time_ms(lambda: pw.pairwise_l2_plain(a, b), n=10, warm=2)
    library = time_ms(lambda: torch.cdist(a, b), n=10, warm=2)
    n, d = a.shape
    m = b.shape[0]
    return _row("pairwise_l2", "src/repro_torch/csrc/pairwise_l2.cu",
                "src/repro/kernels/pairwise_l2.py:71",
                kernel_errs["pairwise_l2"],
                t["events"], plain, (n + m) * d * 4 + n * m * 4,
                2 * n * m * d,
                "torch.cdist(a, b): the square root of the same quantity "
                "(Euclidean, not squared), timed as the yardstick",
                f"N={n} M={m} D={d} (one build chunk vs the final centroids, "
                f"{pw.pairwise_l2_variant(n, m, d)} variant)",
                library_ms=library, device_ms=t["queued"],
                unfused_build=b5_unfused_shapes())


def bound_ms(nbytes: int, flops: int) -> float:
    """The least time the card could take: the bytes over its memory rate
    or the fp32 operations over its peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3


def b5_bound_ms(n: int, m: int, d: int) -> float:
    return bound_ms((n + m) * d * 4 + n * m * 4, 2 * n * m * d)


def b5_shape_times(shapes: dict, launch, variant_of=None,
                   seed: int = 27) -> dict:
    """B5 through ``launch`` (a function with ``pairwise_l2_cuda``'s
    signature) at every distinct (N, M, D) of ``shapes`` (shape ->
    launches), on standard normal inputs made from ``seed``: each shape
    timed by :func:`time_two_ways`, and its times and bound summed over its
    launches, in all and, given ``variant_of(n, m, d)``, by variant."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sums: dict = {}
    for (n, m, d), count in sorted(shapes.items()):
        a = torch.from_numpy(rng.standard_normal((n, d), np.float32)).cuda()
        b = torch.from_numpy(rng.standard_normal((m, d), np.float32)).cuda()
        reps = 50 if n * m <= 1 << 20 else 10
        t = time_two_ways(lambda: launch(a, b), n=reps)
        keys = ["all"] + ([variant_of(n, m, d)] if variant_of else [])
        for key in keys:
            acc = sums.setdefault(key, {"launches": 0, "shapes": 0,
                                        "ms_sum_events": 0.0,
                                        "ms_sum_device": 0.0,
                                        "bound_ms_sum": 0.0})
            acc["launches"] += count
            acc["shapes"] += 1
            acc["ms_sum_events"] += count * t["events"]
            acc["ms_sum_device"] += count * t["queued"]
            acc["bound_ms_sum"] += count * b5_bound_ms(n, m, d)
    return sums


def b5_unfused_shapes() -> dict:
    """B5 at the shapes phase 10's unfused build launched it with: every
    distinct shape timed and summed over its launches (beside the bound's
    sum), and the kernel, the plain version and torch.cdist timed at the
    shape that launched most and at the one with the most work (launches x
    bound)."""
    import numpy as np
    import torch

    from repro_torch.kernels import pairwise_l2 as pw

    if not B5_SHAPES:
        raise AssertionError("phase 10 recorded no B5 launch")
    shapes: dict = {}
    for sh in B5_SHAPES:
        shapes[sh] = shapes.get(sh, 0) + 1
    work = {sh: c * b5_bound_ms(*sh) for sh, c in shapes.items()}
    picks = {"most_launched": max(shapes, key=lambda sh: shapes[sh]),
             "most_work": max(work, key=lambda sh: work[sh])}
    rng = np.random.default_rng(27)
    out = {"launches": len(B5_SHAPES), "distinct_shapes": len(shapes),
           "bound_ms_sum": float(sum(work.values())),
           "narrow_max_m": pw.NARROW_MAX_M,
           "all_launches": b5_shape_times(shapes, pw.pairwise_l2_cuda,
                                          pw.pairwise_l2_variant)}
    for tag, (n, m, d) in picks.items():
        a = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).cuda()
        reps = 200 if n * m <= 1 << 20 else 10
        t = time_two_ways(lambda: pw.pairwise_l2_cuda(a, b), n=reps)
        out[tag] = {"shape": f"N={n} M={m} D={d}",
                    "variant": pw.pairwise_l2_variant(n, m, d),
                    "launches": shapes[(n, m, d)],
                    "ms": t["events"], "device_ms": t["queued"],
                    "plain_ms": time_ms(lambda: pw.pairwise_l2_plain(a, b),
                                        n=reps),
                    "library_ms": time_ms(lambda: torch.cdist(a, b), n=reps),
                    "bound_ms": b5_bound_ms(n, m, d)}
    log(f"[times] B5 at the unfused build's shapes: {out}")
    return out


def _row(name, source, replaces, err, ms, plain_ms, nbytes, flops,
         library_note, shape, *, library_ms=None, **extra) -> dict:
    """One kernel's JSON row; its launches are the sum over every main-path
    run that :func:`path_launches` recorded."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    by_path = {what: counts[name] for what, counts in PATH_RUNS.items()
               if counts[name]}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library_ms is None else float(library_ms),
            "library_note": library_note, "shape": shape, **extra}


# --------------------------------------------------------------------------
# phase 18: the mesh train steps and the dry run (launch/cells.py,
# launch/dryrun.py)
# --------------------------------------------------------------------------
MESH_TRAIN_STEPS = 3             # (a): timed after the first
MESH_MOE_TOKENS = (2, 4096)      # (a): one qwen2-moe layer's batch
MESH18_BACKEND = "nccl"          # (a): one rank, one card
DRY_MESH = "single"              # (b): the sweep's mesh here ("multi" runs
                                 # on a CPU host, PERF.md section 4)
DRY_PROCS = 6                    # (b): children sharing the sweep's cells
DRY_TIMEOUT_S = 300              # (b): the sweep's bound
EXAMPLE_ARGS = {"quickstart_torch": [],
                "serve_anns_torch": ["--batches", "6"]}
# a child of the sweep: run_cell for each (arch, shape, mesh) it is given
DRY_CHILD = ("import json, sys\n"
             "from repro_torch.launch.dryrun import run_cell\n"
             "for a, s, m in json.loads(sys.argv[1]):\n"
             "    run_cell(a, s, m, sys.argv[2])\n")


def dryrun_sweep(work: str) -> dict:
    """Phase 18 (b): the dry run of every cell on ``DRY_MESH`` (meta
    tensors over a fake process group; the children see no card), its
    cells dealt to ``DRY_PROCS`` child processes on the host; per family
    the cells ok, failed and skipped and the slowest cell.  Any failed
    cell fails the phase (no cell of the reference's fails: PERF.md
    section 6).  Started beside phases 3-17 at a low priority, one child
    took 1,018-1,051 s of wall for 140 s of cells on an H100 host (PERF.md
    section 6): the host's cores are busy there."""
    import glob

    from repro_torch.configs import get
    from repro_torch.launch.dryrun import cell_list

    out = os.path.join(work, "dryrun")
    cells = cell_list(mesh=DRY_MESH, all_=True, out_dir=out)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = []
    for i in range(DRY_PROCS):
        logf = open(os.path.join(work, f"dryrun{i}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DRY_CHILD,
             json.dumps(cells[i::DRY_PROCS]), out], env=env, cwd=ROOT,
            stdout=logf, stderr=subprocess.STDOUT))
        logf.close()
    try:
        rcs = [p.wait(timeout=max(1.0, DRY_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
               for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"dry run (b): the sweep did not finish in "
                             f"{DRY_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    fams: dict = {}
    failed = []
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        fam = fams.setdefault(get(rec["arch"]).family, {
            "ok": 0, "failed": 0, "skipped": 0, "slowest": ("", 0.0),
            "seconds": 0.0})
        if rec["ok"] is None:
            fam["skipped"] += 1
            continue
        if not rec["ok"]:
            fam["failed"] += 1
            failed.append(f"{rec['arch']}.{rec['shape']}: {rec['error']}")
            continue
        fam["ok"] += 1
        secs = rec["seconds"]["lower"] + rec["seconds"]["compile"]
        fam["seconds"] += secs
        if secs > fam["slowest"][1]:
            fam["slowest"] = (f"{rec['arch']}.{rec['shape']}", secs)
    for name, fam in fams.items():
        log(f"[dryrun] (b) {name}: {fam['ok']} ok, {fam['failed']} failed, "
            f"{fam['skipped']} skipped on the {DRY_MESH} mesh; cells "
            f"{fam['seconds']:.1f} s, slowest {fam['slowest'][0]} "
            f"{fam['slowest'][1]:.1f} s")
    n_ok = sum(f["ok"] for f in fams.values())
    log(f"[dryrun] (b) the sweep over {DRY_PROCS} children: {wall:.1f} s, "
        f"exit codes {rcs}, {n_ok} cells ok")
    want = 40 * (2 if DRY_MESH == "both" else 1)
    if any(rcs) or failed or n_ok != want:
        raise AssertionError(f"dry run (b): exit codes {rcs}, {n_ok} ok, "
                             f"failed {failed}")
    return {"families": fams, "wall_s": wall}


def mesh_step_case(work: str, name: str, arch, cell: str, params,
                   batch) -> dict:
    """One cell's train step at one NCCL rank on the card (DTensors over
    a (1, 1) mesh: the placements, regions and AdamW's redistributions)
    against the one-process step on the same arrays, both run and
    compared in the rank (``repro_torch.testing.mesh_step_check``)."""
    import torch

    from repro_torch import testing
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn

    path = os.path.join(work, "mesh18")
    os.makedirs(path, exist_ok=True)
    torch.save((params, batch), os.path.join(path, f"{name}.pt"))
    job = {"kind": testing.mesh_step_check, "arch": arch, "cell": cell,
           "work": path, "args": name, "shape": (1, 1),
           "steps": MESH_TRAIN_STEPS}
    res = spawn(mesh_jobs.run, (1,), ("data",), backend=MESH18_BACKEND,
                device=DEVICE, args=([job],),
                timeout_s=MESH_TIMEOUT_S)[0][0]
    if abs(res["loss"] - res["one_loss"]) > 1e-5 * abs(res["one_loss"]):
        raise AssertionError(f"mesh train (a) {name}: loss {res['loss']} "
                             f"vs {res['one_loss']}")
    if res["param_excess"] > STEP_PARAM_ATOL:
        raise AssertionError(f"mesh train (a) {name}: params "
                             f"{res['param_excess']} beyond the step gap "
                             f"(> {STEP_PARAM_ATOL})")
    if res["moment_gap"] > 1e-5:
        raise AssertionError(f"mesh train (a) {name}: moments "
                             f"{res['moment_gap']} of the largest")
    return res


def mesh_train_steps(work: str, card: str) -> dict:
    """Phase 18 (a): MIND at batch 65,536 and one qwen2-moe layer's block
    (float32, capacity factor 4, its attention rescaled as phase 17's)
    through ``make_train_step(mesh=...)`` at one NCCL rank, and
    ``kmeans_sharded_step`` on DTensors (K2 in its ``local_map``)."""
    import numpy as np
    import torch

    from repro_torch.configs import ArchDef, ShapeDef, get
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.lm import transformer as tf
    from repro_torch.models.recsys import models as rm

    out = {}
    mind = get("mind")
    g = torch.Generator().manual_seed(61)
    p = rm.init_params(mind.config, g, "cpu")
    rng = np.random.default_rng(67)
    rows, seq, b = mind.config.table_rows, mind.config.seq_len, TRAIN_BATCH
    t = torch.from_numpy
    batch = {"sparse_ids": t(rng.integers(0, rows, (b, 1)).astype(np.int32)),
             "labels": t(rng.integers(0, 2, b).astype(np.float32)),
             "hist_ids": t(rng.integers(-1, rows, (b, seq)).astype(np.int32)),
             "hist_len": t(rng.integers(1, seq + 1, b).astype(np.int32))}
    out["mind"] = mesh_step_case(work, "mind", mind, "train_batch", p,
                                 batch)
    del p, batch
    qcfg = get("qwen2_moe").config
    qcfg = dataclasses.replace(
        qcfg, n_layers=1, dtype=torch.float32,
        moe=dataclasses.replace(qcfg.moe, capacity_factor=MOE_CAPACITY))
    qarch = ArchDef("qwen2_moe", "lm", qcfg, {"train_4k": ShapeDef(
        "train_4k", "train", MESH_MOE_TOKENS[0], MESH_MOE_TOKENS[1])})
    qp = tf.init_params(qcfg, torch.Generator().manual_seed(71), "cpu")
    contracted_fan_in(qp, qcfg)
    toks = t(np.random.default_rng(73).integers(
        0, qcfg.vocab, (MESH_MOE_TOKENS[0], MESH_MOE_TOKENS[1] + 1))
        .astype(np.int32))
    out["moe"] = mesh_step_case(work, "moe", qarch, "train_4k", qp, toks)
    del qp
    # K2 in kmeans_sharded_step's local_map, on DTensors
    path = os.path.join(work, "mesh18")
    x = np.random.default_rng(79).normal(size=(LLOYD_ROWS, 128)).astype(
        np.float32)
    cents = x[:LLOYD_K].copy()
    mesh_write(path, {"x": x, "cents": cents})
    ranks = spawn(mesh_jobs.run, (1,), ("data",), backend=MESH18_BACKEND,
                  device=DEVICE, args=([{"kind": "kmeans", "work": path,
                                         "steps": 3, "global_view": True,
                                         "shape": (1, 1)}],),
                  timeout_s=MESH_TIMEOUT_S)
    res = ranks[0][0]
    fired = mesh_launches([res], "mesh train (a) K2 global view (phase 18)")
    if DEVICE == "cuda" and not fired.get("kmeans_assign_update"):
        raise AssertionError(f"mesh train (a): K2 did not launch ({fired})")
    from repro_torch.kernels import ops as kops

    xd, cd = torch.from_numpy(x).to(DEVICE), torch.from_numpy(cents).to(
        DEVICE)
    _, _, sums, counts = kops.kmeans_assign_update(xd, cd)
    c = counts.float()[:, None]
    want = torch.where(c > 0, sums / torch.clamp_min(c, 1.0), cd).cpu()
    if not np.array_equal(res["counts"], counts.cpu().numpy()):
        raise AssertionError("mesh train (a): K2 counts differ")
    err = float((torch.from_numpy(res["centroids"]) - want).abs().max())
    if err > 1e-5:
        raise AssertionError(f"mesh train (a): K2 centroids {err}")
    del xd, cd
    free_card()
    out["k2"] = {"ms": res["ms_per_step"], "max_abs_err": err}
    gib = lambda n: n / 2**30
    for name, what in (("mind", f"MIND at batch {TRAIN_BATCH} (table "
                                f"{rows} x 64)"),
                       ("moe", f"one qwen2-moe layer (64 experts, d 2048, "
                               f"vocab 151,936, float32) on "
                               f"{MESH_MOE_TOKENS[0]} x "
                               f"{MESH_MOE_TOKENS[1]} tokens")):
        r = out[name]
        log(f"[mesh18] (a) {what}: make_train_step(mesh=...) at one NCCL "
            f"rank on {card}, mesh (1, 1): loss {r['loss']:.6g} equal to "
            f"the one-process step within rtol 1e-5, params within "
            f"{STEP_PARAM_ATOL} beyond the step gap (worst "
            f"{r['param_excess']:.3g}), moments within "
            f"{r['moment_gap']:.3g} of the largest; "
            f"{', '.join(f'{m:.2f}' for m in r['ms'])} ms a step, one "
            f"process {r['one_ms']:.2f} ms (host clock around a "
            f"synchronized step); peak {gib(r['peak']):.2f} GiB, one "
            f"process {gib(r['one_peak']):.2f} GiB")
    log(f"[mesh18] (a) kmeans_sharded_step on DTensors ({LLOYD_ROWS} x 128, "
        f"K {LLOYD_K}) at one NCCL rank: K2 launched {fired}, counts equal "
        f"to one K2, centroids within {err:.3g}; "
        f"{out['k2']['ms']:.3f} ms a step")
    return out


def examples_on_card(card: str) -> dict:
    """Phase 18 (c): ``examples/quickstart_torch.py`` and
    ``examples/serve_anns_torch.py`` on the card, through their own
    arguments."""
    import importlib.util

    out = {}
    for name, argv in EXAMPLE_ARGS.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        res = mod.run(mod.build_parser().parse_args(
            ["--device", DEVICE] + argv))
        res["seconds"] = time.perf_counter() - t0
        if res["recall"] < 0.95:
            raise AssertionError(f"example {name}: recall {res['recall']}")
        out[name] = res
        log(f"[examples] (c) {name} on {card}: recall@10 "
            f"{res['recall']:.4f}, {res['seconds']:.1f} s"
            + (f", {res['qps']:.0f} q/s (host clock)" if "qps" in res
               else f", mean nprobe {res['mean_nprobe']:.2f}"))
    free_card()
    return out


def phase_cells(work: str, card: str) -> dict:
    """Phase 18: (a) the mesh train steps, (b) the dry run, (c) both
    examples on the card."""
    t0 = time.perf_counter()
    out = {"a": mesh_train_steps(work, card), "c": examples_on_card(card),
           "b": dryrun_sweep(work)}
    log(f"[mesh18] phase 18 {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = phase_device()
    CARD[0] = dev["card"]
    kernel_errs = phase_kernels()
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    served = streamed = None
    try:
        built = phase_build(work)
        served = phase_serve(work, built)
        phase_parity(work, built, served)
        phase_fresh(work, built, served)
        resident = phase_resident(built, served)
        streamed = phase_streamed_f32(built, served, resident)
        phase_cpu_resident(built, served, resident)
        phase_unfused(work)
        phase_engine(work, built, served)
        phase_rebuild(work, built, served)
        phase_fabric(built, served, streamed)
        phase_cli(work)
        phase_mesh(work, built, served, resident)
        phase_train(work, dev["card"])
        phase_lm(work, dev["card"])
        phase_cells(work, dev["card"])
        rows = phase_times(built, served, kernel_errs, resident, streamed)
    finally:
        if served is not None:
            served["pipe"].close()
            served["pipe"].flash.release()
        if streamed is not None:
            streamed["pipe"].close()
        shutil.rmtree(work, ignore_errors=True)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
