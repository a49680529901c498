#!/usr/bin/env python3
"""Drive the torch port (``bytewax_tpu_torch``) on one CUDA card and
check it.

Phases, each of which raises on any failure:

0. analysis — ``python -m bytewax_tpu_torch.analysis --json --timings``
   over this checkout (the engine-contract analyzer, pure AST); its
   line carries the rules run, the findings and the seconds, and any
   finding fails the run;
1. build   — compile every kernel of the main path from the sources in
   this checkout (``nvcc``, ``sm_90a``);
2. kernel  — hold the segment-fold kernel against its plain PyTorch
   version on the card: every aggregation kind, float32 and int32,
   all three row sources, 2^20 rows, capacity 1024 and 16384; rows
   with NaN values, and rows that all fold into one slot; the
   (slot, value) rows of the windowed folds at 10·2^20 rows and
   capacities 32768 and 131072; then time it at the main paths'
   shapes (device time per launch, the wrapper's host time per call);
3. main    — the 1BRC keyed aggregation (``brc_flow_columnar``) through
   ``run_main`` at 32·2^20 rows in 2^20-row micro-batches, over 413
   and over 10,000 stations, checked against a float64 numpy
   reference and against the kernel's launch count;
4. items   — the itemized paths (``brc_flow`` over Python tuples,
   ``count_final`` over strings), float32 and int32 state;
5. ingest  — 2^22 lines of 1BRC text (10,000 stations) read by
   ``FileSource(columnar=True)``, split by ``ops.text.split_fields``
   and folded by ``xla.stats_final``, once with the line gather on
   the host and once on the card (``BYTEWAX_TPU_TEXT_DEVICE=1``); and
   wordcount over 2^20 lines of 10 words from a 1,000-word vocabulary
   through ``wordcount_flow(FileSource(..., columnar=True))``;
6. windows — event-time windows over dictionary-encoded 1BRC readings
   (10,000 stations, one event-minute per 2^20-row batch, 1% of rows
   late): ``stats_window`` over tumbling 1-minute windows (16·2^20
   rows), over sliding 10-minute windows every minute (8·2^20 rows),
   and ``count_window`` over 60 s sessions (4·2^20 rows; each station
   goes quiet for 2–5 event-minutes), each with its p99 window-close
   latency;
7. scan    — hold each instance of the segmented-scan kernel
   (``welford``, ``ema``, ``extrema``; one launch a call) against its
   plain PyTorch version on the card: 2^20 grouped rows over 10,000
   keys (a fresh and a resumed table), over 2^20 keys (mostly one-row
   segments, a grown table), all on one key, NaN rows (extrema), runs
   of equal values (welford: z and m2 exactly 0), EMA at alpha 1 and
   1e-8, 2^20 + 37 rows (a ragged last tile), 5 rows (below one tile),
   2^24 rows on one key (more tiles than the card holds at once), and
   calls of every instance and several sizes back to back on one
   stream with no sync between them; then time each instance at 2^20
   rows and 10,000 keys, warm and with the L2 flushed before each
   call;
8. anomaly — the scan tier and streaming inference through
   ``run_main``: ``anomaly_flow`` over dictionary-encoded 2^20-row
   batches from 10,000 sensors (8 batches) and over 2^20 sensors (2
   batches), ``anomaly_infer_flow`` over 2^20 itemized rows, and the
   ``ema`` and ``running_extrema`` flows at 10,000 sensors, each held
   against a float64 numpy oracle (values exact and in order per key,
   z within 1e-4 of max(1, |z|), flags equal, EMA within 1e-4
   relative, extrema exact); then 8.x, the hot swap at full width:
   ``anomaly_infer_flow`` again over the same rows in 2^16-item chunks,
   one epoch a chunk, with ``update_params`` arming threshold 2.5
   before the run: one swap (its epoch read from the flight ring), the
   rows written before it flagged at 3.0 and every later row at 2.5,
   the step's params on ``cuda`` with the armed digest and the
   install's host seconds; one chunk with a mismatched tree, rejected
   once, its output that of a run with no swap; 8.y, a scan kind of
   the user's own (a running sum and count, no ``kernel``, its
   ``lift`` building a column without ``device=``) through
   ``op.stateful_map`` over one batch of the 10,000 sensors with a
   store, its tables on ``cuda`` and no ``segment_scan`` launch, then
   resumed with ``BYTEWAX_TPU_ACCEL=0`` over a 2^16-row tail (counts
   exact, totals within 1e-5 of the running sum of |value|), and the
   generic body's device ms a 2^20-row batch; 8.z,
   ``torch_stateful_map`` of a capped decay over the same batch (within
   1e-4 of max(1, |total|) of a float64 oracle), with its ``vmap``
   steps and device ms a batch;
9. recovery — SQLite recovery stores (``init_db_dir``,
   ``RecoveryConfig``, one epoch a batch) driven on the card, each run
   checked against its oracle: ``brc_flow_columnar`` over 16·2^20 rows
   at 10,000 stations with no store, synchronous checkpoints, delta and
   async commits (``BYTEWAX_TPU_CKPT_DELTA``/``_ASYNC``), and those
   with a crash at the seal of epoch 8 (``BYTEWAX_TPU_FAULTS``) and a
   resume; ``anomaly_flow`` at 2^19 sensors over 2 batches,
   synchronous, delta and async, and those with a crash at the seal
   of epoch 2 and a resume, exactly once through a sink with
   ``FileSink``'s resume truncation; tumbling ``stats_window`` at
   10,000 stations aborted after 4 of 8 batches and resumed, with the
   window-state install timed per window and in pages; and the 1BRC
   flow rescaled in one process from 2 lanes to 3
   (``BYTEWAX_TPU_RESCALE=1``) and to 1.  Each line carries rows/s,
   the ledger phases ``snapshot``, ``commit`` and ``snapshot_lane``,
   store rows per close, the store's size, the resume's read and
   install seconds, the migration's seconds and the launches;
10. cluster — clusters of processes on the one card, each child
   importing the port on its own and reporting at exit (its device,
   both kernels' launches, demotions, ledger phases, start-up
   seconds): 2^23 lines of 1BRC text at 10,000 stations read by
   ``BrcFileSource`` through ``python -m bytewax_tpu_torch.run`` (one
   process) and through ``python -m bytewax_tpu_torch.testing -p 2``
   and ``-p 4``, each process's output in its own file; ``anomaly_flow``
   over 8·2^20 readings of 10,000 sensors on 2 processes, partition p
   reading the sensors whose id is p modulo 2; and the 1BRC file with a
   recovery store under ``run --autoscale 2:2``, process 1 SIGKILLed
   once epoch 8 is durable, relaunched by the supervisor, exactly once
   against the oracle, with the time to recover;
11. sharded — the per-process mesh-sharded tier: the shard-bucketing
   kernel held against its plain version exactly (2^20 rows in 2, 4
   and 8 source blocks and shards; keys uniform over 10,000 and over
   2^20, and one key on half the rows; a capacity at the true bucket
   maximum and at half of it; the fold's lanes and the scan's) and
   timed at the sharded flows' shapes; then ``brc_flow_columnar``
   (8·2^20 rows, 10,000 stations), one 2^20-row batch with one station
   on half its rows, tumbling ``stats_window`` (phase 6's data, 8
   batches) and ``anomaly_flow`` (phase 8's 10,000 sensors) through
   ``run_main`` with ``BYTEWAX_TPU_SHARD=4`` over 4 shards of
   ``cuda:0`` and again on the single-device tier, each against its
   oracle and the two tiers against each other; each ``sharded`` line
   carries both tiers' rows/s, the launches of the three kernels, the
   host's bucket-sizing seconds and the ledger phases.  The same flows
   run over every card where there is more than one; one card prints
   a line saying the mesh of distinct cards was not reached;
12. global  — the cluster-wide exchange tier (``BYTEWAX_TPU_DISTRIBUTED=1``):
   the dequantize-and-merge kernel held against its plain version bit
   for bit (every op, encoding and table dtype; frames of 8,192 and
   16,384 rows with n below the padded length, and of one row; NaN,
   ±inf and negative values; every case twice) and timed; then 1BRC
   columnar batches (8·2^20 rows, 413 stations, 2 partitions) through
   ``python -m bytewax_tpu_torch.testing -p 2`` with every process on
   ``cuda:0`` and the gloo transport staged through pinned host
   memory: lock-step exact, overlapped at depth 1 and 2, quantized
   ``int8`` and ``bf16`` (device merge), ``int8`` with
   ``BYTEWAX_TPU_WIRE=pickle`` (host fold), an all-integer workload on
   the exact tier, the device merge and the host fold (the three
   bit-identical), and 10,000 stations on 4 processes; the lock-step
   flow and the wide one again on the per-process cluster tier (the
   variable unset); each ``global`` line carries rows/s, the transport,
   the ledger's ``gsync`` and ``collective_lane`` seconds, the h2d and
   d2h bytes and each process's launches of the bucket, fold and merge
   kernels.  Then the lock-step data twice more with a recovery store
   and ``BYTEWAX_TPU_GSYNC_OVERLAP=1`` (the store-composable overlap),
   one epoch a batch, process 1 crashing inside a send at epoch 4 and
   the supervisors restarting both processes: exact at depth 1 (the
   resume replays the store's rounds through the bucket and fold
   kernels), and all-integer ``int8`` at depth 2 with a baseline every
   2 rounds (the resume installs a baseline and replays a round
   through the merge kernel); each exactly once against the oracle,
   with the time to recover, the gsync rows written, replayed and
   tombstoned and each restarted run's launches.  Where there are
   several cards, the lock-step flow again with one process a card on
   NCCL; one card prints a line saying that was not reached;
13. kafka  — 2^20 1BRC messages (10,000 stations; the key is the
   station, the value the ASCII temperature) on 4 partitions of the
   port's in-process Kafka broker, read by ``KafkaSource(columnar=True)``,
   decoded with numpy and folded by ``xla.stats_final`` through
   ``run_main``, against the float64 oracle; its line carries
   messages/s, the columnar and itemized polls and the launches;
14. operators — the public operators that lower to the fold kernel,
   over phase 6's data at full width (10,000 stations, an event-minute
   a 2^20-row dictionary-encoded batch, 1% late): ``fold_window`` with
   ``xla.MEAN`` over tumbling windows (8 batches), ``fold_window`` with
   ``xla.SUM`` and ``operator.add`` over sliding 10-minute windows (2),
   ``reduce_window`` with ``xla.MIN`` and ``xla.MAX`` (4 each),
   ``mean_window`` over 60 s sessions (4), and ``reduce_final`` with
   ``xla.MIN`` and ``xla.MAX`` and no window (8 each), each line with
   rows/s, its p99 window-close latency and its launches; then the
   fall-backs the reference defines, over 2^16 rows of the tumbling
   data: a plain Python folder, itemized rows the promotion cannot
   read, and a session fold with its own merger, each launching the
   kernel no time and equal to the lowered run on the same rows (and
   ``(station, TsValue)`` rows, which promote onto the card); and
   ``join``, ``join_window`` and ``collect_window`` over 2^16 keyed
   rows on the card's host against a Python oracle.  The phase fails
   past 90 s;
15. residency — key-state residency and the ingest coalescer
   (``BYTEWAX_TPU_STATE_BUDGET=65536``,
   ``BYTEWAX_TPU_HOST_STATE_BUDGET=131072`` and a spill directory on
   local disk): ``brc_flow_columnar`` over a dictionary of 2^20
   stations, fed float32 batches of 2^18 rows whose rows come 98% from
   a hot band of 2^15 stations that advances 2^14 a batch around a
   ring of 2^18 and 2% from the whole dictionary: 10 batches (the last
   2 spill to disk) against the float64 oracle (counts, min and max
   exact, means within 1e-5 of the mean |value|), with evictions,
   restores to the card from the host and from disk, spill bytes, the
   peak of resident keys at the drain points and one fold a batch; the
   first 4 batches on 4 shards of the card and on the single-device
   tier, equal; the first 6 with a recovery store, one epoch a batch,
   aborted before batch 3 and resumed exactly once; ``anomaly_flow``
   over 4 batches of the same traffic at 2^20 sensors against phase
   8's oracle; a 2^16-row
   run whose every restore fails (``residency_restore``), which
   demotes once after all three tiers hold keys and still equals the
   oracle; and 2^22 1BRC rows at 10,000 stations as 1,024
   dictionary-encoded batches of 2^12 rows through ``ArrayBatchSource``
   at the default coalescing target (far fewer folds than batches)
   and with ``BYTEWAX_TPU_INGEST_TARGET_ROWS=0`` (one fold a batch).
   The phase fails past 90 s;
16. resilience — connector resilience, device-fault demotion, the
   graceful stop and the live endpoints on the card, over 1BRC readings
   (10,000 stations, dictionary-encoded float32 one-decimal values,
   2^20-row batches, one epoch a batch, ``xla.stats_final``, the fold
   of ``brc_flow_columnar`` read before its rounding step): two
   transient ``device_dispatch`` faults retried in place (8 batches,
   8 folds, no demotion); a demotion mid-run (6 batches folded on the
   card, then ``device_dispatch:error:7+`` with
   ``BYTEWAX_TPU_DEMOTE_AFTER=3`` while a 2^16-row tail arrives), at
   pipeline depths 1 and 3, the state read back from the ``cuda``
   tables into host logics, 6 folds before it and none after; tumbling
   ``stats_window`` over phase 6's stations and event-minutes (values
   as float32) demoted with its open windows after 4 batches, and
   ``anomaly_flow`` at 10,000 sensors demoted with its Welford state
   after 4 (``DEMOTE_AFTER=2``), each with a 2^16-row tail on the
   host; ``request_stop()`` from another thread once epoch 4 is
   durable, the run returning ``GracefulStop`` and its store resumed
   with zero epochs replayed, every row once; one run with the API
   server on the loopback polled mid-run (``/status``, ``/metrics``,
   ``/graph``, ``/healthz``: the flow map's device footprint on
   ``/graph`` and ``/metrics`` equal to the state's ``cuda`` tensors'
   ``nbytes``, h2d bytes and the ledger's ``device`` phase above 0),
   a Perfetto dump and an OTLP/HTTP export to a stub collector that
   must receive ``device_dispatch`` spans; and 2^22 lines of 1BRC text,
   one in 1,000 undecodable, through
   ``FileSource(columnar=True, on_error="dlq")`` with
   ``source_poll:error:*:x3`` (3 retries, no restart, one DLQ row a
   poison line). Each case is held to its float64 oracle (counts, min
   and max exactly; means within 1e-5 of the mean |value|; z within
   1e-4 of max(1, |z|); flags equal). The phase fails on a demotion it
   did not plan, a planned one missing or at another launch, a run
   that leaves ``cuda``, and past 90 s;
17. report — one ``{"kernels": [...]}`` line.

Phases 5 and 6 hold their output against a float64 numpy oracle of
the same semantics: counts, min and max exactly, means within 1e-5 of
the rows' mean absolute value.  Every phase that drives a flow resets
both kernels' launch counts just before ``run_main`` and fails if the
run launched its kernel no time (phases 8 to 11 also fail on any step
demoted to the host tier; phase 10 on any process that is not on
``cuda:0``, launched its kernel no time, or exited non-zero; phase 11
on a sharded run that launched the shard-bucketing kernel no time, or
a single-device run that launched it at all; phase 12 on a process
not on ``cuda:0``, an exact run that launched no bucket or no fold
kernel, a quantized run that launched no merge kernel or folded on the
host without ``BYTEWAX_TPU_WIRE=pickle``, any demotion, a child
exiting non-zero, a store run whose restarted processes launched no
merge (quantized) or no bucket or fold (exact), or a store holding a
live ``\x00gsync-`` row after the clean end; phase 14 on a lowered
run that launched no fold, left ``cuda`` or was demoted, and on a
fall-back or host run that folded on the card at all; phase 15 on a
run that left ``cuda`` or its tier, held more keys on the card than
its budget at a drain point, launched its kernel no time, demoted
(except the fault run, which must demote once), evicted, restored or
spilled nothing where it must, or folded other than once a batch).

Every result line is JSON and carries the card's name and power
limit.  The last line is ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: Where every tensor of the run lives.
DEV = "cuda"
#: Phase 3: the 1BRC run's rows and micro-batch rows.
ROWS = 32 << 20
BATCH_ROWS = 1 << 20
#: Rows per kernel check in phase 2, and itemized rows in phase 4.
KERNEL_ROWS = 1 << 20
ITEM_ROWS = 1 << 20
#: Phase 2: rows of the (slot, value) checks at the window tables'
#: capacities (sliding windows expand a 2^20-row batch tenfold).
WINDOW_KERNEL_ROWS = 10 << 20
#: Phase 5: 1BRC text lines and stations; wordcount lines and words.
INGEST_LINES = 1 << 22
INGEST_STATIONS = 10_000
WORDCOUNT_LINES = 1 << 20
WORDS_PER_LINE = 10
WORDCOUNT_VOCAB = 1000
#: Phase 6: stations, rows per batch (one event-minute), late share,
#: and the EventClock's wait.
WINDOW_KEYS = 10_000
WINDOW_BATCH_ROWS = 1 << 20
LATE_SHARE = 0.01
WINDOW_WAIT_S = 30
#: Phase 6 cases: (name, batches).
WINDOW_CASES = (("tumbling", 16), ("sliding", 8), ("session", 4))
#: Tolerance of a float32 mean against the float64 oracle, relative
#: to the rows' mean absolute value (see ``_check_mean``).
MEAN_RTOL = 1e-5
#: The card's memory rate (H100 SXM data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (H100 SXM data sheet).
F32_OPS_PER_S = 67e12
#: Phases 7 and 8: rows per batch, sensors, batches of each flow.
SCAN_ROWS = 1 << 20
SCAN_KEYS = 10_000
ANOMALY_BATCHES = 8
WIDE_KEYS = 1 << 20
WIDE_BATCHES = 2
SCAN_FLOW_BATCHES = 2
THRESHOLD = 3.0
EMA_ALPHA = 0.3
#: Phase 7: rows of the one-key check with more tiles than the card
#: holds at once (8192 tiles of 2048 rows).
SCAN_DEEP_ROWS = 1 << 24
#: z tolerance, relative to max(1, |z|) (the reference's bar is 1e-4).
Z_RTOL = 1e-4


def _card() -> dict:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    name, _, limit = out.partition(",")
    return {"line": out, "name": name.strip(), "power_limit": limit.strip()}


def phase_analysis(card: dict) -> bool:
    """Run the port's contract analyzer over this checkout, as a user
    would, with no baseline; return whether it passed: exit 0 and no
    finding (each finding is printed to stderr)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "bytewax_tpu_torch.analysis",
            "--json",
            "--timings",
            "--no-baseline",
        ],
        capture_output=True,
        text=True,
        cwd=HERE,
        env={**os.environ, "PYTHONPATH": str(HERE)},
        timeout=300,
    )
    seconds = time.perf_counter() - t0
    findings = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    timings = next(
        (json.loads(ln)["timings_s"] for ln in res.stderr.splitlines() if ln.startswith('{"timings_s"')),
        {},
    )
    rules = sorted(r for r in timings if r.startswith("BTX-"))
    for f in findings:
        print(f"{f['path']}:{f['line']} {f['rule']} {f['message']}", file=sys.stderr)
    if res.returncode not in (0, 1) or len(rules) != 11:
        print(res.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the analyzer failed (exit {res.returncode}, {len(rules)} rule(s) timed)")
    _emit(
        card,
        "analysis",
        rules=len(rules),
        findings=len(findings),
        seconds=seconds,
        rule_seconds=sum(timings.values()),
        exit_code=res.returncode,
    )
    if res.returncode != 0 and not findings:
        print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
    return res.returncode == 0 and not findings


def _emit(card: dict, phase: str, **fields) -> None:
    rec = {"phase": phase, "card": card["name"], "power_limit": card["power_limit"]}
    rec.update(fields)
    print(json.dumps(rec), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events around a
    Python loop of calls, after one warm-up call): the device time
    only while the device is slower than the host's calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: The segment-fold kernel's name, as the profiler lists it.
FOLD_KERNEL = ("fold_shared",)
#: The segmented-scan kernel's one launch (a template: one name for
#: its three instances).
SCAN_KERNEL = ("scan_onepass",)
#: Bytes written between calls to flush the card's 50 MB L2.
L2_FLUSH_BYTES = 128 << 20


def _profiled(fn, reps: int, names=FOLD_KERNEL, between=None) -> dict:
    """Device milliseconds per launch of the kernels whose name contains
    one of ``names``, from ``torch.profiler``'s ``key_averages()``
    (``ms``, None when the profiler shows no device time for them); the
    launches of those kernels per call that the device trace holds (it
    can drop a few); and, from the host side, the kernel launches and
    memsets per call of any kind (None with ``between``).  ``between``
    runs before each call, outside the count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    count = 0
    api = {"cudaLaunchKernel": 0, "cudaMemset": 0}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            for prefix in api:
                if evt.key.startswith(prefix):
                    api[prefix] += evt.count
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if any(name in evt.key for name in names):
            total += us / 1e3
            count += evt.count
    host = between is None  # else the host counts hold between's too
    return {
        "ms": total / count if count else None,
        "launches_per_call": count / reps,
        "host_launches_per_call": api["cudaLaunchKernel"] / reps if host else None,
        "host_memsets_per_call": api["cudaMemset"] / reps if host else None,
    }


def _graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call: CUDA events around replays of a
    CUDA graph that captured ``per_graph`` calls (no host work between
    the launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def _host_us(fn, reps: int, rounds: int = 5) -> float:
    """Host microseconds per call: the time to issue ``reps`` calls,
    without waiting for the card; the median of ``rounds`` rounds (the
    host's speed varies within a run)."""
    return _host_us_alternating({"fn": fn}, reps, rounds)["fn"]


def _host_us_alternating(fns: dict, reps: int, rounds: int = 5) -> dict:
    """:func:`_host_us` of each function, their rounds taken in turn so
    that all of them meet the same host."""
    import torch

    per_round = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            per_round[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return {name: sorted(times)[rounds // 2] for name, times in per_round.items()}


# -- phase 2 -----------------------------------------------------------------


def _inputs(capacity: int, dtype, n: int, gen, nan_share: float = 0.0):
    """Random rows for every source: slots over the whole table (the
    scratch slot included), an id->slot table that sends some ids to
    scratch, and values with both signs (a share of them NaN)."""
    import torch

    dev = DEV
    n_map = min(capacity, 30000)
    ext_to_slot = torch.randint(
        0, capacity, (n_map,), generator=gen, device=dev, dtype=torch.int32
    )
    ext_to_slot[-1] = capacity - 1
    slots = torch.randint(0, capacity, (n,), generator=gen, device=dev, dtype=torch.int32)
    ext = torch.randint(0, n_map, (n,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randint(-999, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    packed = torch.stack([ext, q]).to(torch.int16).contiguous()
    if dtype == torch.float32:
        vals = torch.randn(n, generator=gen, device=dev) * 50.0
        if nan_share:
            nan = torch.rand(n, generator=gen, device=dev) < nan_share
            vals[nan] = float("nan")
    else:
        vals = torch.randint(-1000, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    return {
        "slots": slots,
        "ext16": ext.to(torch.int16),
        "ext32": ext,
        "packed": packed,
        "vals": vals,
        "ext_to_slot": ext_to_slot,
    }


#: The one-slot case's packed scale: with values ``k * 0.5`` for
#: ``|k| <= 6`` every float32 sum of 2·2^20 rows is exact in any order
#: (see ``_one_slot``).
EXACT_SCALE = 0.5


def _one_slot(inp: dict, slot: int, gen, span: int = 6, rows=None) -> dict:
    """``rows`` rows (default: as many as ``inp`` has) that all fold
    into ``slot``, with values ``k * 0.5`` (int32: ``k``) and packed
    ``q = k`` for ``|k| <= span``.  The check folds them twice (once
    as the base state, once through the kernel), so every partial sum
    is a multiple of 0.5 of at most ``span * rows`` in magnitude; below
    2^23 each is exact in float32, in any order, and must match the
    plain version exactly."""
    import torch

    n = inp["slots"].shape[0] if rows is None else rows
    if span * n >= 1 << 23:
        msg = f"one-slot sums of 2·{n} rows with |k| <= {span} are not exact"
        raise ValueError(msg)
    k = torch.randint(-span, span + 1, (n,), generator=gen, device=DEV, dtype=torch.int32)
    out = dict(inp)
    out["slots"] = torch.full((n,), slot, device=DEV, dtype=torch.int32)
    out["ext_to_slot"] = inp["ext_to_slot"].clone()
    out["ext_to_slot"][:-1] = slot
    out["ext16"] = torch.zeros(n, device=DEV, dtype=torch.int16)
    out["ext32"] = torch.zeros(n, device=DEV, dtype=torch.int32)
    out["packed"] = torch.stack([torch.zeros_like(k), k]).to(torch.int16).contiguous()
    out["vals"] = k * 0.5 if inp["vals"].is_floating_point() else k
    return out


SOURCES = ("slot", "ext16", "ext32", "packed")


def _fold(seg, which: str, kind, state, inp, scale: float, plain: bool):
    """One fold through the kernel (``plain=False``) or the plain
    version, for row source ``which``."""
    if which == "slot":
        slots, vals = inp["slots"], inp["vals"]
    elif which in ("ext16", "ext32"):
        if not plain:
            return seg.update_fields_vocab(
                kind, state, inp["ext_to_slot"], inp[which], inp["vals"]
            )
        slots, vals = seg.slots_of(inp["ext_to_slot"], inp[which]), inp["vals"]
    else:
        if not plain:
            return seg.update_fields_packed(
                kind, state, inp["ext_to_slot"], inp["packed"], scale
            )
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0])
        vals = seg.dequantize(inp["packed"], scale)
    if plain:
        return seg.fold_plain(kind, state, slots, vals)
    return seg.update_fields(kind, state, slots, vals)


def _rows_of(seg, which, inp, scale, capacity, dtype):
    """The (slot, value) rows a source folds, as the plain version
    sees them, with the scratch rows masked out."""
    import torch

    if which == "slot":
        slots, vals = inp["slots"].long(), inp["vals"]
    elif which in ("ext16", "ext32"):
        slots, vals = seg.slots_of(inp["ext_to_slot"], inp[which]).long(), inp["vals"]
    else:
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0]).long()
        vals = seg.dequantize(inp["packed"], scale)
    vals = vals.to(dtype)
    valid = (slots >= 0) & (slots < capacity - 1)
    return slots[valid], vals[valid]


def _check_case(seg, card_worst: dict, which, inp, scale, capacity, dtype, tag, exact=False):
    """Fold ``inp`` through the kernel and the plain version for every
    kind and compare: NaN in the same slots, integer, count, min and
    max fields exactly, float32 sums within the two-order bound (or
    exactly, with ``exact``, for rows whose sums are exact)."""
    import torch

    slots, vals = _rows_of(seg, which, inp, scale, capacity, dtype)
    finite = vals == vals
    n_k = torch.zeros(capacity, dtype=torch.float64, device=DEV)
    n_k.index_add_(0, slots, torch.ones_like(slots, dtype=torch.float64))
    abs_k = torch.zeros(capacity, dtype=torch.float64, device=DEV)
    abs_k.index_add_(0, slots[finite], vals[finite].double().abs())
    checked = 0
    for kind_name, kind in seg.AGG_KINDS.items():
        base = seg.init_fields(kind, capacity, dtype, DEV)
        # Start from a table that already holds state: fold the slot
        # rows once with the plain version.
        seg.fold_plain(kind, base, inp["slots"], inp["vals"])
        got = {k: v.clone() for k, v in base.items()}
        want = {k: v.clone() for k, v in base.items()}
        _fold(seg, which, kind, got, inp, scale, plain=False)
        _fold(seg, which, kind, want, inp, scale, plain=True)
        torch.cuda.synchronize()
        for name, (_init, op_name) in kind.fields.items():
            g, w = got[name], want[name]
            where = f"{tag}/{kind_name}/{name}/{which}/{dtype}/cap{capacity}"
            if dtype == torch.float32:
                nan = torch.isnan(w)
                if not torch.equal(torch.isnan(g), nan):
                    msg = f"kernel and plain hold NaN in other slots: {where}"
                    raise AssertionError(msg)
                card_worst["nan_slots"] += int(nan.sum())
                keep = ~nan
            else:
                keep = torch.ones_like(g, dtype=torch.bool)
            if op_name != "add" or name == "count" or dtype == torch.int32 or exact:
                if not torch.equal(g[keep], w[keep]):
                    bad = int((g[keep] != w[keep]).sum())
                    msg = f"kernel != plain at {bad} slots: {where}"
                    raise AssertionError(msg)
                continue
            # Two summation orders of n_k terms (plus the state's own
            # value) differ by at most 2·n·2^-24·Σ|x| per slot.
            base_abs = base[name].double().abs()
            bound = (2.0 * (n_k + 1) * 2.0**-24 * (abs_k + base_abs))[keep]
            diff = (g.double() - w.double()).abs()[keep]
            card_worst["abs"] = max(card_worst["abs"], float(diff.max()))
            if bool((diff > bound).any()):
                msg = f"float sum outside the two-order bound: {where}"
                raise AssertionError(msg)
            nz = bound > 0
            if bool(nz.any()):
                card_worst["ratio"] = max(
                    card_worst["ratio"], float((diff[nz] / bound[nz]).max())
                )
        checked += 1
    return checked


def phase_kernel(card: dict, n: int, window_rows: int) -> dict:
    import torch

    from bytewax_tpu_torch.ops import fold_kernel
    from bytewax_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    scale = 0.1
    worst = {"abs": 0.0, "ratio": 0.0, "nan_slots": 0}
    checked = {}
    for capacity in (1024, 16384):
        for dtype in (torch.float32, torch.int32):
            inp = _inputs(capacity, dtype, n, gen)
            for which in SOURCES:
                checked["random"] = checked.get("random", 0) + _check_case(
                    seg, worst, which, inp, scale, capacity, dtype, "random"
                )
            # Every row on one slot: the worst case for the shared
            # table's atomics.  Its sums are exact, so they must match.
            hot = _one_slot(inp, 5, gen)
            for which in SOURCES:
                checked["one_slot"] = checked.get("one_slot", 0) + _check_case(
                    seg, worst, which, hot, EXACT_SCALE, capacity, dtype, "one_slot", exact=True
                )
        # NaN rows (float32 only; packed rows cannot carry NaN).
        inp = _inputs(capacity, torch.float32, n, gen, nan_share=1e-4)
        for which in ("slot", "ext16", "ext32"):
            checked["nan"] = checked.get("nan", 0) + _check_case(
                seg, worst, which, inp, scale, capacity, torch.float32, "nan"
            )
    if worst["nan_slots"] == 0:
        msg = "the NaN cases left no NaN in any field"
        raise AssertionError(msg)
    # The windowed folds' (slot, value) rows: a sliding-window batch
    # (10·2^20 expanded rows) into the tumbling and sliding tables.
    for capacity in (32768, 131072):
        for dtype in (torch.float32, torch.int32):
            inp = _inputs(capacity, dtype, window_rows, gen)
            checked["window_slot"] = checked.get("window_slot", 0) + _check_case(
                seg, worst, "slot", inp, scale, capacity, dtype, "window_slot"
            )
            hot = _one_slot(inp, capacity // 2, gen, span=1, rows=1 << 22)
            checked["window_one_slot"] = checked.get("window_one_slot", 0) + _check_case(
                seg, worst, "slot", hot, EXACT_SCALE, capacity, dtype, "window_one_slot",
                exact=True,
            )
    _emit(
        card,
        "kernel",
        checked_cases=checked,
        rows=n,
        window_rows=window_rows,
        max_abs_err=worst["abs"],
        max_sum_err_over_bound=worst["ratio"],
        nan_slots_matched=worst["nan_slots"],
        launches_while_checking=fold_kernel.launches,
    )
    return {"max_abs_err": worst["abs"], "max_sum_err_over_bound": worst["ratio"]}


def _packed_fold(kind, state, n: int, n_keys: int, gen):
    """A 1BRC batch for the fold: ``n`` packed int16 rows of ``n_keys``
    stations through an id->slot table (the last id to scratch).
    Returns the wrapper's call and its inputs."""
    import torch

    from bytewax_tpu_torch.ops import fold_kernel

    scale = 0.1
    capacity = state[next(iter(state))].shape[0]
    ext_to_slot = torch.arange(n_keys + 1, dtype=torch.int32, device=DEV)
    ext_to_slot[-1] = capacity - 1
    ids = torch.randint(0, n_keys, (n,), generator=gen, device=DEV, dtype=torch.int32)
    q = torch.randint(-999, 1000, (n,), generator=gen, device=DEV, dtype=torch.int32)
    packed = torch.stack([ids, q]).to(torch.int16).contiguous()

    def kernel():
        fold_kernel.fold(
            kind, state, fold_kernel.SRC_PACKED, packed, None, ext_to_slot=ext_to_slot, scale=scale
        )

    return kernel, ext_to_slot, packed, scale


def _time_main_shapes(
    card: dict, n: int, capacity: int, n_keys: int, source: str = "packed"
) -> dict:
    """Kernel, plain version and library call at a main path's shapes:
    stats, float32, one batch of ``n`` rows.

    ``source="packed"`` is the 1BRC batch: packed int16 rows of
    ``n_keys`` stations through the id->slot table.  ``source="slot"``
    is a windowed fold's batch: (slot, value) rows over ``n_keys``
    live slots of the table.

    ``ms`` is the kernel's device time per launch (the profiler's, or
    a replayed CUDA graph's where the profiler shows none); ``host_us``
    is the wrapper's host time per call."""
    import torch

    from bytewax_tpu_torch.ops import fold_kernel
    from bytewax_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    kind = seg.AGG_KINDS["stats"]
    n_fields = len(kind.fields)
    state = seg.init_fields(kind, capacity, torch.float32, DEV)
    reps = 50
    if source == "packed":
        kernel, ext_to_slot, packed, scale = _packed_fold(kind, state, n, n_keys, gen)
        n_map = ext_to_slot.shape[0]

        def entry():
            seg.update_fields_packed(kind, state, ext_to_slot, packed, scale)

        def plain():
            seg.fold_plain(
                kind,
                state,
                seg.slots_of(ext_to_slot, packed[0]),
                seg.dequantize(packed, scale),
            )

        slots = seg.slots_of(ext_to_slot, packed[0]).long()
        vals = seg.dequantize(packed, scale)
        bytes_moved = 4 * n + 4 * n_map + 2 * 4 * n_fields * capacity
        ops = (1 + n_fields) * n  # one dequant multiply, one combine per field
    else:
        slot_rows = torch.randint(0, n_keys, (n,), generator=gen, device=DEV, dtype=torch.int32)
        vals = torch.randn(n, generator=gen, device=DEV) * 10.0 + 12.0

        def kernel():
            fold_kernel.fold(kind, state, fold_kernel.SRC_SLOT, slot_rows, vals)

        def entry():
            seg.update_fields(kind, state, slot_rows, vals)

        def plain():
            seg.fold_plain(kind, state, slot_rows, vals)

        slots = slot_rows.long()
        bytes_moved = 8 * n + 2 * 4 * n_fields * capacity
        ops = n_fields * n  # one combine per field

    profiled_ms = _profiled(kernel, reps)["ms"]
    graph_ms = _graph_ms(kernel)
    ms = profiled_ms if profiled_ms is not None else graph_ms
    host_us = _host_us(kernel, 200)
    events_ms = _time_ms(entry, reps)
    plain_ms = _time_ms(plain, reps)
    # Yardstick only (the port never calls it on the card):
    # scatter_reduce_ per field over the already gathered (and
    # dequantized) rows.
    ones = torch.ones_like(vals)
    reduce_of = {"min": "amin", "max": "amax", "sum": "sum", "count": "sum"}

    def library():
        for name, arr in state.items():
            src = ones if name == "count" else vals
            arr.scatter_reduce_(0, slots, src, reduce_of[name], include_self=True)

    library_ms = _time_ms(library, reps)
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    res = {
        "ms": ms,
        "ms_from": "profiler" if profiled_ms is not None else "cuda_graph",
        "graph_ms": graph_ms,
        "host_us": host_us,
        "events_ms": events_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes"
        if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations",
    }
    _emit(
        card,
        "kernel_time",
        source=source,
        rows=n,
        capacity=capacity,
        keys=n_keys,
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        **res,
    )
    return res


# -- shared by the phases that drive flows (3 to 6) ------------------------


def _require_launches(launches: int, what: str) -> None:
    if launches <= 0:
        msg = f"{what}: the segment-fold kernel was launched no time"
        raise AssertionError(msg)


class _Timed:
    """Wrap a state method to count its calls and the seconds spent in
    it (the wrapper's own cost included)."""

    def __init__(self, obj, name: str):
        self.calls = 0
        self.seconds = 0.0
        inner = getattr(obj, name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(obj, name, wrapped)


def _recording_states(timed=()):
    """Patch ``make_agg_state`` to record every device state a run
    builds, with a :class:`_Timed` for each method named in ``timed``;
    returns the states, their timers and the undo function."""
    import bytewax_tpu_torch.engine.sharded_state as sharded_state

    states, timers = [], []
    make = sharded_state.make_agg_state

    def recording_make(kind, driver=None):
        state = make(kind, driver=driver)
        states.append(state)
        timers.append({name: _Timed(state, name) for name in timed})
        return state

    sharded_state.make_agg_state = recording_make

    def undo():
        sharded_state.make_agg_state = make

    return states, timers, undo


def _run_flow(flow, entry=None, expect=(), **kwargs) -> dict:
    """``run_main`` (or ``entry``) with every kernel count set to 0
    just before it; returns wall seconds, each kernel's launches
    (``launches`` for the segment fold, ``scan_launches`` for the
    segmented scan, ``bucket_launches`` for the shard bucketing) and the
    engine's phase seconds.  An exception of a
    type in ``expect`` ends the run; its type's name is ``raised``."""
    import torch

    from bytewax_tpu_torch.engine import flight
    from bytewax_tpu_torch.ops import bucket_kernel, fold_kernel, merge_kernel, scan_kernel
    from bytewax_tpu_torch.testing import run_main

    phases_before = dict(flight.RECORDER.phase_totals)
    counters_before = dict(flight.RECORDER.counters)
    torch.cuda.synchronize()
    fold_kernel.launches = 0
    scan_kernel.launches = 0
    bucket_kernel.launches = 0
    merge_kernel.launches = 0
    raised = status = None
    t0 = time.perf_counter()
    try:
        status = (entry or run_main)(flow, **kwargs)
    except expect as ex:
        raised = type(ex).__name__
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {
        "raised": raised,
        "status": status,
        "seconds": seconds,
        "launches": fold_kernel.launches,
        "scan_launches": scan_kernel.launches,
        "bucket_launches": bucket_kernel.launches,
        "phase_seconds": {
            name: total - phases_before.get(name, 0.0)
            for name, total in flight.RECORDER.phase_totals.items()
        },
        "counters": {
            name: value - counters_before.get(name, 0)
            for name, value in flight.RECORDER.counters.items()
            if value != counters_before.get(name, 0)
        },
    }


def _check_mean(got: float, want: float, scale: float, where: str) -> float:
    """A float32 mean against the float64 oracle's, relative to the
    mean absolute value of the rows (the scale of a float32 sum's
    error; the mean itself where the values share one sign).  Rows
    that are all 0 must give exactly 0."""
    err = abs(got - want) / scale if scale else (0.0 if got == want else float("inf"))
    if not err <= MEAN_RTOL:
        msg = f"{where}: mean {got} vs {want} (error {err} of the mean |value|)"
        raise AssertionError(msg)
    return err


# -- phase 3 -----------------------------------------------------------------


def _reference(batches, n_stations: int):
    """Per-station min/max/sum/count in exact integer deci-degrees,
    from the same batches."""
    import numpy as np

    span = 1999  # deci-degrees -999..999
    hist = np.zeros(n_stations * span, dtype=np.int64)
    total = np.zeros(n_stations, dtype=np.int64)
    for b in batches:
        ids = b.numpy("key_id").astype(np.int64)
        q = b.numpy("value").astype(np.int64)
        hist += np.bincount(ids * span + (q + 999), minlength=hist.size)
        total += np.bincount(ids, weights=q, minlength=n_stations).astype(np.int64)
    hist = hist.reshape(n_stations, span)
    count = hist.sum(axis=1)
    seen = hist > 0
    mn = seen.argmax(axis=1) - 999
    mx = span - 1 - seen[:, ::-1].argmax(axis=1) - 999
    vocab = batches[0].key_vocab
    return {
        str(vocab[i]): (mn[i] * 0.1, total[i] * 0.1 / count[i], mx[i] * 0.1)
        for i in range(n_stations)
        if count[i]
    }


def _check_brc(out, want: dict, where: str) -> float:
    """1BRC output against :func:`_reference`: every station once,
    min and max exact after rounding, the rounded mean within 0.1;
    returns the worst mean error."""
    got = dict(out)
    if len(got) != len(out) or set(got) != set(want):
        msg = f"{where}: {len(out)} rows of {len(got)} stations out, {len(want)} expected"
        raise AssertionError(msg)
    worst_mean = 0.0
    for station, (mn, mean, mx) in want.items():
        gmn, gmean, gmx = got[station]
        if gmn != round(mn, 1) or gmx != round(mx, 1):
            msg = f"{where}, {station}: min/max {gmn}/{gmx} != {round(mn, 1)}/{round(mx, 1)}"
            raise AssertionError(msg)
        worst_mean = max(worst_mean, abs(gmean - mean))
    if worst_mean > 0.1:
        msg = f"{where}: rounded mean off by {worst_mean}"
        raise AssertionError(msg)
    return worst_mean


def _check_same_brc(out, other, where: str) -> None:
    """Two 1BRC outputs of the same rows: the same stations, min and
    max, and rounded means at most one rounding step apart (float32
    sums on the card depend on the order the rows fold in)."""
    got, want = dict(out), dict(other)
    if set(got) != set(want):
        msg = f"{where}: {len(got)} stations, {len(want)} in the run with no store"
        raise AssertionError(msg)
    for station, (mn, mean, mx) in want.items():
        gmn, gmean, gmx = got[station]
        if (gmn, gmx) != (mn, mx) or abs(gmean - mean) > 0.1 + 1e-6:
            msg = f"{where}, {station}: {got[station]} against {want[station]} with no store"
            raise AssertionError(msg)


def _demotions() -> float:
    from bytewax_tpu_torch._metrics import step_demotion_count

    return sum(
        s.value
        for m in step_demotion_count.collect()
        for s in m.samples
        if s.name.endswith("_total")
    )


def phase_main(card: dict, rows: int, batch_rows: int, n_stations: int, times: dict):
    from bytewax_tpu_torch.models.brc import (
        ArrayBatchSource,
        brc_flow_columnar,
        generate_batches,
    )
    from bytewax_tpu_torch.testing import TestingSink

    batches = generate_batches(rows, batch_rows, n_stations, seed=0)
    want = _reference(batches, n_stations)
    out = []
    demoted_before = _demotions()
    flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
    states, _timers, undo = _recording_states()
    try:
        run = _run_flow(flow)
    finally:
        undo()
    seconds, launches = run["seconds"], run["launches"]
    worst_mean = _check_brc(out, want, "brc_flow_columnar")
    if launches < len(batches):
        msg = f"{launches} kernel launches for {len(batches)} batches"
        raise AssertionError(msg)
    demoted = _demotions() - demoted_before
    if demoted:
        msg = f"{demoted} steps demoted to the host tier"
        raise AssertionError(msg)
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    _emit(
        card,
        "main",
        flow="brc_flow_columnar",
        rows=rows,
        batch_rows=batch_rows,
        stations=n_stations,
        table_capacity=states[0].capacity,
        seconds=seconds,
        rows_per_s=rows / seconds,
        kernel_launches=launches,
        kernel_ms_per_launch=times["ms"],
        kernel_host_us_per_call=times["host_us"],
        plain_ms=times["plain_ms"],
        library_ms=times["library_ms"],
        bound_ms=times["bound_ms"],
        max_abs_mean_err=worst_mean,
        step_demotions=demoted,
        phase_seconds=run["phase_seconds"],
        # Kernel time over wall time, from the two measured numbers
        # (host→device copies not included).
        kernel_busy_share=launches * times["ms"] * 1e-3 / seconds,
    )
    return launches


# -- phase 4 -----------------------------------------------------------------


def phase_items(card: dict, n: int) -> int:
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow
    from bytewax_tpu_torch.testing import TestingSink, TestingSource

    rng = np.random.RandomState(2)
    ids = rng.randint(0, 413, size=n)
    q = rng.randint(-999, 1000, size=n).astype(np.int16)
    vocab = np.array([f"station_{i:04d}" for i in range(413)])
    items = [(vocab[i], v * 0.1) for i, v in zip(ids.tolist(), q.tolist())]
    chunk = 1 << 16
    batches = [items[i : i + chunk] for i in range(0, n, chunk)]
    out = []
    f32_launches = _run_flow(brc_flow(ArrayBatchSource(batches), TestingSink(out)))["launches"]
    want = _reference(
        [ArrayBatch({"key_id": ids, "value": q}, key_vocab=vocab, value_scale=0.1)],
        len(vocab),
    )
    got = dict(out)
    if set(got) != set(want) or f32_launches == 0:
        msg = f"itemized brc: {len(got)} stations, {f32_launches} launches"
        raise AssertionError(msg)
    for station, (mn, mean, mx) in want.items():
        gmn, gmean, gmx = got[station]
        if (gmn, gmx) != (round(mn, 1), round(mx, 1)) or abs(gmean - mean) > 0.1:
            msg = f"itemized stats wrong for {station}: {got[station]}"
            raise AssertionError(msg)

    words = [f"w{i % 997}" for i in range(n // 4)]
    out = []
    flow = Dataflow("count")
    s = op.input("inp", flow, TestingSource(words, batch_size=4096))
    s = op.count_final("count", s, lambda w: w)
    op.output("out", s, TestingSink(out))
    i32_launches = _run_flow(flow)["launches"]
    want = {}
    for w in words:
        want[w] = want.get(w, 0) + 1
    if dict(out) != want or i32_launches == 0:
        msg = f"count_final wrong or not on the kernel ({i32_launches} launches)"
        raise AssertionError(msg)
    _emit(
        card,
        "items",
        brc_items=n,
        brc_launches=f32_launches,
        count_items=len(words),
        count_launches=i32_launches,
    )
    return f32_launches + i32_launches


# -- phase 5 -----------------------------------------------------------------


def _brc_text(path: str, n: int, n_stations: int, seed: int):
    """Write ``n`` lines ``station;temp`` (one decimal) and return the
    station ids and deci-degrees."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_stations, size=n)
    deci = np.clip(np.round(rng.randn(n) * 100 + 120), -999, 999).astype(np.int64)
    stations = np.array([f"station_{i:05d}" for i in range(n_stations)])
    temps = np.array([f"{q / 10:.1f}" for q in range(-999, 1000)])
    lines = np.char.add(np.char.add(stations[ids], ";"), temps[deci + 999])
    with open(path, "w") as f:
        f.write("\n".join(lines.tolist()))
        f.write("\n")
    return stations, ids, deci


def _stats_oracle(stations, ids, deci):
    """Per-station (min, mean, max, count) in float64 over the values
    the flow folds: float32 of the parsed decimal."""
    import numpy as np

    n_stations = len(stations)
    vals32 = (deci / 10.0).astype(np.float32).astype(np.float64)
    mins = np.full(n_stations, np.inf)
    maxs = np.full(n_stations, -np.inf)
    np.minimum.at(mins, ids, vals32)
    np.maximum.at(maxs, ids, vals32)
    sums = np.bincount(ids, weights=deci / 10.0, minlength=n_stations)
    abs_sums = np.bincount(ids, weights=np.abs(deci) / 10.0, minlength=n_stations)
    counts = np.bincount(ids, minlength=n_stations)
    return {
        str(stations[i]): (
            mins[i],
            sums[i] / counts[i],
            maxs[i],
            int(counts[i]),
            abs_sums[i] / counts[i],
        )
        for i in range(n_stations)
        if counts[i]
    }


def _ingest_brc(card: dict, path: str, want: dict, n: int, text_device: bool):
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.connectors.files import FileSource
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.ops import text
    from bytewax_tpu_torch.testing import TestingSink

    def parse(batch):
        cols = text.split_fields(batch.cols["line"], 2, ";")
        return ArrayBatch({"key": cols[0], "value": cols[1].astype(np.float64)})

    # Count the device gathers (the line split's padded gather runs
    # on the card with BYTEWAX_TPU_TEXT_DEVICE=1).
    gathers = [0]
    device_gather = text._gather_pad_device

    def counted(*args):
        gathers[0] += 1
        return device_gather(*args)

    out = []
    flow = Dataflow("ingest_brc")
    s = op.input("inp", flow, FileSource(path, columnar=True, chunk_bytes=4 << 20))
    s = op.flat_map_batch("parse", s, parse)
    s = xla.stats_final("stats", s)
    op.output("out", s, TestingSink(out))
    states, _timers, undo = _recording_states()
    text._gather_pad_device = counted
    if text_device:
        os.environ["BYTEWAX_TPU_TEXT_DEVICE"] = "1"
    try:
        run = _run_flow(flow)
    finally:
        os.environ.pop("BYTEWAX_TPU_TEXT_DEVICE", None)
        text._gather_pad_device = device_gather
        undo()
    _require_launches(run["launches"], "1BRC file ingest")
    if text_device != (gathers[0] > 0):
        msg = f"text_device={text_device} but {gathers[0]} device gathers ran"
        raise AssertionError(msg)
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    rows = run["counters"].get("ingest_rows_columnar", 0)
    if rows != n:
        msg = f"ingest_rows_columnar counted {rows} of {n} lines"
        raise AssertionError(msg)
    got = dict(out)
    if set(got) != set(want):
        msg = f"1BRC file: {len(got)} stations out, {len(want)} expected"
        raise AssertionError(msg)
    worst = 0.0
    for station, (mn, mean, mx, count, mean_abs) in want.items():
        gmn, gmean, gmx, gcount = got[station]
        if (gmn, gmx, gcount) != (mn, mx, count):
            msg = f"{station}: {got[station]} != {want[station]}"
            raise AssertionError(msg)
        worst = max(worst, _check_mean(gmean, mean, mean_abs, station))
    _emit(
        card,
        "ingest",
        flow="FileSource(columnar) -> split_fields -> stats_final",
        text_device=text_device,
        device_gathers=gathers[0],
        lines=n,
        stations=len(want),
        table_capacity=states[0].capacity,
        seconds=run["seconds"],
        rows_per_s=n / run["seconds"],
        kernel_launches=run["launches"],
        ingest_rows_columnar=rows,
        max_mean_rel_err=worst,
        h2d_bytes=run["counters"].get("device_transfer_bytes_h2d", 0),
        phase_seconds=run["phase_seconds"],
    )
    return run["launches"]


def _ingest_wordcount(card: dict, path: str, n_lines: int, seed: int):
    import itertools
    import string

    import numpy as np

    from bytewax_tpu_torch.connectors.files import FileSource
    from bytewax_tpu_torch.models.wordcount import wordcount_flow
    from bytewax_tpu_torch.testing import TestingSink

    rng = np.random.RandomState(seed)
    # Letter-only words (the tokenizer splits on digits).
    vocab = np.array(
        [
            "w" + "".join(c)
            for c in itertools.islice(
                itertools.product(string.ascii_lowercase, repeat=3), WORDCOUNT_VOCAB
            )
        ]
    )
    idx = rng.randint(0, WORDCOUNT_VOCAB, size=(n_lines, WORDS_PER_LINE))
    words = vocab[idx]
    lines = words[:, 0]
    for j in range(1, WORDS_PER_LINE):
        lines = np.char.add(np.char.add(lines, " "), words[:, j])
    with open(path, "w") as f:
        f.write("\n".join(lines.tolist()))
        f.write("\n")
    counts = np.bincount(idx.ravel(), minlength=WORDCOUNT_VOCAB)
    want = {str(vocab[i]): int(counts[i]) for i in range(WORDCOUNT_VOCAB) if counts[i]}

    out = []
    flow = wordcount_flow(FileSource(path, columnar=True, chunk_bytes=4 << 20), TestingSink(out))
    states, _timers, undo = _recording_states()
    try:
        run = _run_flow(flow)
    finally:
        undo()
    _require_launches(run["launches"], "wordcount")
    rows = run["counters"].get("ingest_rows_columnar", 0)
    if rows != n_lines:
        msg = f"ingest_rows_columnar counted {rows} of {n_lines} lines"
        raise AssertionError(msg)
    if dict(out) != want:
        msg = f"wordcount differs from the oracle ({len(out)} words out)"
        raise AssertionError(msg)
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    n_words = n_lines * WORDS_PER_LINE
    _emit(
        card,
        "ingest",
        flow="wordcount_flow(FileSource(columnar))",
        lines=n_lines,
        words=n_words,
        vocab=len(want),
        table_capacity=states[0].capacity,
        seconds=run["seconds"],
        rows_per_s=n_lines / run["seconds"],
        words_per_s=n_words / run["seconds"],
        kernel_launches=run["launches"],
        ingest_rows_columnar=rows,
        phase_seconds=run["phase_seconds"],
    )
    return run["launches"]


def phase_ingest(card: dict, n_lines: int, n_stations: int, wc_lines: int) -> int:
    """1BRC text and wordcount read from files; returns the kernel
    launches of the three runs."""
    import tempfile

    launches = 0
    with tempfile.TemporaryDirectory(prefix="bytewax_chip_smoke_") as tmp:
        path = os.path.join(tmp, "measurements.txt")
        stations, ids, deci = _brc_text(path, n_lines, n_stations, seed=5)
        want = _stats_oracle(stations, ids, deci)
        for text_device in (False, True):
            launches += _ingest_brc(card, path, want, n_lines, text_device)
        launches += _ingest_wordcount(card, os.path.join(tmp, "words.txt"), wc_lines, seed=6)
    return launches


# -- phase 6 -----------------------------------------------------------------

#: Event time of the first reading (µs since the epoch); windows align
#: to it.
_T0_US = 1_767_225_600_000_000  # 2026-01-01T00:00:00Z
_MINUTE_US = 60_000_000


def _window_data(name: str, n_batches: int, n: int, n_keys: int, seed: int):
    """Per-batch station ids and event times (µs): one event-minute
    per batch, rising within it; ``LATE_SHARE`` of the rows pushed
    back five minutes.  For sessions every station goes quiet for
    2–5 event-minutes, starting at a seeded point (rows are drawn
    among the stations awake at their time)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    offs = (np.arange(n, dtype=np.int64) * _MINUTE_US) // n
    if name == "session":
        quiet_lo = (rng.uniform(-2, 3, size=n_keys) * _MINUTE_US).astype(np.int64)
        quiet_hi = quiet_lo + (rng.uniform(2, 5, size=n_keys) * _MINUTE_US).astype(np.int64)
    ids_all, ts_all, deci_all = [], [], []
    for b in range(n_batches):
        ts = _T0_US + b * _MINUTE_US + offs
        ids = rng.randint(0, n_keys, size=n).astype(np.int32)
        if name == "session":
            rel = ts - _T0_US
            asleep = (quiet_lo[ids] <= rel) & (rel < quiet_hi[ids])
            while asleep.any():
                ids[asleep] = rng.randint(0, n_keys, size=int(asleep.sum()))
                asleep = (quiet_lo[ids] <= rel) & (rel < quiet_hi[ids])
        late = rng.rand(n) < LATE_SHARE
        ts = ts.copy()
        ts[late] -= 5 * _MINUTE_US
        deci = np.clip(np.round(rng.randn(n) * 100 + 120), -999, 999).astype(np.int16)
        ids_all.append(ids)
        ts_all.append(ts)
        deci_all.append(deci)
    return ids_all, ts_all, deci_all


def _late_oracle(ids, ts, wait_us: int):
    """Per row, whether it is late: its timestamp lies below its
    station's running maximum of ``ts - wait`` over the station's
    earlier rows (a plain loop per station, in arrival order)."""
    import numpy as np

    # A stable sort of int16 ids is a radix sort.
    order = np.argsort(ids.astype(np.int16) if ids.max() < 1 << 15 else ids, kind="stable")
    k_sorted = ids[order]
    t_sorted = ts[order]
    starts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
    ends = np.r_[starts[1:], len(order)]
    late_sorted = np.zeros(len(order), dtype=bool)
    for lo, hi in zip(starts.tolist(), ends.tolist()):
        seg = t_sorted[lo:hi]
        prev = np.maximum.accumulate(seg - wait_us)
        late_sorted[lo + 1 : hi] = seg[1:] < prev[:-1]
    late = np.empty_like(late_sorted)
    late[order] = late_sorted
    return late


def _minute_partials(ids, ts, vals, n_keys: int):
    """Dense per-(station, event-minute) count/sum/|sum|/min/max of
    the on-time rows; returns the first minute and the five arrays."""
    import numpy as np

    minute = (ts - _T0_US) // _MINUTE_US
    m0 = int(minute.min())
    n_min = int(minute.max()) - m0 + 1
    cell = ids.astype(np.int64) * n_min + (minute - m0)
    size = n_keys * n_min
    count = np.bincount(cell, minlength=size).reshape(n_keys, n_min)
    total = np.bincount(cell, weights=vals, minlength=size).reshape(n_keys, n_min)
    abs_total = np.bincount(cell, weights=np.abs(vals), minlength=size).reshape(n_keys, n_min)
    mn = np.full(size, np.inf)
    mx = np.full(size, -np.inf)
    np.minimum.at(mn, cell, vals)
    np.maximum.at(mx, cell, vals)
    return m0, count, total, abs_total, mn.reshape(n_keys, n_min), mx.reshape(n_keys, n_min)


def _sessions(ids, ts, vals):
    """``{(station id, open µs, close µs): (count, sum, sum of |value|)}``
    of 60 s sessions over the rows (a gap above a minute opens a new
    one)."""
    import numpy as np

    order = np.lexsort((ts, ids))
    k, t, v = ids[order], ts[order], vals[order]
    new = np.r_[True, (k[1:] != k[:-1]) | ((t[1:] - t[:-1]) > _MINUTE_US)]
    starts = np.flatnonzero(new)
    ends = np.r_[starts[1:], len(t)] - 1
    sums = np.add.reduceat(v, starts) if len(v) else v
    abs_sums = np.add.reduceat(np.abs(v), starts) if len(v) else v
    return {
        (key, lo, hi): (c, total, abs_total)
        for key, lo, hi, c, total, abs_total in zip(
            k[starts].tolist(),
            t[starts].tolist(),
            t[ends].tolist(),
            (ends - starts + 1).tolist(),
            sums.tolist(),
            abs_sums.tolist(),
        )
    }


def _window_oracle(name, ids, ts, vals, n_keys: int):
    """``{(station id, window id): (min, mean, max, count, mean
    |value|)}`` of the on-time rows (tumbling: the minute; sliding: minutes ``wid`` to
    ``wid + 9``), or for sessions ``[(station id, open µs, close µs,
    count)]``."""
    import numpy as np

    if name == "session":
        cells = _sessions(ids, ts, vals)
        return sorted((key, lo, hi, c) for (key, lo, hi), (c, _s, _a) in cells.items())
    m0, count, total, abs_total, mn, mx = _minute_partials(ids, ts, vals, n_keys)
    span = 1 if name == "tumbling" else 10
    n_min = count.shape[1]
    out = {}
    for wid_rel in range(-(span - 1), n_min):
        lo, hi = max(wid_rel, 0), min(wid_rel + span, n_min)
        c = count[:, lo:hi].sum(axis=1)
        s = total[:, lo:hi].sum(axis=1)
        s_abs = abs_total[:, lo:hi].sum(axis=1)
        a = mn[:, lo:hi].min(axis=1)
        b = mx[:, lo:hi].max(axis=1)
        for key in np.flatnonzero(c).tolist():
            out[(key, wid_rel + m0)] = (
                a[key],
                s[key] / c[key],
                b[key],
                int(c[key]),
                s_abs[key] / c[key],
            )
    return out


def _timed_source(batches):
    """A source handing ``batches`` out in turn on worker 0; returns
    it and the list of wall times at which it handed out each batch."""
    from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition

    emitted = []

    class _Part(StatelessSourcePartition):
        def __init__(self, mine: bool):
            self._i = 0 if mine else len(batches)

        def next_batch(self):
            if self._i >= len(batches):
                raise StopIteration()
            batch = batches[self._i]
            self._i += 1
            emitted.append(time.perf_counter())
            return batch

    class _Source(DynamicSource):
        def build(self, step_id, worker_index, worker_count):
            return _Part(worker_index == 0)

    return _Source(), emitted


def _timed_sink():
    """A sink keeping ``(wall time, item)`` for each item it takes;
    returns it and that list."""
    from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition

    rows = []

    class _Part(StatelessSinkPartition):
        def write_batch(self, items):
            now = time.perf_counter()
            rows.extend((now, it) for it in items)

    class _Sink(DynamicSink):
        def build(self, step_id, worker_index, worker_count):
            return _Part()

    return _Sink(), rows


def _close_latencies(name, metas, ids_b, ts_b, emitted, n_keys: int, align) -> list:
    """Sorted window-close latencies (s) of a windowed run: a close is
    due once its station's watermark (max event time - wait) passes
    the window's end (sessions: the end plus the 60 s gap).  The batch
    that first carries the station there triggered it; a latency runs
    from the source handing that batch out to the close's metadata
    event at the sink.  Closes due only at EOF, and those triggered by
    the first batch (allocator and kernel warm-up), are left out."""
    from datetime import timedelta

    import numpy as np

    n_batches = len(ids_b)
    keymax = np.full((n_batches, n_keys), np.iinfo(np.int64).min, dtype=np.int64)
    for b, (i_b, t_b) in enumerate(zip(ids_b, ts_b)):
        np.maximum.at(keymax[b], i_b, t_b)
    keymax = np.maximum.accumulate(keymax, axis=0) - WINDOW_WAIT_S * 1_000_000
    lats = []
    for wall, (k, (_wid, meta)) in metas:
        col = keymax[:, int(k[8:])]
        due = (meta.close_time - align) // timedelta(microseconds=1) + _T0_US
        if name == "session":
            b = int(np.searchsorted(col, due + _MINUTE_US, side="right"))
        else:
            b = int(np.searchsorted(col, due, side="left"))
        if 1 <= b < n_batches:
            lats.append(wall - emitted[b])
    return sorted(lats)


def _window_case(card: dict, name: str, n_batches: int, n: int, n_keys: int, seed: int,
                 phase: str = "windows") -> dict:
    """One windowed flow through ``run_main``, checked against its
    oracle; emits a ``phase`` line and returns the run (``_run_flow``'s
    record) with the state, the output ``got`` and the oracle ``want``."""
    from datetime import datetime, timedelta, timezone

    import numpy as np

    import bytewax_tpu_torch.operators as op
    import bytewax_tpu_torch.operators.windowing as win
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.testing import TestingSink
    from bytewax_tpu_torch.xla import column_ts

    ids_b, ts_b, deci_b = _window_data(name, n_batches, n, n_keys, seed)
    vocab = np.array([f"station_{i:05d}" for i in range(n_keys)])
    batches = [
        ArrayBatch({"key_id": i, "ts": t, "value": d}, key_vocab=vocab, value_scale=0.1)
        for i, t, d in zip(ids_b, ts_b, deci_b)
    ]
    source, emitted = _timed_source(batches)
    meta_sink, metas = _timed_sink()

    align = datetime.fromtimestamp(_T0_US / 1e6, tz=timezone.utc)
    wait = timedelta(seconds=WINDOW_WAIT_S)
    clock = win.EventClock(ts_getter=column_ts, wait_for_system_duration=wait)
    flow = Dataflow(f"windows_{name}")
    s = op.input("inp", flow, source)
    if name == "tumbling":
        windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
        wo = win.stats_window("w", s, clock, windower)
    elif name == "sliding":
        windower = win.SlidingWindower(
            length=timedelta(minutes=10), offset=timedelta(minutes=1), align_to=align
        )
        wo = win.stats_window("w", s, clock, windower)
    else:
        windower = win.SessionWindower(gap=timedelta(seconds=60))
        wo = win.count_window("w", s, clock, windower, key=lambda x: x)
    down, late = [], []
    op.output("down", wo.down, TestingSink(down))
    op.output("late", wo.late, TestingSink(late))
    op.output("meta", wo.meta, meta_sink)

    states, timers, undo = _recording_states(timed=("alloc", "_fetch"))
    try:
        run = _run_flow(flow)
    finally:
        undo()
    _require_launches(run["launches"], f"{name} windows")
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"window state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)

    # -- the oracle -----------------------------------------------------------
    ids = np.concatenate(ids_b)
    ts = np.concatenate(ts_b)
    vals = (np.concatenate(deci_b) * 0.1).astype(np.float32).astype(np.float64)
    late_rows = _late_oracle(ids, ts, WINDOW_WAIT_S * 1_000_000)
    ok = ~late_rows
    want = _window_oracle(name, ids[ok], ts[ok], vals[ok], n_keys)
    expand = 10 if name == "sliding" else 1
    if len(late) != int(late_rows.sum()) * expand:
        msg = f"{name}: {len(late)} late events, oracle {int(late_rows.sum())} × {expand}"
        raise AssertionError(msg)

    def us(dt):
        return (dt - align) // timedelta(microseconds=1) + _T0_US

    worst = 0.0
    meta_of = {(k, wid): m for _wall, (k, (wid, m)) in metas}
    if len(meta_of) != len(down):
        msg = f"{name}: {len(down)} closes but {len(meta_of)} metadata events"
        raise AssertionError(msg)
    if name == "session":
        got = sorted(
            (
                int(k[8:]),
                us(meta_of[(k, wid)].open_time),
                us(meta_of[(k, wid)].close_time),
                count,
            )
            for k, (wid, count) in down
        )
        if got != want:
            msg = f"sessions differ: {len(got)} out, {len(want)} expected"
            raise AssertionError(msg)
        merged = sum(1 for _w, (_k, (_wid, m)) in metas if m.merged_ids)
    else:
        got = {}
        for k, (wid, value) in down:
            got[(int(k[8:]), wid)] = value
        if set(got) != set(want):
            msg = f"{name}: {len(got)} windows out, {len(want)} expected"
            raise AssertionError(msg)
        for kw, (mn, mean, mx, count, mean_abs) in want.items():
            gmn, gmean, gmx, gcount = got[kw]
            if (gmn, gmx, gcount) != (mn, mx, count):
                msg = f"{name} window {kw}: {got[kw]} != {want[kw]}"
                raise AssertionError(msg)
            worst = max(worst, _check_mean(gmean, mean, mean_abs, f"{name} window {kw}"))
        merged = 0

    lats = _close_latencies(name, metas, ids_b, ts_b, emitted, n_keys, align)
    p99 = lats[int(len(lats) * 0.99)] if lats else None
    alloc_t, fetch_t = timers[0]["alloc"], timers[0]["_fetch"]
    state = states[0]
    _emit(
        card,
        phase,
        case=name,
        rows=n * n_batches,
        batches=n_batches,
        stations=n_keys,
        windows_closed=len(down),
        sessions_merged=merged,
        late_rows=int(late_rows.sum()),
        late_events=len(late),
        table_capacity=state.capacity,
        seconds=run["seconds"],
        rows_per_s=n * n_batches / run["seconds"],
        kernel_launches=run["launches"],
        window_rows_folded=run["counters"].get("window_rows_ingested", 0),
        p99_close_latency_s=p99,
        closes_timed=len(lats),
        median_close_latency_s=lats[len(lats) // 2] if lats else None,
        max_mean_rel_err=worst,
        composite_allocs=alloc_t.calls,
        composite_alloc_seconds=alloc_t.seconds,
        close_readbacks=fetch_t.calls,
        close_readback_seconds=fetch_t.seconds,
        close_readback_bytes=4 * len(state.kind.fields) * state.capacity,
        h2d_bytes=run["counters"].get("device_transfer_bytes_h2d", 0),
        d2h_bytes=run["counters"].get("device_transfer_bytes_d2h", 0),
        phase_seconds=run["phase_seconds"],
    )
    return dict(run, state=state, got=got, want=want)


def phase_windows(card: dict, n: int, n_keys: int, cases) -> dict:
    """The three windowed cases; returns their kernel launches."""
    return {
        name: _window_case(card, name, n_batches, n, n_keys, seed=10 + i)["launches"]
        for i, (name, n_batches) in enumerate(cases)
    }


# -- phase 7 -----------------------------------------------------------------


def _scan_kinds():
    """Instance name -> a kind of that instance, as the flows build it."""
    from bytewax_tpu_torch.ops import scan as scan_ops

    return {
        "welford": scan_ops.WelfordZScore(THRESHOLD),
        "ema": scan_ops.Ema(EMA_ALPHA),
        "extrema": scan_ops.RunningExtrema(),
    }


def _scan_case(kind, n: int, n_keys: int, capacity: int, seed: int, resumed=False,
               nan_share=0.0, equal=False):
    """A table (fresh, or holding state consistent with its kind) and
    ``n`` grouped rows of ``n_keys`` keys on distinct slots."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    fields = {
        name: torch.full((capacity,), init, dtype=dtype, device=DEV)
        for name, (init, dtype) in kind.fields.items()
    }
    m = capacity - 1
    if resumed:
        def put(name, arr):
            fields[name][:m] = torch.from_numpy(np.asarray(arr)).to(DEV)

        count = rng.randint(0, 40, m).astype(np.int32)
        if kind.kernel == "welford":
            put("count", count)
            put("mean", (rng.randn(m) * 5 + 20).astype(np.float32))
            put("m2", (rng.rand(m) * 30 * np.maximum(count - 1, 0)).astype(np.float32))
        elif kind.kernel == "ema":
            put("count", count)
            put("s", ((rng.randn(m) * 5 + 20) * (1 - (1 - kind.alpha) ** count)).astype(np.float32))
        else:
            lo = rng.randn(m) * 5 + 20
            put("mn", lo.astype(np.float32))
            put("mx", (lo + rng.rand(m) * 10).astype(np.float32))
    keys = np.sort(rng.randint(0, n_keys, n))
    slot_of = rng.permutation(m)[:n_keys].astype(np.int32)
    vals = (keys % 7 * 1.5) if equal else (rng.randn(n) * 5 + 20)
    vals = vals.astype(np.float32)
    vals[rng.rand(n) < nan_share] = np.nan
    slots = torch.from_numpy(slot_of[keys]).to(DEV)
    return fields, slots, torch.from_numpy(vals).to(DEV), len(np.unique(keys))


def _scan_compare(kind, fields, slots, vals, tag: str, worst: dict) -> None:
    """The kernel (``kind.run`` on the card) against the plain version
    (``kind.plain``) from the same table: counts and extrema exactly,
    NaN in the same places; float32 states within 1e-5 relative, z
    within ``Z_RTOL`` of max(1, |z|), the EMA within 1e-4 relative."""
    import torch

    want = {k: v.clone() for k, v in fields.items()}
    got_outs, _ = kind.run(fields, slots, vals)
    want_outs, _ = kind.plain(want, slots, vals)
    torch.cuda.synchronize()
    _scan_check(kind, fields, got_outs, want, want_outs, tag, worst)


def _scan_check(kind, fields, got_outs, want, want_outs, tag: str, worst: dict) -> None:
    """The kernel's table and outputs against the plain version's, under
    :func:`_scan_compare`'s tolerances."""
    import torch

    real = slice(0, fields[next(iter(fields))].shape[0] - 1)  # scratch excluded

    def exact(g, w, what):
        nan = torch.isnan(w) if w.is_floating_point() else torch.zeros_like(w, dtype=torch.bool)
        if not torch.equal(torch.isnan(g) if g.is_floating_point() else nan, nan) or not torch.equal(
            g[~nan], w[~nan]
        ):
            msg = f"scan {tag}/{what}: kernel != plain"
            raise AssertionError(msg)
        worst["nan"] += int(nan.sum())

    def close(g, w, rtol, what):
        err = float(((g.double() - w.double()).abs() / w.double().abs().clamp(min=1.0)).max())
        worst[what] = max(worst.get(what, 0.0), err)
        if not err <= rtol:
            msg = f"scan {tag}/{what}: error {err} over {rtol}"
            raise AssertionError(msg)

    for name, (_init, dtype) in kind.fields.items():
        g, w = fields[name][real], want[name][real]
        if dtype == torch.int32 or kind.kernel == "extrema":
            exact(g, w, name)
        else:
            close(g, w, 1e-5, f"{kind.kernel}_{name}")
    for i, (g, w) in enumerate(zip(got_outs, want_outs)):
        if kind.kernel == "extrema":
            exact(g, w, f"out{i}")
        elif kind.kernel == "welford":
            close(g, w, Z_RTOL, "z")
        else:
            close(g, w, 1e-4, "ema")
    worst["cases"] += 1


def phase_scan(card: dict, n: int, n_keys: int) -> dict:
    """Phase 7: the kernel against its plain version, then its times."""
    import torch

    from bytewax_tpu_torch.ops import scan as scan_ops
    from bytewax_tpu_torch.ops import scan_kernel
    from bytewax_tpu_torch.ops import segment as seg

    worst = {"cases": 0, "nan": 0}
    kinds = _scan_kinds()
    kinds_more = dict(kinds, ema_alpha1=scan_ops.Ema(1.0), ema_tiny=scan_ops.Ema(1e-8))
    seed = 100
    for name, kind in kinds_more.items():
        for layout, keys, capacity in (
            ("10k_keys", n_keys, 16384),
            ("2^20_keys", n, 1 << 21),
            ("one_key", 1, 1024),
        ):
            for resumed in (False, True):
                seed += 1
                tag = f"{name}/{layout}/{'resumed' if resumed else 'fresh'}"
                case = _scan_case(kind, n, keys, capacity, seed=seed, resumed=resumed)
                _scan_compare(kind, *case[:3], tag, worst)
    fields, slots, vals, _ = _scan_case(kinds["extrema"], n, n_keys, 16384, seed=5, nan_share=1e-3)
    _scan_compare(kinds["extrema"], fields, slots, vals, "extrema/nan", worst)
    if worst["nan"] == 0:
        msg = "the NaN case left no NaN in the extrema"
        raise AssertionError(msg)
    kind = kinds["welford"]
    fields, slots, vals, _ = _scan_case(kind, n, n_keys, 16384, seed=6, equal=True)
    for _ in range(2):  # the second batch carries the first one's state in
        (z,), _ = kind.run(fields, slots, vals)
        torch.cuda.synchronize()
        if float(z.abs().max()) != 0.0 or float(fields["m2"].abs().max()) != 0.0:
            msg = "equal values left a non-zero z or m2"
            raise AssertionError(msg)
    worst["cases"] += 1
    # The single pass's edges: a ragged last tile, a call below one
    # tile, and more tiles than the card holds at once (one key, so
    # every tile's look-back walks back to a published prefix).
    for name, kind in kinds.items():
        for rows, keys, capacity in ((n + 37, n_keys, 16384), (5, 2, 1024)):
            seed += 1
            case = _scan_case(kind, rows, keys, capacity, seed=seed, resumed=True)
            _scan_compare(kind, *case[:3], f"{name}/{rows}_rows", worst)
    for name in ("welford", "extrema"):
        case = _scan_case(kinds[name], SCAN_DEEP_ROWS, 1, 1024, seed=7, resumed=True)
        _scan_compare(kinds[name], *case[:3], f"{name}/2^24_rows_one_key", worst)
    _scan_back_to_back(kinds_more, n, n_keys, worst)
    _emit(card, "scan", rows=n, keys=n_keys, checked_cases=worst.pop("cases"),
          nan_matched=worst.pop("nan"), max_rel_err=worst)

    # The fold wrapper on a 1BRC batch (2^20 rows, 10,000 stations),
    # whose host time each scan timing takes in turn with its own.
    fold_kind = seg.AGG_KINDS["stats"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    fold_state = seg.init_fields(fold_kind, 16384, torch.float32, DEV)
    fold_call = _packed_fold(fold_kind, fold_state, n, n_keys, gen)[0]
    times = {
        name: _time_scan(card, kind, n, n_keys, 16384, fold_call) for name, kind in kinds.items()
    }
    # The welford instance at the other shapes the main path gives it.
    times["welford_2^20_keys"] = _time_scan(card, kinds["welford"], n, n, 1 << 21, fold_call)
    times["welford_one_key"] = _time_scan(card, kinds["welford"], n, 1, 1024, fold_call)
    return {"max_rel_err": max(worst.values()), "times": times,
            "launches_while_checking": scan_kernel.launches}


def _scan_back_to_back(kinds: dict, n: int, n_keys: int, worst: dict) -> None:
    """Calls of every instance and several sizes issued back to back on
    one stream, with no sync between them (the workspace's tile counter
    and status words carry over from call to call), each then held
    against its plain version from the table it started from."""
    import torch

    from bytewax_tpu_torch.ops import scan_kernel

    plan = [
        ("welford", n, n_keys, 16384),
        ("ema", 5, 2, 1024),
        ("extrema", n + 37, 1, 1024),
        ("ema_alpha1", n // 4, n // 4, 1 << 19),
        ("welford", 3000, 1, 1024),
        ("ema_tiny", n, n_keys, 16384),
        ("extrema", n, n_keys, 16384),
    ]
    calls = []
    for k, (name, rows, keys, capacity) in enumerate(plan):
        kind = kinds[name]
        fields, slots, vals, _ = _scan_case(kind, rows, keys, capacity, seed=300 + k, resumed=True)
        calls.append((name, kind, fields, {f: v.clone() for f, v in fields.items()}, slots, vals))
    torch.cuda.synchronize()
    before = scan_kernel.launches
    outs = [kind.run(fields, slots, vals)[0] for _n, kind, fields, _w, slots, vals in calls]
    if scan_kernel.launches != before + len(calls):
        msg = "back-to-back scan calls: not one launch a call"
        raise AssertionError(msg)
    torch.cuda.synchronize()
    for (name, kind, fields, want, slots, vals), got in zip(calls, outs):
        want_outs, _ = kind.plain(want, slots, vals)
        torch.cuda.synchronize()
        _scan_check(kind, fields, got, want, want_outs, f"{name}/back_to_back", worst)


#: State bytes per key, and float operations per row (two merges and
#: the emission), of each instance.
_SCAN_STATE_BYTES = {"welford": 12, "ema": 8, "extrema": 8}
_SCAN_OPS_PER_ROW = {"welford": 25, "ema": 14, "extrema": 6}


def _time_scan(card: dict, kind, n: int, n_keys: int, capacity: int, fold_call) -> dict:
    """One instance at a shape of the anomaly path (``n`` grouped rows
    of ``n_keys`` keys): device ms per call (one launch), the wrapper's
    host µs per call (``scan_kernel.scan``, its rounds taken in turn
    with the fold wrapper's ``fold_call``: ``fold_host_us``), the plain
    version's ms, and the bound.  No single PyTorch call computes a
    segmented scan, so there is no library time.

    ``ms`` is warm: the rows (8 MB) and outputs fit the card's 50 MB
    L2, so it can read under the bound.  ``cold_ms`` writes
    ``L2_FLUSH_BYTES`` before each call (outside the count): the time a
    batch that has just arrived from the host takes, the one compared
    with the bound."""
    import torch

    from bytewax_tpu_torch.ops import scan_kernel

    fields, slots, vals, segments = _scan_case(kind, n, n_keys, capacity, seed=8)

    def kernel():
        kind.run(fields, slots, vals)

    def wrapper():
        scan_kernel.scan(kind, fields, slots, vals)

    plain_fields = {k: v.clone() for k, v in fields.items()}

    def plain():
        kind.plain(plain_fields, slots, vals)

    warm = _profiled(kernel, 50, SCAN_KERNEL)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEV)
    cold = _profiled(kernel, 50, SCAN_KERNEL, between=lambda: flush.fill_(1.0))
    del flush
    if warm["host_launches_per_call"] > 1 or warm["host_memsets_per_call"] > 1:
        msg = f"scan {kind.kernel}: {warm}: more than one launch (and one memset) a call"
        raise AssertionError(msg)
    profiled_ms = warm["ms"]
    graph_ms = _graph_ms(kernel)
    ms = profiled_ms if profiled_ms is not None else graph_ms
    host = _host_us_alternating({"scan": wrapper, "fold": fold_call}, 200)
    n_out = 2 if kind.kernel == "extrema" else 1
    bytes_moved = 8 * n + 4 * n_out * n + 2 * segments * _SCAN_STATE_BYTES[kind.kernel]
    ops = _SCAN_OPS_PER_ROW[kind.kernel] * n
    res = {
        "ms": ms,
        "ms_from": "profiler" if profiled_ms is not None else "cuda_graph",
        "cold_ms": cold["ms"],
        "graph_ms": graph_ms,
        "launches_per_call": warm["host_launches_per_call"],
        "memsets_per_call": warm["host_memsets_per_call"],
        "traced_launches_per_call": warm["launches_per_call"],
        "host_us": host["scan"],
        "fold_host_us": host["fold"],
        "plain_ms": _time_ms(plain, 10),
        "library_ms": None,
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
    }
    _emit(card, "scan_time", instance=kind.kernel, rows=n, keys=n_keys, segments=segments,
          capacity=capacity,
          library="none: no single PyTorch call computes a segmented scan", **res)
    return res


# -- phase 8 -----------------------------------------------------------------


_ANOMALY_DATA = {}


def _anomaly_data(n_batches: int, n: int, n_keys: int, seed: int):
    """:func:`_make_anomaly_data`, made once for each set of arguments
    (phases 8, 10 and 11 read the same sensors)."""
    args = (n_batches, n, n_keys, seed)
    if args not in _ANOMALY_DATA:
        _ANOMALY_DATA[args] = _make_anomaly_data(*args)
    return _ANOMALY_DATA[args]


def _make_anomaly_data(n_batches: int, n: int, n_keys: int, seed: int, ids_b=None):
    """Sensor readings and their float64 oracle, made together.

    Each batch holds ``n`` rows of sensors drawn uniformly from
    ``n_keys`` (or the given per-batch sensor ids ``ids_b``, each below
    ``n_keys``).  A sensor's readings are one-decimal values around its
    own level and spread, with a rare outlier; each is generated in
    the sensor's order against the oracle's running Welford state, and
    redrawn while its oracle z lies within 1e-3 (relative) of the
    threshold, so that float32 z cannot flip a flag.  Returns per-batch
    ``(ids int32, values float32)`` and per-row oracle ``(z, flag)`` in
    input order, plus the per-(sensor, rank) value grid for the EMA and
    extrema oracles."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if ids_b is None:
        ids_b = [rng.randint(0, n_keys, n).astype(np.int32) for _ in range(n_batches)]
    ids = np.concatenate(ids_b)
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_keys)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(len(ids), dtype=np.int64)
    rank[order] = np.arange(len(ids)) - np.repeat(starts, counts)
    level = rng.uniform(-10.0, 30.0, n_keys)
    spread = rng.uniform(0.5, 5.0, n_keys)
    width = int(counts.max())
    grid = np.zeros((n_keys, width))
    z_grid = np.zeros((n_keys, width))
    count = np.zeros(n_keys, dtype=np.int64)
    mean = np.zeros(n_keys)
    m2 = np.zeros(n_keys)
    band = 1e-3 * max(1.0, THRESHOLD)
    for t in range(width):
        live = counts > t
        cand = np.zeros(n_keys)
        z = np.zeros(n_keys)
        todo = live.copy()
        for _attempt in range(20):
            if not todo.any():
                break
            draw = level + spread * rng.randn(n_keys)
            jump = rng.rand(n_keys) < 0.002
            draw[jump] += np.sign(rng.randn(jump.sum())) * 8 * spread[jump]
            v = np.round(draw, 1).astype(np.float32).astype(np.float64)
            cand = np.where(todo, v, cand)
            have = (count >= 2) & (m2 > 0)
            std = np.sqrt(np.where(have, m2, 1.0) / np.maximum(count - 1, 1))
            z = np.where(have, (cand - mean) / std, 0.0)
            todo = live & (np.abs(np.abs(z) - THRESHOLD) < band)
        if todo.any():
            msg = "could not keep every z away from the threshold"
            raise AssertionError(msg)
        grid[:, t] = cand
        z_grid[:, t] = z
        # The host mapper's Welford update, in float64.
        c1 = np.where(live, count + 1, count)
        delta = cand - mean
        new_mean = mean + delta / np.maximum(c1, 1)
        m2 = np.where(live, m2 + delta * (cand - new_mean), m2)
        mean = np.where(live, new_mean, mean)
        count = c1
    vals = grid[ids, rank].astype(np.float32)
    z_rows = z_grid[ids, rank]
    vals_b = np.split(vals, np.cumsum([len(b) for b in ids_b])[:-1])
    return {
        "ids_b": ids_b,
        "vals_b": vals_b,
        "ids": ids,
        "rank": rank,
        "grid": grid,
        "counts": counts,
        "z": z_rows,
        "flag": np.abs(z_rows) > THRESHOLD,
    }


def _by_key(ids, cols):
    """Rows stably sorted by key: each key's rows in their order."""
    import numpy as np

    order = np.argsort(ids, kind="stable")
    return ids[order], [c[order] for c in cols]


def _out_columns(out, vocab_index: dict, width: int):
    """Scored items ``(key, (value, *outs))`` as numpy columns: key ids
    and ``width`` value columns."""
    import numpy as np

    n = len(out)
    ids = np.fromiter((vocab_index[k] for k, _r in out), dtype=np.int64, count=n)
    cols = [np.fromiter((r[j] for _k, r in out), dtype=np.float64, count=n) for j in range(width)]
    return ids, cols


def _check_scored(name: str, out, vocab_index, data, rows: slice, kind: str) -> dict:
    """A flow's output against the oracle: the same rows per key, in
    order, with exact values; then per kind: z and flags, the EMA, or
    the running extrema."""
    width = {"zscore": 3, "ema": 2, "extrema": 3}[kind]
    got_ids, got = _out_columns(out, vocab_index, width)
    return _check_scored_cols(name, got_ids, got, data, rows, kind)


def _check_scored_cols(name: str, got_ids, got, data, rows: slice, kind: str) -> dict:
    """:func:`_check_scored` on output already in columns: key ids and
    the value columns of each scored row."""
    import numpy as np

    n = rows.stop - rows.start
    if len(got_ids) != n:
        msg = f"{name}: {len(got_ids)} rows out, {n} in"
        raise AssertionError(msg)
    ids = data["ids"][rows]
    rank = data["rank"][rows]
    grid = data["grid"]
    if kind == "zscore":
        want = [grid[ids, rank], data["z"][rows], data["flag"][rows].astype(np.float64)]
    elif kind == "ema":
        want = [grid[ids, rank], _ema_oracle(grid, data["counts"])[ids, rank]]
    else:
        v = grid
        want = [grid[ids, rank], np.minimum.accumulate(v, axis=1)[ids, rank],
                np.maximum.accumulate(v, axis=1)[ids, rank]]
    gk, got = _by_key(got_ids, got)
    wk, want = _by_key(ids.astype(np.int64), want)
    if not np.array_equal(gk, wk) or not np.array_equal(got[0], want[0]):
        msg = f"{name}: values differ from the input per key and order"
        raise AssertionError(msg)
    res = {}
    if kind == "zscore":
        err = np.abs(got[1] - want[1]) / np.maximum(1.0, np.abs(want[1]))
        res["max_z_err"] = float(err.max())
        if not res["max_z_err"] <= Z_RTOL:
            msg = f"{name}: z off by {res['max_z_err']} of max(1, |z|)"
            raise AssertionError(msg)
        if not np.array_equal(got[2], want[2]):
            msg = f"{name}: {int((got[2] != want[2]).sum())} flags differ"
            raise AssertionError(msg)
        res["anomalies"] = int(want[2].sum())
        res["zero_z_rows"] = int((want[1] == 0).sum())
    elif kind == "ema":
        err = np.abs(got[1] - want[1]) / np.maximum(1.0, np.abs(want[1]))
        res["max_ema_rel_err"] = float(err.max())
        if not res["max_ema_rel_err"] <= 1e-4:
            msg = f"{name}: EMA off by {res['max_ema_rel_err']}"
            raise AssertionError(msg)
    elif not (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])):
        msg = f"{name}: running extrema differ"
        raise AssertionError(msg)
    return res


def _ema_oracle(grid, counts):
    """Per (sensor, rank) debiased EMA in float64."""
    import numpy as np

    s = np.zeros(grid.shape[0])
    out = np.zeros_like(grid)
    for t in range(grid.shape[1]):
        live = counts > t
        s = np.where(live, s * (1.0 - EMA_ALPHA) + EMA_ALPHA * grid[:, t], s)
        out[:, t] = s / (1.0 - (1.0 - EMA_ALPHA) ** (t + 1))
    return out


def _recording_device_states():
    """Patch ``make_scan_state`` and ``InferAccelSpec.make_state`` to
    record every scan and infer state a run builds; returns the states
    and the undo function."""
    import bytewax_tpu_torch.engine.sharded_state as sharded_state
    from bytewax_tpu_torch.engine.infer import InferAccelSpec

    states = []
    make_scan = sharded_state.make_scan_state
    make_infer = InferAccelSpec.make_state

    def recording_scan(kind):
        states.append(make_scan(kind))
        return states[-1]

    def recording_infer(spec):
        states.append(make_infer(spec))
        return states[-1]

    sharded_state.make_scan_state = recording_scan
    InferAccelSpec.make_state = recording_infer

    def undo():
        sharded_state.make_scan_state = make_scan
        InferAccelSpec.make_state = make_infer

    return states, undo


#: Where phases 8 and 11 split the time of a run: (module, owner,
#: attribute, label).
_SPLITS = (
    ("bytewax_tpu_torch.engine.scan_accel", None, "factorize_keys", "factorize_keys"),
    ("bytewax_tpu_torch.engine.scan_accel", "ScanEmit", "items", "items"),
    ("bytewax_tpu_torch.engine.scan_accel", "DeviceScanState", "scan_rows", "scan_rows"),
    ("bytewax_tpu_torch.engine.sharded_state", "ShardedScanState", "scan_rows", "sharded_scan_rows"),
    ("bytewax_tpu_torch.engine.sharded_state", "_ShardedSlots", "_sizing", "sizing"),
    ("bytewax_tpu_torch.engine.infer", None, "extract_features", "extract_features"),
    ("bytewax_tpu_torch.engine.infer", "DeviceInferState", "score_rows", "score_rows"),
)


def _scan_flow_case(card: dict, name: str, flow_of, data, kind: str, rows: slice,
                    vocab_index, kernel_ms=None, phase: str = "anomaly") -> dict:
    """Run one flow of phase 8 and check it: its one device state on
    the card (a scan state, or the infer step's params), launches of
    the scan kernel (scan flows: ``kernel_ms`` is the instance's time
    per call), no demotion, output against the oracle.  The ``phase``
    line carries the seconds spent in each function of ``_SPLITS``; the
    returned run carries the state and the output ``out``."""
    import importlib

    from bytewax_tpu_torch.testing import TestingSink

    out = []
    demoted_before = _demotions()
    states, undo = _recording_device_states()
    saved, timers = [], {}
    for modname, owner, attr, label in _SPLITS:
        obj = importlib.import_module(modname)
        obj = getattr(obj, owner) if owner else obj
        saved.append((obj, attr, getattr(obj, attr)))
        timers[label] = _Timed(obj, attr)
    try:
        run = _run_flow(flow_of(TestingSink(out)))
    finally:
        undo()
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)
    demoted = _demotions() - demoted_before
    if demoted:
        msg = f"{name}: {demoted} steps demoted to the host tier"
        raise AssertionError(msg)
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"{name}: device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    if kernel_ms is not None and run["scan_launches"] <= 0:
        msg = f"{name}: the segmented-scan kernel was launched no time"
        raise AssertionError(msg)
    checked = _check_scored(name, out, vocab_index, data, rows, kind)
    n = rows.stop - rows.start
    _emit(
        card,
        phase,
        flow=name,
        rows=n,
        seconds=run["seconds"],
        rows_per_s=n / run["seconds"],
        scan_launches=run["scan_launches"],
        fold_launches=run["launches"],
        table_capacity=getattr(states[0], "capacity", None),
        step_demotions=demoted,
        phase_seconds=run["phase_seconds"],
        split_seconds={a: t.seconds for a, t in timers.items() if t.calls},
        split_calls={a: t.calls for a, t in timers.items() if t.calls},
        # Kernel time over wall time, from two measured numbers.
        kernel_busy_share=None
        if kernel_ms is None
        else run["scan_launches"] * kernel_ms * 1e-3 / run["seconds"],
        counters=run["counters"],
        **checked,
    )
    split = {
        "seconds": {a: t.seconds for a, t in timers.items() if t.calls},
        "calls": {a: t.calls for a, t in timers.items() if t.calls},
    }
    return dict(run, state=states[0], out=out, split=split)


#: Phase 8.x: the threshold the hot swap installs (phase 8 scores at
#: ``THRESHOLD``), and the items a chunk of the infer flow's source.
SWAP_THRESHOLD = 2.5
INFER_CHUNK = 1 << 16
#: Phases 8.y and 8.z: batches of phase 8's sensors a run, and the
#: rows of 8.y's tail, resumed on the host tier.
USER_SCAN_BATCHES = 1
USER_SCAN_TAIL = 1 << 16
#: Phase 8.z's mapper: each key's total decays by this factor a row
#: and is capped at ``UDF_CAP``.
UDF_DECAY = 0.9
UDF_CAP = 12.0
#: 8.y's float32 running totals against the float64 oracle, relative
#: to the running sum of the key's |value| (a float32 sum's scale).
TOTAL_RTOL = 1e-5


class _EpochSink:
    """A one-partition sink into ``rows`` that marks the wall time
    (``time.time()``, the flight ring's clock) and the row count before
    each batch it takes."""

    def __init__(self):
        from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition

        self.rows, self.marks = [], []
        probe = self

        class _Part(StatelessSinkPartition):
            def write_batch(self, items):
                probe.marks.append((time.time(), len(probe.rows)))
                probe.rows.extend(items)

        class _Sink(DynamicSink):
            def build(self, step_id, worker_index, worker_count):
                return _Part()

        self.sink = _Sink()

    def rows_before(self, t: float) -> int:
        """Rows written before wall time ``t``."""
        return min((n for tt, n in self.marks if tt >= t), default=len(self.rows))


def _ring_events(kind: str, t0: float) -> list:
    from bytewax_tpu_torch.engine import flight

    return [e for e in flight.RECORDER.tail(1 << 16) if e["kind"] == kind and e["t"] >= t0]


def _infer_run(name: str, chunks, armed=None) -> dict:
    """``anomaly_infer_flow`` over ``chunks`` of items, one epoch a
    chunk, with ``armed`` params pending (``update_params``) at its
    start; the flight ring on, the install timed.  Returns the run
    with its output, sink marks, infer state and ring events."""
    from datetime import timedelta

    from bytewax_tpu_torch.engine import driver
    from bytewax_tpu_torch.engine.infer import DeviceInferState
    from bytewax_tpu_torch.models.anomaly import anomaly_infer_flow
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    sink = _EpochSink()
    states, undo = _recording_device_states()
    orig_install = DeviceInferState.install
    install = _Timed(DeviceInferState, "install")
    digest = None
    t0 = time.time()
    try:
        with _Knobs(BYTEWAX_FLIGHT_RECORDER="1"):
            driver.reset_params_update()
            if armed is not None:
                digest = driver.update_params(armed)
            flow = anomaly_infer_flow(ArrayBatchSource(chunks), sink.sink, threshold=THRESHOLD)
            run = _run_flow(flow, epoch_interval=timedelta(0))
    finally:
        undo()
        DeviceInferState.install = orig_install
        driver.reset_params_update()
    if len(states) != 1 or states[0].device.type != DEV:
        raise AssertionError(f"{name}: infer state not on cuda: {[s.device for s in states]}")
    return dict(run, out=sink.rows, sink=sink, state=states[0], digest=digest, install=install,
                swaps=_ring_events("params_swap", t0), rejected=_ring_events("params_swap_rejected", t0))


def _check_swapped(name: str, out, index, data, n_before: int) -> dict:
    """The infer flow's output against the oracle when its threshold
    went from ``THRESHOLD`` to ``SWAP_THRESHOLD`` after the first
    ``n_before`` rows written: values exact per key and in order, z
    within ``Z_RTOL`` of max(1, |z|), each flag the device's own
    compare of its z with the threshold of its side of the swap, and
    the oracle's flag wherever the oracle's |z| is farther than
    ``Z_RTOL`` from that threshold (the rows nearer are counted)."""
    import numpy as np

    n = len(out)
    ids, (vals, z, flag) = _out_columns(out, index, 3)
    after = np.arange(n) >= n_before
    t = np.where(after, float(np.float32(SWAP_THRESHOLD)), float(np.float32(THRESHOLD)))
    if not np.array_equal(flag.astype(bool), np.abs(z) > t):
        raise AssertionError(f"{name}: a flag is not its z against its side's threshold")
    # The oracle per row in output order: each key's rows come out in
    # their input order, so a row's rank is its place among its key's.
    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=len(index)))[:-1]])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - starts[ids[order]]
    if not (data["counts"][ids] > rank).all() or not np.array_equal(vals, data["grid"][ids, rank]):
        raise AssertionError(f"{name}: values differ from the input per key and order")
    z_want = _z_grid(data)[ids, rank]
    scale = np.maximum(1.0, np.abs(z_want))
    z_err = float((np.abs(z - z_want) / scale).max())
    if not z_err <= Z_RTOL:
        raise AssertionError(f"{name}: z off by {z_err} of max(1, |z|)")
    near = np.abs(np.abs(z_want) - t) <= Z_RTOL * scale
    if not np.array_equal(flag.astype(bool)[~near], (np.abs(z_want) > t)[~near]):
        raise AssertionError(f"{name}: flags differ from the oracle's")
    return {"max_z_err": z_err, "near_threshold_rows": int(near.sum()),
            "anomalies_before": int(flag[~after].sum()), "anomalies_after": int(flag[after].sum())}


def _z_grid(data):
    """Per (sensor, rank) oracle z, from the per-row oracle."""
    import numpy as np

    if "z_grid" not in data:
        grid = np.zeros_like(data["grid"])
        grid[data["ids"], data["rank"]] = data["z"]
        data["z_grid"] = grid
    return data["z_grid"]


def _swap_case(card: dict, items, data, vocab, index) -> None:
    """8.x: ``anomaly_infer_flow`` over ``items`` in ``INFER_CHUNK``-item
    chunks, one epoch a chunk, with a new threshold armed before the
    run: one swap at the first close, the rows written before it under
    the old threshold and every later row under the new, the step's
    params on the card with the armed digest.  Then one chunk with a
    mismatched tree: rejected once, the output that of a run with no
    swap."""
    import numpy as np

    chunks = [items[i : i + INFER_CHUNK] for i in range(0, len(items), INFER_CHUNK)]
    run = _infer_run("swap", chunks, {"threshold": np.float32(SWAP_THRESHOLD)})
    swaps, state = run["swaps"], run["state"]
    if len(swaps) != 1 or run["counters"].get("params_swap_count", 0) != 1 or run["install"].calls != 1:
        raise AssertionError(f"swap: {len(swaps)} swap events, {run['install'].calls} installs, want 1")
    if swaps[0]["digest"] != run["digest"] or state.digest != run["digest"] or state.generation != 1:
        raise AssertionError(f"swap: {swaps[0]} and the state's {state.digest}, armed {run['digest']}")
    params = state._params["threshold"]
    if params.device.type != DEV or float(params) != float(np.float32(SWAP_THRESHOLD)):
        raise AssertionError(f"swap: the step's threshold is {params} on {params.device}")
    n_before = run["sink"].rows_before(swaps[0]["t"])
    if n_before == 0 or n_before >= len(items) or n_before % INFER_CHUNK:
        raise AssertionError(f"swap: {n_before} rows written before the swap")
    checked = _check_swapped("swap", run["out"], index, data, n_before)
    # A mismatched tree, and no swap, over one chunk.
    rejected = _infer_run("swap_rejected", chunks[:1], {"not_threshold": np.float32(SWAP_THRESHOLD)})
    plain = _infer_run("no_swap", chunks[:1])
    if len(rejected["rejected"]) != 1 or rejected["swaps"]:
        raise AssertionError(f"swap_rejected: {rejected['rejected']}, {len(rejected['swaps'])} swaps")
    if rejected["out"] != plain["out"] or rejected["state"].generation != 0:
        raise AssertionError("swap_rejected: the output differs from a run with no swap")
    _check_scored("no_swap", plain["out"], index, data, slice(0, len(chunks[0])), "zscore")
    _emit(card, "anomaly", flow="anomaly_infer_flow_swap", rows=len(items), seconds=run["seconds"],
          rows_per_s=len(items) / run["seconds"], swap_epoch=swaps[0]["epoch"],
          rows_before_swap=n_before, install_seconds=run["install"].seconds,
          threshold=[THRESHOLD, SWAP_THRESHOLD], digest=run["digest"], params_device=str(params.device),
          rejected_rows=len(chunks[0]), rejected_seconds=rejected["seconds"],
          rejected_events=len(rejected["rejected"]), no_swap_seconds=plain["seconds"],
          phase_seconds=run["phase_seconds"], **checked)


def _running_sum_map():
    """A scan kind of the user's own, as ``tests/test_torch_scan_user_kind.py``
    defines it: a per-key running sum with its count, emitting
    ``(value, running_total)``.  Its ``lift`` builds its count column
    as a user writes it, with no ``device=``.  Returns a mapper."""
    import torch

    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.ops.scan import ScanKind

    class RunningSumKind(ScanKind):
        name = "running_sum"
        fields = {"count": (0, torch.int32), "total": (0.0, torch.float32)}

        def lift(self, values):
            return torch.ones((values.shape[0],), dtype=torch.int32), values

        def merge(self, a, b):
            return a[0] + b[0], a[1] + b[1]

        def emit(self, pre, post, values):
            return (post[1],)

    class RunningSumMap(xla.ScanMap):
        kind = "running_sum"

        def __call__(self, state, value):
            count, total = (0, 0.0) if state is None else state
            return (count + 1, total + value), (value, total + value)

        def device_kind(self):
            return RunningSumKind()

    return RunningSumMap()


def _capped_decay(state, v):
    """8.z's per-key mapper (``tests/test_torch_scan.py``'s): a total
    that decays and is capped, and the key's row count."""
    import torch

    total, n = state
    total = torch.clamp(total * UDF_DECAY + v, max=UDF_CAP)
    return (total, n + 1), (total, n + 1)


def _scan_map_flow(name: str, source, mapper, sink):
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.dataflow import Dataflow

    flow = Dataflow(name)
    s = op.input("inp", flow, source)
    s = op.stateful_map("scan", s, mapper)
    # The key rides in the value: the truncating sink keeps values.
    s = op.map("keyed", s, lambda kv: (kv[0], (kv[0], kv[1])))
    op.output("out", s, sink)
    return flow


def _running_oracle(data, kind: str):
    """Per (sensor, rank) float64 oracle of 8.y (``running_sum``: the
    running total and the running sum of |value|) or 8.z
    (``capped_decay``: the capped total)."""
    import numpy as np

    grid = data["grid"]  # 0 past each sensor's last row
    if kind == "running_sum":
        return np.cumsum(grid, axis=1), np.cumsum(np.abs(grid), axis=1)
    total = np.zeros(grid.shape[0])
    out = np.zeros_like(grid)
    for t in range(grid.shape[1]):
        total = np.where(data["counts"] > t, np.minimum(total * UDF_DECAY + grid[:, t], UDF_CAP), total)
        out[:, t] = total
    return out, None


def _check_running(name: str, rows, index, data, n: int, kind: str) -> dict:
    """8.y's or 8.z's output rows ``(key, (value, *outs))`` against
    :func:`_running_oracle`: the first ``n`` rows of the data, values
    exact per key and in order; 8.y's totals within ``TOTAL_RTOL`` of
    the running sum of |value|, 8.z's within 1e-4 of max(1, |total|)
    and its counts exact."""
    import numpy as np

    width = 2 if kind == "running_sum" else 3
    ids, got = _out_columns(rows, index, width)
    if len(ids) != n:
        raise AssertionError(f"{name}: {len(ids)} rows out, {n} in")
    gk, got = _by_key(ids, got)
    wk, (rank,) = _by_key(data["ids"][:n].astype(np.int64), [data["rank"][:n]])
    if not np.array_equal(gk, wk) or not np.array_equal(got[0], data["grid"][wk, rank]):
        raise AssertionError(f"{name}: values differ from the input per key and order")
    want, scale = _running_oracle(data, kind)
    want = want[wk, rank]
    if kind == "running_sum":
        diff, scale = np.abs(got[1] - want), scale[wk, rank]
        # Where every |value| so far is 0, the total must be 0 exactly.
        err = float(np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), np.where(diff > 0, np.inf, 0.0)).max())
        mean_abs = float(np.abs(data["grid"][wk, rank]).mean())
        res = {"max_total_rel_err": err, "max_total_err_of_mean_abs": float(diff.max()) / mean_abs}
        if not err <= TOTAL_RTOL:
            raise AssertionError(f"{name}: a total off by {err} of the running sum of |value|")
        return res
    err = float((np.abs(got[1] - want) / np.maximum(1.0, np.abs(want))).max())
    if not err <= 1e-4:
        raise AssertionError(f"{name}: a total off by {err} of max(1, |total|)")
    if not np.array_equal(got[2], rank + 1.0):
        raise AssertionError(f"{name}: counts differ")
    return {"max_total_rel_err": err}


def _user_scan_run(name: str, flow, db=None, accel: str = "1") -> dict:
    """One run of 8.y or 8.z, one epoch a batch: the scan state it
    built, no demotion, the ``segment_scan`` kernel launched no time
    (the kinds have no ``kernel``), the generic body's and the UDF's
    calls timed."""
    from datetime import timedelta

    from bytewax_tpu_torch.engine.scan_accel import DeviceScanState
    from bytewax_tpu_torch.recovery import RecoveryConfig

    kwargs = {"epoch_interval": timedelta(0)}
    if db is not None:
        kwargs["recovery_config"] = RecoveryConfig(str(db))
    demoted_before = _demotions()
    states, undo = _recording_device_states()
    orig = DeviceScanState.scan_rows
    timer = _Timed(DeviceScanState, "scan_rows")
    try:
        with _Knobs(BYTEWAX_TPU_ACCEL=accel, BYTEWAX_TPU_INGEST_TARGET_ROWS="0"):
            run = _run_flow(flow, **kwargs)
    finally:
        undo()
        DeviceScanState.scan_rows = orig
    if _demotions() != demoted_before:
        raise AssertionError(f"{name}: a step demoted to the host tier")
    if run["scan_launches"]:
        raise AssertionError(f"{name}: {run['scan_launches']} segment_scan launches; the kind has no kernel")
    return dict(run, states=states, scan_calls=timer.calls, scan_seconds=timer.seconds)


def _on_card_tables(name: str, states) -> list:
    tables = [t for s in states for t in (s._fields or {}).values()]
    if len(states) != 1 or not tables or any(t.device.type != DEV for t in tables):
        raise AssertionError(f"{name}: scan tables on {[t.device for t in tables]}")
    return sorted({str(t.device) for t in tables})


def _body_device_ms(kind, data, n: int, capacity: int = 16384) -> dict:
    """The device milliseconds of one call of ``kind``'s plain version
    on a grouped batch of ``n`` of ``data``'s rows (all the kernels it
    launches, from ``torch.profiler`` as phase 7 reads it), its kernel
    launches a call, the host's wall ms a call (synchronized) and the
    bound: its rows' slot, value and output read or written once, each
    key's table row read and written once."""
    import numpy as np
    import torch

    ids, vals = data["ids_b"][0][:n], data["vals_b"][0][:n]
    order = np.argsort(ids, kind="stable")
    slots = torch.from_numpy(ids[order]).to(DEV)
    values = torch.from_numpy(vals[order]).to(DEV)
    fields = {nm: torch.full((capacity,), init, dtype=dt, device=DEV) for nm, (init, dt) in kind.fields.items()}

    def call():
        kind.run(fields, slots, values)

    prof = _profiled(call, 2, names=("",))
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    ms = None if prof["ms"] is None else prof["ms"] * prof["launches_per_call"]
    bytes_moved = 12 * n + 2 * len(np.unique(ids)) * sum(t.itemsize for t in fields.values())
    return {"device_ms": ms, "kernels_per_call": prof["launches_per_call"], "wall_ms": wall_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def _user_kind_case(card: dict, items, data, vocab, index) -> None:
    """8.y: a scan kind of the user's own through ``op.stateful_map``
    on the card over ``USER_SCAN_BATCHES`` batches of phase 8's
    sensors, one epoch a batch, with a store; aborted there and resumed
    with ``BYTEWAX_TPU_ACCEL=0`` over a ``USER_SCAN_TAIL``-row tail from
    the card's snapshots; then the generic body's device time."""
    import tempfile

    from bytewax_tpu_torch.engine.arrays import ArrayBatch

    b, n = USER_SCAN_BATCHES, len(items)
    pairs = list(zip(data["ids_b"], data["vals_b"]))
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in pairs[:b]]
    tail_ids, tail_vals = pairs[b][0][:USER_SCAN_TAIL], pairs[b][1][:USER_SCAN_TAIL]
    batches.append(ArrayBatch({"key_id": tail_ids, "value": tail_vals}, key_vocab=vocab))
    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_user_kind_") as tmp:
        db = _fresh_store(Path(tmp), "store")
        source = _batch_source(batches, aborts=[b])
        dev = _user_scan_run("user_kind", _scan_map_flow("user_kind", source, _running_sum_map(),
                                                         _truncating_sink(rows)), db)
        devices = _on_card_tables("user_kind", dev["states"])
        if len(rows) != b * n:
            raise AssertionError(f"user_kind: {len(rows)} rows before the abort, {b * n} in")
        host = _user_scan_run("user_kind_resumed", _scan_map_flow("user_kind", source, _running_sum_map(),
                                                                 _truncating_sink(rows)), db, accel="0")
    if host["states"]:
        raise AssertionError("user_kind_resumed: built a device state with the accelerator off")
    checked = _check_running("user_kind", rows, index, data, b * n + USER_SCAN_TAIL, "running_sum")
    body = _body_device_ms(_running_sum_map().device_kind(), data, n)
    _emit(card, "anomaly", flow="user_scan_kind", rows=b * n, seconds=dev["seconds"],
          rows_per_s=b * n / dev["seconds"], tables_on=devices, scan_launches=dev["scan_launches"],
          scan_calls=dev["scan_calls"], scan_seconds=dev["scan_seconds"],
          resumed_rows=USER_SCAN_TAIL, resumed_seconds=host["seconds"],
          resumed_rows_per_s=USER_SCAN_TAIL / host["seconds"],
          generic_body={"rows": n, "keys": len(index), **body},
          phase_seconds=dev["phase_seconds"], **checked)


def _udf_case(card: dict, items, data, vocab, index) -> None:
    """8.z: ``torch_stateful_map`` of the capped-decay mapper on the
    card over ``USER_SCAN_BATCHES`` batches of phase 8's sensors; then
    one batch's steps and device time."""
    import numpy as np

    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource
    from bytewax_tpu_torch.ops.scan import TorchUdfScan

    b, n = USER_SCAN_BATCHES, len(items)
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab)
               for i, v in list(zip(data["ids_b"], data["vals_b"]))[:b]]
    rows = []
    mapper = xla.torch_stateful_map(_capped_decay, (0.0, 0))
    run = _user_scan_run("torch_stateful_map", _scan_map_flow("udf", ArrayBatchSource(batches), mapper,
                                                              _truncating_sink(rows)))
    devices = _on_card_tables("torch_stateful_map", run["states"])
    checked = _check_running("torch_stateful_map", rows, index, data, b * n, "capped_decay")
    body = _body_device_ms(TorchUdfScan(_capped_decay, (0.0, 0)), data, n)
    # One vmap step a row of the batch's longest key run.
    body["steps"] = int(np.bincount(data["ids_b"][0][:n]).max())
    _emit(card, "anomaly", flow="torch_stateful_map", rows=b * n, seconds=run["seconds"],
          rows_per_s=b * n / run["seconds"], tables_on=devices, scan_launches=run["scan_launches"],
          scan_calls=run["scan_calls"], scan_seconds=run["scan_seconds"],
          udf_batch={"rows": n, "keys": len(index), **body}, phase_seconds=run["phase_seconds"], **checked)


def phase_anomaly(card: dict, n: int, n_keys: int, times: dict) -> dict:
    """Phase 8: the anomaly detector and the other scan flows
    (``times``: phase 7's times of each kernel instance)."""
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.anomaly import anomaly_flow, anomaly_infer_flow
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    launches = {}

    def columnar(data, vocab, batches=None):
        pairs = list(zip(data["ids_b"], data["vals_b"]))[:batches]
        return [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in pairs]

    for label, keys, n_batches, seed in (
        ("anomaly_flow", n_keys, ANOMALY_BATCHES, 20),
        ("anomaly_flow_2^20_sensors", WIDE_KEYS, WIDE_BATCHES, 21),
    ):
        data = _anomaly_data(n_batches, n, keys, seed)
        vocab = np.array([f"sensor_{i:07d}" for i in range(keys)])
        index = {k: i for i, k in enumerate(vocab.tolist())}
        batches = columnar(data, vocab)
        run = _scan_flow_case(
            card, label,
            lambda sink, b=batches: anomaly_flow(ArrayBatchSource(b), sink, threshold=THRESHOLD),
            data, "zscore", slice(0, n * n_batches), index, times["welford"]["ms"],
        )
        launches[label] = run["scan_launches"]
        if label == "anomaly_flow":
            sensors = (data, vocab, index)

    data, vocab, index = sensors
    # The infer form over the first batch's rows as Python items: a
    # per-item host mapper, then the forward pass on the card.
    items = list(zip(vocab[data["ids_b"][0]].tolist(), data["vals_b"][0].tolist()))
    chunks = [items[i : i + (1 << 16)] for i in range(0, len(items), 1 << 16)]
    _scan_flow_case(
        card, "anomaly_infer_flow",
        lambda sink: anomaly_infer_flow(ArrayBatchSource(chunks), sink, threshold=THRESHOLD),
        data, "zscore", slice(0, n), index,
    )

    for label, mapper, kind, instance in (
        ("ema", xla.ema(EMA_ALPHA), "ema", "ema"),
        ("running_extrema", xla.running_extrema(), "extrema", "extrema"),
    ):
        batches = columnar(data, vocab, SCAN_FLOW_BATCHES)

        def flow_of(sink, b=batches, m=mapper, label=label):
            flow = Dataflow(label)
            s = op.input("inp", flow, ArrayBatchSource(b))
            s = op.stateful_map("scan", s, m)
            op.output("out", s, sink)
            return flow

        run = _scan_flow_case(card, label, flow_of, data, kind,
                              slice(0, n * SCAN_FLOW_BATCHES), index, times[instance]["ms"])
        launches[label] = run["scan_launches"]

    steps = {}
    t0 = time.perf_counter()
    for name, case in (("swap", _swap_case), ("user_kind", _user_kind_case), ("udf", _udf_case)):
        s0 = time.perf_counter()
        case(card, items, data, vocab, index)
        steps[name] = time.perf_counter() - s0
    _emit(card, "anomaly_user_cases", seconds=time.perf_counter() - t0, step_seconds=steps)
    return launches


# -- phase 9 -----------------------------------------------------------------

#: 1BRC batches of the recovery runs, and the epoch whose seal crashes.
RECOVERY_BRC_BATCHES = 16
RECOVERY_BRC_CRASH_EPOCH = 8
#: ``anomaly_flow`` batches (cut from 4: a synchronous run of 4 took
#: 89 s on the H100, most of it writing ~663,000 store rows a close),
#: its sensors (cut from 2^20: the four runs took 182 s of an 880 s
#: script on the H100, the store's rows a touched key pacing them), and
#: the epoch whose seal crashes.
RECOVERY_ANOMALY_BATCHES = 2
RECOVERY_ANOMALY_KEYS = 1 << 19
RECOVERY_ANOMALY_CRASH_EPOCH = 2
#: Tumbling-window batches, and the batch before which the run aborts.
RECOVERY_WINDOW_BATCHES = 8
RECOVERY_WINDOW_ABORT = 4
#: The rescale runs: (lanes, the batch before which each run aborts);
#: the last run goes to the end of the 16 batches.
RESCALE_RUNS = ((2, 8), (3, 12), (1, None))
#: Keys a page of resumed state holds (the driver's resume pager).
RESUME_PAGE = 4096
#: The knobs of each checkpoint mode.
CKPT_MODES = {
    "sync": {},
    "delta_async": {"BYTEWAX_TPU_CKPT_DELTA": "1", "BYTEWAX_TPU_CKPT_ASYNC": "1"},
}


class _Knobs:
    """Set environment knobs for a ``with`` block (and clear the fault
    injector's plan on the way in and out)."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        from bytewax_tpu_torch.engine import faults

        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        faults.reset()
        return self

    def __exit__(self, *exc):
        from bytewax_tpu_torch.engine import faults

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
        return False


def _batch_source(batches, aborts=()):
    """A resumable source of pre-built batches: one partition whose
    snapshot is the index of the next batch.  Before each index in
    ``aborts`` it aborts the execution once (the engine's
    ``AbortExecution``, as ``TestingSource.ABORT()`` raises it)."""
    from bytewax_tpu_torch.inputs import (
        AbortExecution,
        FixedPartitionedSource,
        StatefulSourcePartition,
    )

    pending = set(aborts)

    class _Part(StatefulSourcePartition):
        def __init__(self, at):
            self.at = at

        def next_batch(self):
            if self.at in pending:
                pending.discard(self.at)
                raise AbortExecution()
            if self.at >= len(batches):
                raise StopIteration()
            self.at += 1
            return batches[self.at - 1]

        def snapshot(self):
            return self.at

    class _Source(FixedPartitionedSource):
        def list_parts(self):
            return ["batches"]

        def build_part(self, step_id, for_part, resume_state):
            return _Part(resume_state or 0)

    return _Source()


def _truncating_sink(rows: list):
    """A one-partition sink into ``rows`` with ``FileSink``'s resume
    rule: its snapshot is the number of rows written, and a resumed
    execution first cuts ``rows`` back to that number, so rows written
    after the last durable epoch are replaced by the replay, not
    doubled.  Items are ``(key, value)``; ``value`` is kept."""
    from bytewax_tpu_torch.outputs import FixedPartitionedSink, StatefulSinkPartition

    cut = []

    class _Part(StatefulSinkPartition):
        def write_batch(self, values):
            rows.extend(values)

        def snapshot(self):
            return len(rows)

    class _Sink(FixedPartitionedSink):
        def list_parts(self):
            return ["rows"]

        def build_part(self, step_id, for_part, resume_state):
            keep = resume_state or 0
            cut.append(len(rows) - keep)
            del rows[keep:]
            return _Part()

    sink = _Sink()
    sink.cut = cut
    return sink


class _TimedIter:
    """Wrap a generator method to count the items it yields and the
    seconds spent producing them (the consumer's time left out)."""

    def __init__(self, obj, name: str):
        self.items = 0
        self.seconds = 0.0
        inner = getattr(obj, name)

        def wrapped(*args, **kwargs):
            it = inner(*args, **kwargs)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self.seconds += time.perf_counter() - t0
                    return
                self.seconds += time.perf_counter() - t0
                self.items += 1
                yield item

        setattr(obj, name, wrapped)


class _StoreProbe:
    """For one run: the store rows each epoch close writes, the resume's
    reads (store reads; store reads with unpickle) and installs
    (``load_many`` of each device state class), and the rescale
    migration, by wrapping those functions for a ``with`` block."""

    def __init__(self):
        from bytewax_tpu_torch.engine import driver, scan_accel, window_accel, xla
        from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

        self._sites = [
            (RecoveryStore, "write_epoch"),
            (RecoveryStore, "rescale"),
            (RecoveryStore, "iter_snaps"),
            (driver._Driver, "iter_resume_states"),
            (xla.DeviceAggState, "load_many"),
            (scan_accel.DeviceScanState, "load_many"),
            (window_accel.DeviceWindowAggState, "load_many"),
        ]
        self.rows_per_close = []

    def __enter__(self):
        from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

        self._saved = [(obj, name, obj.__dict__[name]) for obj, name in self._sites]
        inner = RecoveryStore.write_epoch
        rows = self.rows_per_close

        def write_epoch(store, ex_num, worker_count, epoch, snaps, *args, **kwargs):
            rows.append(len(snaps))
            return inner(store, ex_num, worker_count, epoch, snaps, *args, **kwargs)

        RecoveryStore.write_epoch = write_epoch
        self.rescale = _Timed(RecoveryStore, "rescale")
        self.store_reads = _TimedIter(RecoveryStore, "iter_snaps")
        self.resume_reads = _TimedIter(self._sites[3][0], "iter_resume_states")
        self.installs = {
            obj.__name__: _Timed(obj, name) for obj, name in self._sites[4:]
        }
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self._saved:
            setattr(obj, name, orig)
        return False

    def numbers(self) -> dict:
        closes = self.rows_per_close
        return {
            "closes_written": len(closes),
            "rows_written": sum(closes),
            "rows_per_close_mean": sum(closes) / len(closes) if closes else 0,
            "rows_per_close_max": max(closes, default=0),
            "resume_rows_read": self.resume_reads.items,
            "resume_read_s": self.store_reads.seconds,
            "resume_read_unpickle_s": self.resume_reads.seconds,
            "resume_install_s": {n: t.seconds for n, t in self.installs.items() if t.calls},
            "resume_install_calls": {n: t.calls for n, t in self.installs.items() if t.calls},
            "rescale_migration_s": self.rescale.seconds if self.rescale.calls else None,
        }


def _fresh_store(root: Path, name: str) -> Path:
    from bytewax_tpu_torch.recovery import init_db_dir

    db = root / name
    db.mkdir()
    init_db_dir(db, 1)
    return db


def _recovery_run(card: dict, path: str, run: str, flow, db, knobs: dict, records: list,
                  rows: int, entry=None, expect=(), states_of=None, kernel: str = "launches") -> dict:
    """Run ``flow`` once against the store in ``db`` (None: no store)
    with one epoch per batch, under ``knobs``; check that it stayed on
    the device tier, on the card, and launched its kernel; emit its
    ``recovery`` line and return it."""
    from datetime import timedelta

    from bytewax_tpu_torch.recovery import RecoveryConfig

    demoted_before = _demotions()
    kwargs = {"epoch_interval": timedelta(0)}
    if db is not None:
        kwargs["recovery_config"] = RecoveryConfig(str(db))
    states, timers, undo = (states_of or _recording_states)()
    try:
        with _Knobs(BYTEWAX_TPU_INGEST_TARGET_ROWS="0", **knobs), _StoreProbe() as probe:
            res = _run_flow(flow, entry=entry, expect=expect, **kwargs)
    finally:
        undo()
    demoted = _demotions() - demoted_before
    if demoted:
        msg = f"{path} {run}: {demoted} steps demoted to the host tier"
        raise AssertionError(msg)
    if not states or any(s.device.type != DEV for s in states):
        msg = f"{path} {run}: device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    if res[kernel] <= 0:
        msg = f"{path} {run}: its kernel was launched no time"
        raise AssertionError(msg)
    line = {
        "path": path,
        "run": run,
        "knobs": knobs,
        "raised": res["raised"],
        "rows": rows,
        "seconds": res["seconds"],
        "rows_per_s": rows / res["seconds"],
        "fold_launches": res["launches"],
        "scan_launches": res["scan_launches"],
        "device_states": len(states),
        "phase_seconds": res["phase_seconds"],
        "store_bytes": None if db is None else sum(p.stat().st_size for p in db.iterdir()),
        **probe.numbers(),
    }
    _emit(card, "recovery", **line)
    records.append(line)
    line.update(states=states, timers=timers)
    return line


def _recovery_brc(card: dict, root: Path, n: int, n_stations: int, launches: dict) -> list:
    """Phase 9.1: 1BRC columnar four ways, and 9.4: the rescale runs,
    over the same batches."""
    from bytewax_tpu_torch.engine.faults import InjectedCrash
    from bytewax_tpu_torch.models.brc import brc_flow_columnar, generate_batches
    from bytewax_tpu_torch.testing import TestingSink, cluster_main

    batches = generate_batches(n * RECOVERY_BRC_BATCHES, n, n_stations, seed=40)
    want = _reference(batches, n_stations)
    rows = n * RECOVERY_BRC_BATCHES
    records = []
    runs = (
        ("no_store", None, {}),
        ("sync", "sync", {}),
        ("delta_async", "delta_async", {}),
        ("delta_async_crash", "delta_async",
         {"BYTEWAX_TPU_FAULTS": f"snapshot_seal:crash:{RECOVERY_BRC_CRASH_EPOCH}:x1"}),
    )
    for run, mode, extra in runs:
        db = None if mode is None else _fresh_store(root, f"brc_{run}")
        knobs = {**CKPT_MODES.get(mode, {}), **extra}
        out = []
        flow = brc_flow_columnar(_batch_source(batches), TestingSink(out))
        line = _recovery_run(card, "brc", run, flow, db, knobs, records, rows, expect=(InjectedCrash,))
        launches["brc"] = launches.get("brc", 0) + line["fold_launches"]
        if "BYTEWAX_TPU_FAULTS" in knobs:
            if line["raised"] != "InjectedCrash" or out:
                msg = f"brc {run}: the seal of epoch {RECOVERY_BRC_CRASH_EPOCH} did not crash the run"
                raise AssertionError(msg)
            flow = brc_flow_columnar(_batch_source(batches), TestingSink(out))
            line = _recovery_run(card, "brc", "delta_async_resume", flow, db, CKPT_MODES[mode], records, rows)
            launches["brc"] += line["fold_launches"]
        line["max_abs_mean_err"] = _check_brc(out, want, f"brc {line['run']}")
        if run == "no_store":
            uninterrupted = list(out)
        else:
            _check_same_brc(out, uninterrupted, f"brc {line['run']}")

    # 9.4: 2 lanes, then 3 (rescaled), then 1 (rescaled), one store.
    db = _fresh_store(root, "rescale")
    source = _batch_source(batches, aborts=[at for _lanes, at in RESCALE_RUNS if at])
    out = []
    done = 0
    for i, (lanes, at) in enumerate(RESCALE_RUNS):
        flow = brc_flow_columnar(source, TestingSink(out))
        entry = None
        if lanes > 1:
            def entry(f, lanes=lanes, **kw):
                return cluster_main(f, [], 0, worker_count_per_proc=lanes, **kw)
        timed = ("update_batch",)
        line = _recovery_run(
            card, "rescale", f"lanes_{lanes}", flow, db,
            {"BYTEWAX_TPU_RESCALE": "1"} if i else {}, records,
            n * ((at or RECOVERY_BRC_BATCHES) - done), entry=entry,
            states_of=lambda: _recording_states(timed=timed),
        )
        start, done = done, at or RECOVERY_BRC_BATCHES
        launches["rescale"] = launches.get("rescale", 0) + line["fold_launches"]
        # The lanes of one process share the step's one slot table on
        # the card (as in the JAX package): every batch folds there.
        folds = [t["update_batch"].calls for t in line["timers"]]
        if folds != [(at or RECOVERY_BRC_BATCHES) - start]:
            msg = f"rescale, {lanes} lanes: folds of each slot table {folds}"
            raise AssertionError(msg)
        if i and line["rescale_migration_s"] is None:
            msg = f"rescale to {lanes} lanes: the store was not migrated"
            raise AssertionError(msg)
        if at is not None and out:
            msg = f"rescale, {lanes} lanes: output before the end of the input"
            raise AssertionError(msg)
    _check_brc(out, want, "rescale")
    _check_same_brc(out, uninterrupted, "rescale")
    return records


def _recovery_anomaly(card: dict, root: Path, n: int, n_keys: int, launches: dict) -> list:
    """Phase 9.2: ``anomaly_flow`` at 2^19 sensors, synchronous, delta
    and async, then delta and async with a crash at a seal and a
    resume; every run's scored rows against the oracle, exactly once."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.engine.faults import InjectedCrash
    from bytewax_tpu_torch.models.anomaly import anomaly_flow

    data = _anomaly_data(RECOVERY_ANOMALY_BATCHES, n, n_keys, seed=41)
    vocab = np.array([f"sensor_{i:07d}" for i in range(n_keys)])
    index = {k: i for i, k in enumerate(vocab.tolist())}
    batches = [
        ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab)
        for i, v in zip(data["ids_b"], data["vals_b"])
    ]
    rows = n * RECOVERY_ANOMALY_BATCHES
    every = slice(0, rows)
    records = []

    def flow_of(out):
        sink = _truncating_sink(out)
        return anomaly_flow(_batch_source(batches), sink, threshold=THRESHOLD, fmt=lambda kv: ("all", kv)), sink

    crash = {"BYTEWAX_TPU_FAULTS": f"snapshot_seal:crash:{RECOVERY_ANOMALY_CRASH_EPOCH}:x1"}
    for run, mode, extra in (
        ("sync", "sync", {}),
        ("delta_async", "delta_async", {}),
        ("delta_async_crash", "delta_async", crash),
    ):
        db = _fresh_store(root, f"anomaly_{run}")
        out = []
        flow, _sink = flow_of(out)
        line = _recovery_run(card, "anomaly", run, flow, db, {**CKPT_MODES[mode], **extra}, records, rows,
                             expect=(InjectedCrash,), states_of=_scan_states, kernel="scan_launches")
        launches["anomaly"] = launches.get("anomaly", 0) + line["scan_launches"]
        if extra:
            if line["raised"] != "InjectedCrash":
                msg = f"anomaly {run}: the seal of epoch {RECOVERY_ANOMALY_CRASH_EPOCH} did not crash the run"
                raise AssertionError(msg)
            from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

            store = RecoveryStore(db)
            try:
                resume_epoch = store.resume_from().resume_epoch
            finally:
                store.close()
            written = len(out)
            flow, sink = flow_of(out)
            line = _recovery_run(card, "anomaly", "delta_async_resume", flow, db, CKPT_MODES[mode], records, rows,
                                 states_of=_scan_states, kernel="scan_launches")
            launches["anomaly"] += line["scan_launches"]
            line.update(rows_before_crash=written, rows_cut_on_resume=sink.cut[-1], resume_epoch=resume_epoch)
        checked = _check_scored(f"anomaly {line['run']}", out, index, data, every, "zscore")
        line.update(checked)
        _emit(card, "recovery_check", path="anomaly", run=line["run"], scored_rows=len(out),
              **{k: line[k] for k in ("rows_before_crash", "rows_cut_on_resume", "resume_epoch") if k in line},
              **checked)
    return records


def _scan_states():
    states, undo = _recording_device_states()
    return states, None, undo


def _per_window_install(state, key: str, snap) -> None:
    """The window resume as it was before the install was paged: the
    clock and open windows, then one fold-table ``load`` a window."""
    import numpy as np

    from bytewax_tpu_torch.engine.window_accel import _to_us

    kid = int(state._key_ids_for([key])[0])
    state._load_clock(kid, snap)
    for wid, acc in snap.logic_states.items():
        state.agg.load(f"{key}\x00{wid}", acc)
    opened = snap.windower_state.opened
    if opened:
        state._open_windows(
            np.full(len(opened), kid, dtype=np.int64),
            np.fromiter(opened, dtype=np.int64, count=len(opened)),
            np.array([_to_us(meta.close_time) for meta in opened.values()]),
            np.array([state.agg.alloc(f"{key}\x00{wid}") for wid in opened]),
        )
    state._replay_queue(kid, snap)


def _recovery_windows(card: dict, root: Path, n: int, n_keys: int, launches: dict) -> list:
    """Phase 9.3: tumbling ``stats_window`` aborted mid-input and
    resumed; the closes against phase 6's oracle over the whole input.
    Then the window-state install of that resume, timed per window (the
    install before it was paged) and in pages, on a copy of the store
    taken at the abort."""
    import shutil
    from datetime import datetime, timedelta, timezone

    import numpy as np
    import torch

    import bytewax_tpu_torch.operators as op
    import bytewax_tpu_torch.operators.windowing as win
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.engine.flatten import flatten
    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore, loads
    from bytewax_tpu_torch.engine.window_accel import WindowAccelSpec
    from bytewax_tpu_torch.xla import column_ts

    ids_b, ts_b, deci_b = _window_data("tumbling", RECOVERY_WINDOW_BATCHES, n, n_keys, seed=42)
    vocab = np.array([f"station_{i:05d}" for i in range(n_keys)])
    batches = [
        ArrayBatch({"key_id": i, "ts": t, "value": d}, key_vocab=vocab, value_scale=0.1)
        for i, t, d in zip(ids_b, ts_b, deci_b)
    ]
    align = datetime.fromtimestamp(_T0_US / 1e6, tz=timezone.utc)
    source = _batch_source(batches, aborts=[RECOVERY_WINDOW_ABORT])
    down, late = [], []
    cuts = {}

    def flow_of():
        clock = win.EventClock(ts_getter=column_ts, wait_for_system_duration=timedelta(seconds=WINDOW_WAIT_S))
        windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
        flow = Dataflow("recovery_windows")
        s = op.input("inp", flow, source)
        wo = win.stats_window("w", s, clock, windower)
        for name, stream, rows in (("down", wo.down, down), ("late", wo.late, late)):
            keyed = op.map(f"{name}_all", stream, lambda kv: ("all", kv))
            sink = _truncating_sink(rows)
            cuts[name] = sink.cut
            op.output(name, keyed, sink)
        return flow

    db = _fresh_store(root, "windows")
    records = []
    flow = flow_of()
    line = _recovery_run(card, "windows", "abort", flow, db, {}, records, n * RECOVERY_WINDOW_ABORT)
    launches["windows"] = line["fold_launches"]
    shutil.copytree(db, root / "windows_at_abort")
    line = _recovery_run(card, "windows", "resume", flow_of(), db, {}, records,
                         n * (RECOVERY_WINDOW_BATCHES - RECOVERY_WINDOW_ABORT))
    launches["windows"] += line["fold_launches"]
    cut = cuts["down"][-1]

    ids = np.concatenate(ids_b)
    ts = np.concatenate(ts_b)
    vals = (np.concatenate(deci_b) * 0.1).astype(np.float32).astype(np.float64)
    late_rows = _late_oracle(ids, ts, WINDOW_WAIT_S * 1_000_000)
    ok = ~late_rows
    want = _window_oracle("tumbling", ids[ok], ts[ok], vals[ok], n_keys)
    if len(late) != int(late_rows.sum()):
        msg = f"recovery windows: {len(late)} late events, oracle {int(late_rows.sum())}"
        raise AssertionError(msg)
    got = {}
    for k, (wid, value) in down:
        if (int(k[8:]), wid) in got:
            msg = f"recovery windows: window {(k, wid)} closed twice"
            raise AssertionError(msg)
        got[(int(k[8:]), wid)] = value
    if set(got) != set(want):
        msg = f"recovery windows: {len(got)} windows out, {len(want)} expected"
        raise AssertionError(msg)
    worst = 0.0
    for kw, (mn, mean, mx, count, mean_abs) in want.items():
        gmn, gmean, gmx, gcount = got[kw]
        if (gmn, gmx, gcount) != (mn, mx, count):
            msg = f"recovery window {kw}: {got[kw]} != {want[kw]}"
            raise AssertionError(msg)
        worst = max(worst, _check_mean(gmean, mean, mean_abs, f"recovery window {kw}"))

    # The install alone, per window and paged, from the store at the abort.
    step = next(o for o in flatten(flow_of()).ops if isinstance(o.conf.get("_accel"), WindowAccelSpec))
    spec = step.conf["_accel"]
    store = RecoveryStore(root / "windows_at_abort")
    try:
        t0 = time.perf_counter()
        pairs = [(k, loads(ser)) for _s, k, ser in
                 store.iter_snaps(store.resume_from().resume_epoch, step_ids=[step.step_id])]
        read_s = time.perf_counter() - t0
    finally:
        store.close()
    timed = {}
    states = {}
    for how in ("per_window", "paged", "per_window", "paged"):
        state = spec.make_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "per_window":
            for key, snap in pairs:
                _per_window_install(state, key, snap)
        else:
            for i in range(0, len(pairs), RESUME_PAGE):
                state.load_many(pairs[i : i + RESUME_PAGE])
        torch.cuda.synchronize()
        timed.setdefault(how, []).append(time.perf_counter() - t0)
        states[how] = state
    keys = [k for k, _s in pairs]
    a, b = states["per_window"].snapshots_for(keys), states["paged"].snapshots_for(keys)
    for (key, sa), (_key, sb) in zip(a, b):
        same = (sa is None) == (sb is None) and (
            sa is None
            or sa.clock_state == sb.clock_state
            and {w: (m.open_time, m.close_time) for w, m in sa.windower_state.opened.items()}
            == {w: (m.open_time, m.close_time) for w, m in sb.windower_state.opened.items()}
            and sa.logic_states == sb.logic_states
        )
        if not same:
            msg = f"recovery windows: paged install of {key!r} differs from the per-window install"
            raise AssertionError(msg)
    windows = sum(len(s.logic_states) for _k, s in pairs)
    _emit(card, "recovery_check", path="windows", windows_closed=len(down), late_events=len(late),
          max_mean_rel_err=worst, rows_cut_on_resume=cut)
    _emit(card, "window_install", keys=len(pairs), windows=windows, read_unpickle_s=read_s,
          per_window_s=timed["per_window"], paged_s=timed["paged"], page_keys=RESUME_PAGE,
          snapshots_equal=True)
    return records


def phase_recovery(card: dict, n: int) -> dict:
    """Phase 9: recovery stores on the card (one temporary directory,
    removed at the end); returns each recovery path's launches of each
    kernel."""
    import tempfile

    fold, scan = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        root = Path(tmp)
        _recovery_brc(card, root, n, INGEST_STATIONS, fold)
        _recovery_windows(card, root, n, WINDOW_KEYS, fold)
        _recovery_anomaly(card, root, n, RECOVERY_ANOMALY_KEYS, scan)
    return {"fold": fold, "scan": scan}


# -- phase 10 ----------------------------------------------------------------

#: 1BRC text lines the cluster runs read, and the process counts.
CLUSTER_LINES = 1 << 23
CLUSTER_PROCS = (1, 2, 4)
#: The supervised crash: batches a partition (one epoch a batch), the
#: epoch that must be durable before process 1 is killed, and the
#: pause before each batch (so that the kill lands mid-run).
CRASH_PART_BATCHES = 16
CRASH_AFTER_EPOCH = 8
CRASH_PACE_S = 0.25
#: Seconds any one cluster command may take.
CLUSTER_TIMEOUT_S = 240

#: The flows of phase 10, one module that every cluster process
#: imports (``CLUSTER_FLOW`` picks one).  At exit each process writes a
#: JSON report into ``CLUSTER_REPORTS``: its proc id, its device, both
#: kernels' launches, step demotions, the ledger's phase seconds, the
#: seconds from its start to its import of the engine and to its first
#: fold and scan on the device, and whether it built a kernel.
CLUSTER_FLOW_MODULE = """
import atexit
import json
import os
import time


def _started() -> float:
    # The process's start, from its start time in clock ticks since
    # boot and the clock since boot now.
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


START = _started()

import numpy as np
import torch

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import _metrics, utils, xla
from bytewax_tpu_torch.connectors.files import DirSink
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine import flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition
from bytewax_tpu_torch.models.anomaly import anomaly_flow
from bytewax_tpu_torch.models.brc import BrcFileSource
from bytewax_tpu_torch.ops import bucket_kernel, fold_kernel, merge_kernel, scan_kernel
from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition
from bytewax_tpu_torch.parallel import mesh

IMPORTED = time.time()
FIRST = {}
#: When the dataflow's run ended (the scored sink's close); else the
#: report's own time.
ENDED = []
PROC = int(os.environ.get("BYTEWAX_PROCESS_ID", "0"))
WORK = os.environ["CLUSTER_WORK"]


def _first(name, fn):
    def timed(*args, **kwargs):
        out = fn(*args, **kwargs)
        if name not in FIRST:
            torch.cuda.synchronize()
            FIRST[name] = time.time()
        return out

    return timed


fold_kernel.fold = _first("fold", fold_kernel.fold)
scan_kernel.scan = _first("scan", scan_kernel.scan)
bucket_kernel.bucket = _first("bucket", bucket_kernel.bucket)
merge_kernel.merge = _first("merge", merge_kernel.merge)

#: Each supervised restart of this process: when, and each kernel's
#: launches so far (the launches after the last one are the restarted
#: run's).
RESTARTS = []
_note_restart = flight.note_restart


def _restarting(*args, **kwargs):
    RESTARTS.append({"at": time.time(), "fold": fold_kernel.launches, "scan": scan_kernel.launches,
                     "bucket": bucket_kernel.launches, "merge": merge_kernel.launches})
    return _note_restart(*args, **kwargs)


flight.note_restart = _restarting


def _report():
    demotions = sum(
        s.value
        for m in _metrics.step_demotion_count.collect()
        for s in m.samples
        if s.name.endswith("_total")
    )
    rep = {
        "proc_id": PROC,
        "pid": os.getpid(),
        "device": str(utils.device()),
        "fold_launches": fold_kernel.launches,
        "scan_launches": scan_kernel.launches,
        "demotions": demotions,
        "phase_seconds": dict(flight.RECORDER.phase_totals),
        "import_s": IMPORTED - START,
        "first_fold_s": FIRST["fold"] - START if "fold" in FIRST else None,
        "first_scan_s": FIRST["scan"] - START if "scan" in FIRST else None,
        "end_s": (ENDED[0] if ENDED else time.time()) - START,
        "built_a_kernel": bool(fold_kernel.build_log or scan_kernel.build_log
                               or bucket_kernel.build_log or merge_kernel.build_log),
        "bucket_launches": bucket_kernel.launches,
        "merge_launches": merge_kernel.launches,
        "first_merge_s": FIRST["merge"] - START if "merge" in FIRST else None,
        "first_batch_s": FIRST["batch"] - START if "batch" in FIRST else None,
        "transport": mesh.world().describe() if mesh.world() is not None else None,
        "restarts": RESTARTS,
        "counters": {k: v for k, v in flight.RECORDER.counters.items()
                     if k.startswith(("device_transfer_bytes", "gsync_"))},
    }
    path = os.path.join(os.environ["CLUSTER_REPORTS"], f"report-{PROC}-{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(rep, f)


atexit.register(_report)
with open(os.path.join(os.environ["CLUSTER_REPORTS"], f"started-{PROC}-{os.getpid()}"), "w"):
    pass


class _Paced(FixedPartitionedSource):
    # Another source's partitions, each batch at least pace_s after
    # the one before (through next_awake: the driver keeps running).
    def __init__(self, inner, pace_s):
        self.inner, self.pace_s = inner, pace_s

    def list_parts(self):
        return self.inner.list_parts()

    def build_part(self, step_id, for_part, resume_state):
        from datetime import datetime, timedelta, timezone

        part = self.inner.build_part(step_id, for_part, resume_state)
        nxt, awake = part.next_batch, [None]

        def paced():
            awake[0] = datetime.now(timezone.utc) + timedelta(seconds=self.pace_s)
            return nxt()

        part.next_batch = paced
        part.next_awake = lambda: awake[0]
        return part


def brc():
    parts = int(os.environ["CLUSTER_PARTS"])
    src = BrcFileSource(os.path.join(WORK, "measurements.txt"), part_count=parts,
                        chunk_bytes=int(os.environ["CLUSTER_CHUNK"]))
    pace = float(os.environ.get("CLUSTER_PACE_S", "0"))
    if pace:
        src = _Paced(src, pace)
    flow = Dataflow("cluster_brc")
    s = op.input("inp", flow, src)
    s = xla.stats_final("stats", s)
    s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]};{kv[1][0]!r};{kv[1][1]!r};{kv[1][2]!r};{kv[1][3]}"))
    op.output("out", s, DirSink(os.environ["CLUSTER_OUT"], file_count=parts))
    return flow


VOCAB = np.array([f"sensor_{i:07d}" for i in range(int(os.environ.get("CLUSTER_SENSORS", "1")))])


class _SensorPart(StatefulSourcePartition):
    # Partition p of the readings: each batch's rows of the sensors
    # whose id is p modulo 2, in their order.
    def __init__(self, p, at):
        self.p, self.at = p, at
        self.ids = np.load(os.path.join(WORK, "ids.npy"), mmap_mode="r")
        self.vals = np.load(os.path.join(WORK, "vals.npy"), mmap_mode="r")
        self.bounds = np.load(os.path.join(WORK, "bounds.npy"))

    def next_batch(self):
        if self.at >= len(self.bounds) - 1:
            raise StopIteration()
        lo, hi = self.bounds[self.at], self.bounds[self.at + 1]
        self.at += 1
        ids = np.asarray(self.ids[lo:hi])
        mine = ids % 2 == self.p
        return ArrayBatch({"key_id": ids[mine], "value": np.asarray(self.vals[lo:hi])[mine]}, key_vocab=VOCAB)

    def snapshot(self):
        return self.at


class SensorSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, for_part, resume_state):
        return _SensorPart(int(for_part[1:]), resume_state or 0)


class _Scored(StatelessSinkPartition):
    # Keeps the scored rows and writes them as columns at the end.
    def __init__(self, worker):
        self.worker, self.rows = worker, []

    def write_batch(self, items):
        self.rows.extend(items)

    def close(self):
        ENDED.append(time.time())
        n = len(self.rows)
        ids = np.fromiter((int(k[7:]) for k, _r in self.rows), dtype=np.int64, count=n)
        cols = [np.fromiter((r[j] for _k, r in self.rows), dtype=np.float64, count=n) for j in range(3)]
        np.save(os.path.join(os.environ["CLUSTER_OUT"], f"scored-{PROC}-{self.worker}.npy"), np.stack([ids, *cols]))


class ScoredSink(DynamicSink):
    def build(self, step_id, worker_index, worker_count):
        return _Scored(worker_index)


def anomaly():
    return anomaly_flow(SensorSource(), ScoredSink(), threshold=float(os.environ["CLUSTER_THRESHOLD"]))


STATIONS = np.array([f"station_{i:04d}" for i in range(int(os.environ.get("CLUSTER_STATIONS", "1")))])


class _BatchPart(StatefulSourcePartition):
    # Partition p of P of the columnar 1BRC batches: batches p, p + P, ...
    # (dictionary-encoded int16 stations and deci-degrees; scaled by
    # CLUSTER_SCALE, or integers where it is 0).  With CLUSTER_HOLD_CLOSES
    # set, one batch an epoch close of this process, and EOF only once it
    # closed that many epochs (a stalled run still ends after 120 s), so
    # that an epoch-pinned fault lands mid-run whatever the load.
    def __init__(self, p, parts, at):
        self.ids = np.load(os.path.join(WORK, "gbrc_ids.npy"), mmap_mode="r")
        self.deci = np.load(os.path.join(WORK, "gbrc_deci.npy"), mmap_mode="r")
        self.rows = int(os.environ["CLUSTER_BATCH_ROWS"])
        self.mine = list(range(p, len(self.ids) // self.rows, parts))
        self.scale = float(os.environ["CLUSTER_SCALE"]) or None
        self.at = at
        self.hold = int(os.environ.get("CLUSTER_HOLD_CLOSES", "0"))
        self.deadline = time.monotonic() + 120
        self.seen = None
        self.awake = None

    def next_awake(self):
        return self.awake

    def _held(self):
        if not self.hold or time.monotonic() > self.deadline:
            return False
        from datetime import datetime, timedelta, timezone

        closes = flight.RECORDER.counters.get("epoch_close_count", 0)
        if (self.seen is not None and closes <= self.seen) or (self.at >= len(self.mine) and closes < self.hold):
            self.awake = datetime.now(timezone.utc) + timedelta(milliseconds=5)
            return True
        self.awake, self.seen = None, closes
        return False

    def next_batch(self):
        FIRST.setdefault("batch", time.time())
        if self._held():
            return []
        if self.at >= len(self.mine):
            raise StopIteration()
        lo = self.mine[self.at] * self.rows
        self.at += 1
        cols = {"key_id": np.array(self.ids[lo : lo + self.rows]), "value": np.array(self.deci[lo : lo + self.rows])}
        return ArrayBatch(cols, key_vocab=STATIONS, value_scale=self.scale)

    def snapshot(self):
        return self.at


class BatchSource(FixedPartitionedSource):
    def __init__(self, parts):
        self.parts = parts

    def list_parts(self):
        return [f"p{i}" for i in range(self.parts)]

    def build_part(self, step_id, for_part, resume_state):
        return _BatchPart(int(for_part[1:]), self.parts, resume_state or 0)


def gbrc():
    parts = int(os.environ["CLUSTER_PARTS"])
    flow = Dataflow("global_brc")
    s = op.input("inp", flow, BatchSource(parts))
    s = xla.stats_final("stats", s)
    s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]};{kv[1][0]!r};{kv[1][1]!r};{kv[1][2]!r};{kv[1][3]}"))
    op.output("out", s, DirSink(os.environ["CLUSTER_OUT"], file_count=parts))
    return flow


flow = {"brc": brc, "anomaly": anomaly, "gbrc": gbrc}[os.environ["CLUSTER_FLOW"]]()
"""


def _cluster_env(work: Path, reports: Path, out: Path, **knobs) -> dict:
    """The environment of a cluster command: the checkout on the
    path, the card (never the CPU), and the flow module's settings."""
    env = dict(os.environ)
    env.pop("BYTEWAX_TPU_PLATFORM", None)
    env["PYTHONPATH"] = str(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(CLUSTER_WORK=str(work), CLUSTER_REPORTS=str(reports), CLUSTER_OUT=str(out))
    env.update({k: str(v) for k, v in knobs.items()})
    return env


def _fresh_dirs(work: Path, name: str):
    reports, out = work / f"{name}_reports", work / f"{name}_out"
    for d in (reports, out):
        d.mkdir()
    return reports, out


def _cluster_reports(reports: Path, name: str, procs: int, scan: bool = False,
                     own_checks: bool = False) -> list:
    """Every process's report; fails unless each of the ``procs``
    processes reported, ran on ``cuda:0``, launched the fold (and the
    scan, where ``scan``; neither is checked here where the caller makes
    ``own_checks`` of the launches), demoted no step and built no kernel
    (phase 1 built them)."""
    reps = [json.loads(p.read_text()) for p in sorted(reports.glob("report-*.json"))]
    if sorted({r["proc_id"] for r in reps}) != list(range(procs)):
        msg = f"{name}: reports from processes {[r['proc_id'] for r in reps]}, {procs} expected"
        raise AssertionError(msg)
    for r in reps:
        where = f"{name}, process {r['proc_id']} (pid {r['pid']})"
        if r["device"] != "cuda:0":
            msg = f"{where}: device {r['device']}, not cuda:0"
            raise AssertionError(msg)
        if r["fold_launches"] <= 0 and not scan and not own_checks:
            msg = f"{where}: the segment-fold kernel was launched no time"
            raise AssertionError(msg)
        if scan and not own_checks and r["scan_launches"] <= 0:
            msg = f"{where}: the segmented-scan kernel was launched no time"
            raise AssertionError(msg)
        if r["demotions"]:
            msg = f"{where}: {r['demotions']} steps demoted to the host tier"
            raise AssertionError(msg)
        if r["built_a_kernel"]:
            msg = f"{where}: built a kernel that phase 1 had built"
            raise AssertionError(msg)
    return reps


def _run_cluster_cmd(name: str, cmd: list, env: dict, cwd: Path):
    """Run one cluster command to its end; fails on a non-zero exit.
    Returns the wall seconds and the command's standard error."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True, text=True,
                         timeout=CLUSTER_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        msg = f"{name}: exit {res.returncode}\n{res.stderr[-3000:]}"
        raise AssertionError(msg)
    return seconds, res.stderr


def _brc_deci_oracle(stations, ids, deci) -> dict:
    """Per station: count, min and max deci-degrees, the mean and the
    mean |value|, from exact integer sums."""
    import numpy as np

    n = len(stations)
    counts = np.bincount(ids, minlength=n)
    sums = np.bincount(ids, weights=deci, minlength=n)
    abs_sums = np.bincount(ids, weights=np.abs(deci), minlength=n)
    mins = np.full(n, 10_000)
    maxs = np.full(n, -10_000)
    np.minimum.at(mins, ids, deci)
    np.maximum.at(maxs, ids, deci)
    return {
        str(stations[i]): (int(counts[i]), int(mins[i]), int(maxs[i]),
                           sums[i] / counts[i] / 10.0, abs_sums[i] / counts[i] / 10.0)
        for i in range(n)
        if counts[i]
    }


def _check_cluster_brc(name: str, out: Path, want: dict) -> float:
    """The union of the processes' files against the oracle: each
    station once, counts exact, min and max exact after rounding to
    one decimal, means within 1e-5 of the mean |value|."""
    got = {}
    for path in sorted(out.iterdir()):
        for line in path.read_text().splitlines():
            station, mn, mean, mx, count = line.split(";")
            if station in got:
                msg = f"{name}: station {station} emitted twice"
                raise AssertionError(msg)
            got[station] = (int(count), float(mn), float(mx), float(mean))
    if set(got) != set(want):
        msg = f"{name}: {len(got)} stations out, {len(want)} expected"
        raise AssertionError(msg)
    worst = 0.0
    for station, (count, mn, mx, mean, mean_abs) in want.items():
        gcount, gmn, gmx, gmean = got[station]
        if (gcount, round(gmn * 10), round(gmx * 10)) != (count, mn, mx):
            msg = f"{name}, {station}: {got[station]} against count {count}, min {mn}, max {mx} deci"
            raise AssertionError(msg)
        worst = max(worst, _check_mean(gmean, mean, mean_abs, f"{name}, {station}"))
    return worst


def _child_fields(reps: list) -> dict:
    return {
        "children": [
            {k: r[k] for k in ("proc_id", "device", "fold_launches", "scan_launches",
                               "import_s", "first_fold_s", "first_scan_s", "end_s", "phase_seconds")}
            for r in sorted(reps, key=lambda r: r["proc_id"])
        ],
        "startup_s": [r["first_fold_s"] if r["first_fold_s"] is not None else r["first_scan_s"]
                      for r in sorted(reps, key=lambda r: r["proc_id"])],
    }


def _after_startup(reps: list) -> float:
    """Seconds from the latest first device call to the latest end of
    run, each counted from its own process's start (the children start
    together)."""
    first = max(r["first_fold_s"] or r["first_scan_s"] for r in reps)
    return max(r["end_s"] for r in reps) - first


def _cluster_brc(card: dict, work: Path, want: dict, n: int, size: int) -> dict:
    """1BRC text through the CLI (one process) and through the
    localhost spawner (2 and 4 processes on the one card); returns the
    fold launches of each run."""
    launches = {}
    flow_py = work / "cluster_flows.py"
    for procs in CLUSTER_PROCS:
        name = f"cluster_brc_p{procs}"
        reports, out = _fresh_dirs(work, name)
        env = _cluster_env(work, reports, out, CLUSTER_FLOW="brc", CLUSTER_PARTS=procs,
                           CLUSTER_CHUNK=16 << 20)
        if procs == 1:
            cmd = [sys.executable, "-m", "bytewax_tpu_torch.run", f"{flow_py}:flow"]
        else:
            cmd = [sys.executable, "-m", "bytewax_tpu_torch.testing", f"{flow_py}:flow",
                   "-p", str(procs)]
        seconds, _err = _run_cluster_cmd(name, cmd, env, work)
        reps = _cluster_reports(reports, name, procs)
        worst = _check_cluster_brc(name, out, want)
        launches[name] = sum(r["fold_launches"] for r in reps)
        _emit(
            card,
            "cluster",
            run=name,
            entry="python -m bytewax_tpu_torch.run" if procs == 1
            else f"python -m bytewax_tpu_torch.testing -p {procs}",
            processes=procs,
            lines=n,
            file_bytes=size,
            stations=len(want),
            seconds=seconds,
            lines_per_s=n / seconds,
            # Once every process has folded once, to the last one's end.
            lines_per_s_after_startup=n / _after_startup(reps),
            fold_launches=launches[name],
            fold_launches_by_process=[r["fold_launches"] for r in sorted(reps, key=lambda r: r["proc_id"])],
            max_mean_rel_err=worst,
            cpu_count=os.cpu_count(),
            **_child_fields(reps),
        )
    return launches


def _cluster_anomaly(card: dict, work: Path) -> int:
    """``anomaly_flow`` over 8·2^20 readings of 10,000 sensors on a
    2-process cluster: partition p reads the sensors whose id is p
    modulo 2, and keyed routing sends about half of each to the other
    process; returns the scan launches."""
    import numpy as np

    data = _anomaly_data(ANOMALY_BATCHES, SCAN_ROWS, SCAN_KEYS, seed=20)
    np.save(work / "ids.npy", np.concatenate(data["ids_b"]))
    np.save(work / "vals.npy", np.concatenate(data["vals_b"]))
    np.save(work / "bounds.npy", np.cumsum([0] + [len(b) for b in data["ids_b"]]))
    name = "cluster_anomaly_p2"
    reports, out = _fresh_dirs(work, name)
    env = _cluster_env(work, reports, out, CLUSTER_FLOW="anomaly", CLUSTER_SENSORS=SCAN_KEYS,
                       CLUSTER_THRESHOLD=THRESHOLD)
    cmd = [sys.executable, "-m", "bytewax_tpu_torch.testing", f"{work / 'cluster_flows.py'}:flow",
           "-p", "2"]
    seconds, _err = _run_cluster_cmd(name, cmd, env, work)
    reps = _cluster_reports(reports, name, 2, scan=True)
    parts = [np.load(p) for p in sorted(out.glob("scored-*.npy"))]
    scored = np.concatenate(parts, axis=1)
    rows = SCAN_ROWS * ANOMALY_BATCHES
    checked = _check_scored_cols(name, scored[0].astype(np.int64), list(scored[1:]), data,
                                 slice(0, rows), "zscore")
    launches = sum(r["scan_launches"] for r in reps)
    _emit(
        card,
        "cluster",
        run=name,
        entry="python -m bytewax_tpu_torch.testing -p 2",
        flow="anomaly_flow",
        processes=2,
        rows=rows,
        sensors=SCAN_KEYS,
        seconds=seconds,
        rows_per_s=rows / seconds,
        rows_per_s_after_startup=rows / _after_startup(reps),
        scan_launches=launches,
        scan_launches_by_process=[r["scan_launches"] for r in sorted(reps, key=lambda r: r["proc_id"])],
        cpu_count=os.cpu_count(),
        **checked,
        **_child_fields(reps),
    )
    return launches


def _fronts(db: Path, worker: int):
    """``(ex_num, epoch, resume_epoch)`` rows of one worker's frontier
    in a recovery store: the epoch after its last durable close in
    each execution.  Read-only; a busy store reads as nothing yet."""
    import sqlite3

    rows = []
    for part in sorted(db.glob("part-*.sqlite3")):
        try:
            con = sqlite3.connect(f"file:{part}?mode=ro", uri=True, timeout=0.5)
            try:
                rows += con.execute(
                    "SELECT f.ex_num, f.epoch, e.resume_epoch FROM fronts f JOIN exs e "
                    "ON e.ex_num = f.ex_num AND e.worker_index = f.worker_index "
                    "WHERE f.worker_index = ?",
                    (worker,),
                ).fetchall()
            finally:
                con.close()
        except sqlite3.OperationalError:
            pass
    return rows


def _cluster_crash(card: dict, work: Path, want: dict, size: int) -> int:
    """1BRC with a recovery store under the supervisor (``run
    --autoscale 2:2``), one epoch a batch: SIGKILL process 1 once epoch
    ``CRASH_AFTER_EPOCH`` is durable; the supervisor relaunches it and
    the output, through a sink that cuts back to its snapshot, must
    equal the oracle with each station once.  Returns the fold
    launches of the processes that reported."""
    import signal

    name = "cluster_brc_supervised_crash"
    reports, out = _fresh_dirs(work, name)
    db = work / "crash_db"
    db.mkdir()
    chunk = -(-size // (2 * CRASH_PART_BATCHES))
    env = _cluster_env(work, reports, out, CLUSTER_FLOW="brc", CLUSTER_PARTS=2, CLUSTER_CHUNK=chunk,
                       CLUSTER_PACE_S=CRASH_PACE_S, BYTEWAX_TPU_INGEST_TARGET_ROWS=0)
    subprocess.run([sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
                   env=env, check=True, timeout=120)
    cmd = [sys.executable, "-m", "bytewax_tpu_torch.run", f"{work / 'cluster_flows.py'}:flow",
           "--autoscale", "2:2", "-r", str(db), "-s", "0", "-b", "0"]
    t0 = time.perf_counter()
    sup = subprocess.Popen(cmd, env=env, cwd=work, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, start_new_session=True)
    try:
        deadline = time.monotonic() + CLUSTER_TIMEOUT_S
        while True:
            if sup.poll() is not None:
                msg = f"{name}: the supervisor ended (exit {sup.returncode}) before the kill"
                raise AssertionError(msg)
            if time.monotonic() > deadline:
                msg = f"{name}: epoch {CRASH_AFTER_EPOCH} was never durable"
                raise AssertionError(msg)
            fronts = _fronts(db, 1)
            if fronts and max(f[1] for f in fronts) > CRASH_AFTER_EPOCH:
                break
            time.sleep(0.02)
        victims = [p.name.split("-")[2] for p in reports.glob("started-1-*")]
        if len(victims) != 1:
            msg = f"{name}: {len(victims)} processes with id 1 started before the kill"
            raise AssertionError(msg)
        ex_at_kill = max(f[0] for f in fronts)
        epoch_at_kill = max(f[1] for f in fronts) - 1
        os.kill(int(victims[0]), signal.SIGKILL)
        killed = time.perf_counter()
        recovered = None
        while recovered is None:
            if time.monotonic() > deadline:
                msg = f"{name}: process 1 never committed an epoch after the kill"
                raise AssertionError(msg)
            if any(ex > ex_at_kill and epoch > resume for ex, epoch, resume in _fronts(db, 1)):
                recovered = time.perf_counter()
            elif sup.poll() is not None:
                break
            else:
                time.sleep(0.01)
        stdout, stderr = sup.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
            sup.wait()
    seconds = time.perf_counter() - t0
    if sup.returncode != 0:
        msg = f"{name}: the supervisor exited {sup.returncode}\n{stderr[-3000:]}"
        raise AssertionError(msg)
    if recovered is None:
        msg = f"{name}: the run ended with no epoch committed by the relaunched process"
        raise AssertionError(msg)
    relaunched = [p for p in reports.glob("started-1-*") if p.name.split("-")[2] != victims[0]]
    if len(relaunched) != 1:
        msg = f"{name}: {len(relaunched)} relaunches of process 1"
        raise AssertionError(msg)
    worst = _check_cluster_brc(name, out, want)
    # The killed process wrote no report; the survivor and the
    # relaunched process did.
    reps = _cluster_reports(reports, name, 2)
    launches = sum(r["fold_launches"] for r in reps)
    _emit(
        card,
        "cluster",
        run=name,
        entry="python -m bytewax_tpu_torch.run --autoscale 2:2 -r db -s 0 -b 0",
        processes=2,
        lines=sum(w[0] for w in want.values()),
        batches_per_partition=CRASH_PART_BATCHES,
        pace_s=CRASH_PACE_S,
        killed_after_epoch=epoch_at_kill,
        seconds=seconds,
        time_to_recover_s=recovered - killed,
        fold_launches=launches,
        max_mean_rel_err=worst,
        exactly_once=True,
        supervisor_relaunches=stderr.count("relaunch"),
        **_child_fields(reps),
    )
    return launches


def phase_cluster(card: dict) -> dict:
    """Phase 10: clusters of processes on the one card (one temporary
    directory, removed at the end); returns each run's launches of
    each kernel."""
    import tempfile

    fold, scan = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as tmp:
        work = Path(tmp)
        (work / "cluster_flows.py").write_text(CLUSTER_FLOW_MODULE)
        path = work / "measurements.txt"
        stations, ids, deci = _brc_text(str(path), CLUSTER_LINES, INGEST_STATIONS, seed=7)
        want = _brc_deci_oracle(stations, ids, deci)
        size = path.stat().st_size
        fold.update(_cluster_brc(card, work, want, CLUSTER_LINES, size))
        scan["cluster_anomaly_p2"] = _cluster_anomaly(card, work)
        fold["cluster_brc_supervised_crash"] = _cluster_crash(card, work, want, size)
    return {"fold": fold, "scan": scan}


# -- phase 11 ----------------------------------------------------------------


#: Shards of the sharded tier's flows, and of the kernel's main shape.
SHARDS = 4
SHARD_COUNTS = (2, 4, 8)
SHARD_KERNEL_ROWS = 1 << 20
SHARD_DISTS = ("uniform_10000", "uniform_2^20", "hot_half")
SHARD_BRC_BATCHES = 8
SHARD_WINDOW_BATCHES = 8
#: The shard-bucketing kernel's one launch (a template: one name for
#: its instances), as the profiler lists it.
BUCKET_KERNELS = ("bucket_onepass",)
#: Edge cases of the exact check: (shards, source blocks, rows a
#: block): one shard, 64 shards, no rows, one row, rows that are no
#: multiple of the 4,096-row chunk, and 2^24 rows in one block (4,096
#: chunks, more than the card's blocks hold at once).
SHARD_EDGES = ((1, 1, 1 << 20), (64, 4, 1 << 18), (4, 2, 0), (4, 2, 1), (8, 3, 100_003), (4, 1, 1 << 24))


def _bucket_inputs(dist: str, n: int, n_shards: int, seed: int, padded: bool = True):
    """Wire key ids and float32 values of one batch cut into
    ``n_shards`` source blocks on the card, with the valid mask (a
    padded tail, as the sharded states send); keys uniform over 10,000
    or 2^20, or one key on half the rows."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    span = 1 << 20 if dist == "uniform_2^20" else 10_000
    keys = rng.randint(0, span, size=n).astype(np.int32)
    if dist == "hot_half":
        keys[rng.rand(n) < 0.5] = 4321
    vals = rng.randn(n).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    if padded:
        valid[n - n // 16 :] = False
    r = n // n_shards
    lanes = [
        torch.from_numpy(keys).to(DEV).view(n_shards, r),
        torch.from_numpy(vals).to(DEV).view(torch.int32).view(n_shards, r),
    ]
    return lanes, torch.from_numpy(valid).to(DEV).view(n_shards, r)


def _bucket_edge_inputs(n_blocks: int, rows: int, seed: int):
    """Wire key ids over 10,000 and raw 32-bit values in ``n_blocks``
    source blocks of ``rows`` rows on the card, a tenth of them
    padding."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 10_000, size=(n_blocks, rows)).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31, size=(n_blocks, rows), dtype=np.int64).astype(np.int32)
    valid = rng.rand(n_blocks, rows) < 0.9
    return [torch.from_numpy(keys).to(DEV), torch.from_numpy(vals).to(DEV)], torch.from_numpy(valid).to(DEV)


def _bucket_same(got, want, what: str) -> int:
    """Exact agreement of a bucket call with its plain version; returns
    the worst difference (0)."""
    import torch

    torch.cuda.synchronize()
    worst = 0
    for g, w, part in zip(got, want, ("buckets", "counts", "dropped")):
        if g.shape != w.shape:
            msg = f"shard_bucket {what}: {part} {tuple(g.shape)} != {tuple(w.shape)}"
            raise AssertionError(msg)
        worst = max(worst, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    if worst != 0:
        msg = f"shard_bucket {what}: differs by {worst}"
        raise AssertionError(msg)
    return worst


def _bucket_edges(exchange) -> dict:
    """The edge cases, then back-to-back calls of different shapes with
    no sync between them and one call replayed in a CUDA graph (the
    status words need no reset between calls), then the cluster-wide
    exchange's peer-major layout; every result exactly the plain
    version's."""
    import torch

    cases = 0
    for i, (n_shards, n_blocks, rows) in enumerate(SHARD_EDGES):
        lanes, valid = _bucket_edge_inputs(n_blocks, rows, seed=60 + i)
        _o, raw, _d = exchange.bucket_blocks_plain(lanes[:1], n_shards, max(1, rows), valid=valid)
        top = max(1, int(raw.max()))
        for capacity in (top, max(1, top // 2)):
            for flags in (exchange.DECODE, exchange.DECODE | exchange.POS):
                kw = dict(valid=valid, flags=flags, pad0=(1 << 20) - 1, pos_base=5, pos_pad=-1)
                got = exchange.bucket_blocks(lanes, n_shards, capacity, **kw)
                want = exchange.bucket_blocks_plain(lanes, n_shards, capacity, **kw)
                _bucket_same(got, want, f"{n_shards} shards, {n_blocks}x{rows} rows, cap {capacity}")
                cases += 1
    issued = []
    for i, (n_shards, n_blocks, rows) in enumerate(((4, 4, 1 << 18), (64, 2, 5000), (4, 4, 1 << 18), (2, 1, 3))):
        lanes, valid = _bucket_edge_inputs(n_blocks, rows, seed=70 + i)
        kw = dict(valid=valid, flags=exchange.DECODE | exchange.POS, pad0=7, pos_pad=-1)
        cap = max(1, rows // n_shards)
        issued.append((lanes, n_shards, cap, kw, exchange.bucket_blocks(lanes, n_shards, cap, **kw)))
    for lanes, n_shards, cap, kw, got in issued:
        _bucket_same(got, exchange.bucket_blocks_plain(lanes, n_shards, cap, **kw), "back to back")
    lanes, valid = _bucket_edge_inputs(4, 1 << 18, seed=80)
    kw = dict(valid=valid, flags=exchange.DECODE, pad0=9)
    want = exchange.bucket_blocks_plain(lanes, 4, 1 << 17, **kw)
    exchange.bucket_blocks(lanes, 4, 1 << 17, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = exchange.bucket_blocks(lanes, 4, 1 << 17, **kw)
    for _ in range(3):
        for g in got:
            g.fill_(-123)
        graph.replay()
        _bucket_same(got, want, "graph replay")
    for procs, local in ((2, 1), (2, 4), (8, 8)):
        lanes, valid = _bucket_edge_inputs(local, 50_000, seed=90 + procs)
        kw = dict(valid=valid, flags=exchange.DECODE | exchange.POS, pad0=-1, pos_pad=-2)
        cap = 50_000 // (procs * local) + 200
        got = exchange.bucket_blocks(lanes, procs * local, cap, peers=procs, **kw)
        _bucket_same(got, exchange.bucket_blocks_plain(lanes, procs * local, cap, peers=procs, **kw), "peer-major")
        flat = exchange.bucket_blocks(lanes, procs * local, cap, **kw)[0]
        old = flat.view(flat.shape[0], procs, local, local, cap).transpose(0, 1).contiguous()
        if not torch.equal(got[0], old):
            msg = f"shard_bucket peer-major {procs}x{local}: not the old transpose"
            raise AssertionError(msg)
    return {"edge_cases": cases, "back_to_back_calls": len(issued), "graph_replays": 3,
            "peer_major_cases": 3}


def _bucket_bound_ms(lanes, valid, n_out: int, n_shards: int, capacity: int) -> float:
    """Bytes over the card's memory rate: every lane and the mask read
    once, every output position, count and drop written once."""
    blocks = lanes[0].shape[0]
    read = sum(lane.numel() * 4 for lane in lanes) + valid.numel()
    written = (n_out * n_shards * capacity + n_shards + 1) * blocks * 4
    return (read + written) / HBM_BYTES_PER_S * 1e3


def phase_shard_kernel(card: dict, n: int) -> dict:
    """Phase 11 (a): hold the shard-bucketing kernel against its plain
    version on the card, exactly: 2^20 rows in 2, 4 and 8 source blocks
    and shards, keys uniform over 10,000 and 2^20 and one hot key on
    half the rows, a capacity at the true bucket maximum and at half of
    it (rows dropped), the fold's lanes and the scan's (with the
    position lane); then the edge cases, back-to-back calls, a CUDA
    graph's replays and the peer-major layout (:func:`_bucket_edges`);
    then time it at the sharded flows' shapes."""
    import math

    import numpy as np
    import torch

    from bytewax_tpu_torch.parallel import exchange

    cases = 0
    worst = 0
    for n_shards in SHARD_COUNTS:
        for i, dist in enumerate(SHARD_DISTS):
            lanes, valid = _bucket_inputs(dist, n, n_shards, seed=30 + i)
            _o, counts, _d = exchange.bucket_blocks_plain(lanes[:1], n_shards, n // n_shards, valid=valid)
            top = int(counts.max())
            for capacity in (top, top // 2):
                for flags in (exchange.DECODE, exchange.DECODE | exchange.POS):
                    kw = dict(valid=valid, flags=flags, pad0=(1 << 20) - 1, pos_pad=n)
                    got = exchange.bucket_blocks(lanes, n_shards, capacity, **kw)
                    want = exchange.bucket_blocks_plain(lanes, n_shards, capacity, **kw)
                    worst = max(worst, _bucket_same(got, want, f"{dist}/{n_shards}/cap {capacity}"))
                    if (int(got[2].sum()) > 0) != (capacity < top):
                        msg = f"shard_bucket {dist}/{n_shards}: dropped {got[2].tolist()} at cap {capacity}"
                        raise AssertionError(msg)
                    cases += 1
    edges = _bucket_edges(exchange)
    _emit(card, "shard_kernel", rows=n, cases=cases, shards=list(SHARD_COUNTS),
          dists=list(SHARD_DISTS), edges=[list(e) for e in SHARD_EDGES], max_abs_err=worst, **edges)

    times = {}
    for label, n_keys, flags in (
        ("brc_10000", 10_000, exchange.DECODE),
        ("anomaly_10000", 10_000, exchange.DECODE | exchange.POS),
    ):
        lanes, valid = _bucket_inputs("uniform_10000", n, SHARDS, seed=40, padded=False)
        keys = lanes[0].reshape(-1).cpu().numpy()
        r = n // SHARDS
        pairs = np.bincount((np.arange(n) // r) * SHARDS + keys % SHARDS, minlength=SHARDS * SHARDS)
        capacity = 1 << max(4, math.ceil(math.log2(int(pairs.max()))))
        kw = dict(valid=valid, flags=flags, pad0=(1 << 20) - 1, pos_pad=n)

        def call(lanes=lanes, capacity=capacity, kw=kw):
            exchange.bucket_blocks(lanes, SHARDS, capacity, **kw)

        def plain(lanes=lanes, capacity=capacity, kw=kw):
            exchange.bucket_blocks_plain(lanes, SHARDS, capacity, **kw)

        prof = _profiled(call, 200, names=BUCKET_KERNELS)
        # Passes a call from the host side (exact; the device trace can
        # drop a few launches): a call launches nothing but the kernel.
        passes = prof["host_launches_per_call"]
        if passes > 2:
            msg = f"shard_bucket {label}: {passes} passes a call (at most 2)"
            raise AssertionError(msg)
        ms = None if prof["ms"] is None else prof["ms"] * passes
        n_out = 3 if flags & exchange.POS else 2
        t = {
            "ms": ms,
            "passes_per_call": passes,
            "graph_ms": _graph_ms(call),
            "host_us": _host_us(call, 200),
            "plain_ms": _time_ms(plain, 20),
            "bound_ms": _bucket_bound_ms(lanes, valid, n_out, SHARDS, capacity),
            "bound_by": "bytes",
            "library_ms": None,
        }
        times[label] = t
        _emit(card, "shard_kernel_time", shape=label, rows=n, shards=SHARDS, keys=n_keys,
              capacity=capacity, lanes_out=n_out, host_launches_per_call=prof["host_launches_per_call"], **t)
    return {"max_abs_err": worst, "times": times}


class _Tier:
    """The environment of one tier of a phase-11 run: ``sharded`` over
    ``SHARDS`` shards of ``cuda:0`` (``mesh="cuda:0"``) or over every
    card (``mesh="cards"``), or ``single`` (``BYTEWAX_TPU_SHARD=0``)."""

    NAMES = ("BYTEWAX_TPU_SHARD", "BYTEWAX_TPU_VIRTUAL_DEVICES")

    def __init__(self, tier: str, mesh: str):
        self.tier, self.mesh = tier, mesh

    def __enter__(self):
        self.saved = {name: os.environ.get(name) for name in self.NAMES}
        os.environ.pop("BYTEWAX_TPU_VIRTUAL_DEVICES", None)
        if self.tier == "single":
            os.environ["BYTEWAX_TPU_SHARD"] = "0"
        elif self.mesh == "cards":
            os.environ["BYTEWAX_TPU_SHARD"] = "auto"
        else:
            os.environ["BYTEWAX_TPU_SHARD"] = str(SHARDS)
            os.environ["BYTEWAX_TPU_VIRTUAL_DEVICES"] = str(SHARDS)
        return self

    def __exit__(self, *exc):
        for name, value in self.saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _check_tier(name: str, tier: str, state, run: dict, scan: bool) -> None:
    """The state a run built is the tier's, on the card, and the run
    went through the kernels of its path."""
    sharded = type(state).__name__.startswith("Sharded")
    if sharded != (tier == "sharded"):
        msg = f"{name}/{tier}: built {type(state).__name__}"
        raise AssertionError(msg)
    devices = state.mesh.devices if sharded else [state.device]
    if any(d.type != DEV for d in devices):
        msg = f"{name}/{tier}: state on {devices}"
        raise AssertionError(msg)
    if sharded and state.n_shards != len(devices):
        raise AssertionError(f"{name}: {state.n_shards} shards on {devices}")
    main = run["scan_launches"] if scan else run["launches"]
    if main <= 0:
        kernel = "segment_scan" if scan else "segment_fold"
        raise AssertionError(f"{name}/{tier}: {kernel} was launched no time")
    if (run["bucket_launches"] > 0) != sharded:
        msg = f"{name}/{tier}: shard_bucket launched {run['bucket_launches']} times"
        raise AssertionError(msg)


def _sizing_timer():
    """Time ``_ShardedSlots._sizing`` (the host's per-batch bucket
    sizing: a bincount over (block, destination) pairs); returns the
    timer and the undo function."""
    from bytewax_tpu_torch.engine.sharded_state import _ShardedSlots

    orig = _ShardedSlots._sizing
    timer = _Timed(_ShardedSlots, "_sizing")

    def undo():
        _ShardedSlots._sizing = orig

    return timer, undo


def _shard_record(card: dict, name: str, mesh: str, rows: int, runs: dict, **extra) -> dict:
    """Emit one ``sharded`` line for a flow run on both tiers; returns
    the sharded run's launches of each kernel."""
    sh, one = runs["sharded"], runs["single"]
    launches = {
        "segment_fold": sh["launches"],
        "segment_scan": sh["scan_launches"],
        "shard_bucket": sh["bucket_launches"],
    }
    state = sh["state"]
    _emit(
        card,
        "sharded",
        flow=name,
        mesh=[str(d) for d in state.mesh.devices],
        rows=rows,
        rows_per_s=rows / sh["seconds"],
        single_rows_per_s=rows / one["seconds"],
        seconds=sh["seconds"],
        single_seconds=one["seconds"],
        launches=launches,
        single_launches={"segment_fold": one["launches"], "segment_scan": one["scan_launches"]},
        sizing_seconds=sh["sizing"]["seconds"],
        sizing_calls=sh["sizing"]["calls"],
        table_capacity=state.capacity,
        cap_per_shard=state.cap_per_shard,
        phase_seconds=sh["phase_seconds"],
        single_phase_seconds=one["phase_seconds"],
        **extra,
    )
    return launches


def _shard_brc(card: dict, name: str, mesh: str, batches, n_stations: int) -> dict:
    """``brc_flow_columnar`` over ``batches`` on both tiers, each
    against the exact oracle and the two against each other."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow_columnar
    from bytewax_tpu_torch.testing import TestingSink

    want = _reference(batches, n_stations)
    runs, outs = {}, {}
    for tier in ("sharded", "single"):
        out = []
        demoted_before = _demotions()
        flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
        states, _timers, undo = _recording_states()
        timer, undo_timer = _sizing_timer()
        try:
            with _Tier(tier, mesh):
                run = _run_flow(flow)
        finally:
            undo()
            undo_timer()
        if _demotions() != demoted_before:
            raise AssertionError(f"{name}/{tier}: a step demoted to the host tier")
        if len(states) != 1:
            raise AssertionError(f"{name}/{tier}: {len(states)} states")
        _check_tier(name, tier, states[0], run, scan=False)
        worst = _check_brc(out, want, f"{name}/{tier}")
        sizing = {"seconds": timer.seconds, "calls": timer.calls}
        runs[tier] = dict(run, state=states[0], sizing=sizing, worst=worst)
        outs[tier] = out
    _check_same_brc(outs["sharded"], outs["single"], f"{name}: sharded against single")
    rows = sum(len(b) for b in batches)
    return _shard_record(card, name, mesh, rows, runs, stations=n_stations, batches=len(batches),
                         max_abs_mean_err=runs["sharded"]["worst"])


def _shard_windows(card: dict, mesh: str, n: int, n_keys: int) -> dict:
    """Tumbling ``stats_window`` (phase 6's data) on both tiers, each
    against the oracle and the two against each other."""
    runs = {}
    for tier in ("sharded", "single"):
        demoted_before = _demotions()
        timer, undo_timer = _sizing_timer()
        try:
            with _Tier(tier, mesh):
                run = _window_case(card, "tumbling", SHARD_WINDOW_BATCHES, n, n_keys, seed=10,
                                   phase=f"sharded_windows_{tier}")
        finally:
            undo_timer()
        if _demotions() != demoted_before:
            raise AssertionError(f"stats_window/{tier}: a step demoted to the host tier")
        _check_tier("stats_window", tier, run["state"], run, scan=False)
        runs[tier] = dict(run, sizing={"seconds": timer.seconds, "calls": timer.calls})
    got, other, want = runs["sharded"]["got"], runs["single"]["got"], runs["sharded"]["want"]
    if set(got) != set(other):
        raise AssertionError("stats_window: the tiers closed different windows")
    worst = 0.0
    for kw, (mn, mean, mx, count) in got.items():
        omn, omean, omx, ocount = other[kw]
        if (mn, mx, count) != (omn, omx, ocount):
            raise AssertionError(f"stats_window {kw}: {got[kw]} sharded, {other[kw]} single")
        worst = max(worst, _check_mean(mean, omean, want[kw][4], f"stats_window {kw} sharded/single"))
    return _shard_record(card, "stats_window", mesh, SHARD_WINDOW_BATCHES * n, runs,
                         windows_closed=len(got), max_mean_rel_err_between_tiers=worst)


def _shard_anomaly(card: dict, mesh: str, n: int, n_keys: int) -> dict:
    """``anomaly_flow`` (phase 8's 10,000 sensors) on both tiers, each
    against the oracle and the two against each other (values exact,
    z within ``Z_RTOL`` of max(1, |z|), flags equal)."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.anomaly import anomaly_flow
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    data = _anomaly_data(ANOMALY_BATCHES, n, n_keys, seed=20)
    vocab = np.array([f"sensor_{i:07d}" for i in range(n_keys)])
    index = {k: i for i, k in enumerate(vocab.tolist())}
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab)
               for i, v in zip(data["ids_b"], data["vals_b"])]
    rows = slice(0, n * ANOMALY_BATCHES)
    runs = {}
    for tier in ("sharded", "single"):
        with _Tier(tier, mesh):
            run = _scan_flow_case(
                card, "anomaly_flow",
                lambda sink: anomaly_flow(ArrayBatchSource(batches), sink, threshold=THRESHOLD),
                data, "zscore", rows, index, phase=f"sharded_anomaly_{tier}",
            )
        _check_tier("anomaly_flow", tier, run["state"], run, scan=True)
        # _scan_flow_case timed the sizing among its splits.
        split = run["split"]
        sizing = {"seconds": split["seconds"].get("sizing", 0.0), "calls": split["calls"].get("sizing", 0)}
        runs[tier] = dict(run, sizing=sizing)
    split = runs["sharded"]["split"]
    a_ids, a = _out_columns(runs["sharded"]["out"], index, 3)
    b_ids, b = _out_columns(runs["single"]["out"], index, 3)
    if not (np.array_equal(a_ids, b_ids) and np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])):
        raise AssertionError("anomaly_flow: the tiers emitted other rows or flags")
    z_err = float((np.abs(a[1] - b[1]) / np.maximum(1.0, np.abs(b[1]))).max())
    if not z_err <= Z_RTOL:
        raise AssertionError(f"anomaly_flow: z differs between the tiers by {z_err}")
    return _shard_record(card, "anomaly_flow", mesh, n * ANOMALY_BATCHES, runs, sensors=n_keys,
                         max_z_err_between_tiers=z_err, sharded_split_seconds=split["seconds"])


def _shard_flows(card: dict, mesh: str) -> dict:
    """Phase 11 (b): the sharded tier's flows on ``mesh``; returns each
    flow's launches of each kernel."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import generate_batches

    out = {}
    n_stations = INGEST_STATIONS
    batches = generate_batches(SHARD_BRC_BATCHES * BATCH_ROWS, BATCH_ROWS, n_stations, seed=0)
    out["brc_flow_columnar"] = _shard_brc(card, "brc_flow_columnar", mesh, batches, n_stations)
    rng = np.random.RandomState(50)
    ids = rng.randint(0, n_stations, size=BATCH_ROWS).astype(np.int16)
    ids[rng.rand(BATCH_ROWS) < 0.5] = 4321 % n_stations
    deci = np.clip(np.round(rng.randn(BATCH_ROWS) * 100 + 120), -999, 999).astype(np.int16)
    hot = [ArrayBatch({"key_id": ids, "value": deci}, key_vocab=batches[0].key_vocab, value_scale=0.1)]
    out["brc_hot_key"] = _shard_brc(card, "brc_hot_key", mesh, hot, n_stations)
    out["stats_window"] = _shard_windows(card, mesh, WINDOW_BATCH_ROWS, WINDOW_KEYS)
    out["anomaly_flow"] = _shard_anomaly(card, mesh, SCAN_ROWS, SCAN_KEYS)
    return out


def phase_sharded(card: dict) -> dict:
    """Phase 11: the shard-bucketing kernel against its plain version,
    timed; the sharded tier's flows on 4 shards of ``cuda:0``, each on
    both tiers; and again over every card where there is more than one
    (else one line saying so).  Returns the kernel check and each
    run's launches of each kernel."""
    import torch

    check = phase_shard_kernel(card, SHARD_KERNEL_ROWS)
    launches = {f"sharded_{name}": v for name, v in _shard_flows(card, "cuda:0").items()}
    if torch.cuda.device_count() > 1:
        launches.update({f"sharded_cards_{k}": v for k, v in _shard_flows(card, "cards").items()})
    else:
        _emit(card, "sharded_cards", reached=False,
              reason="one card: torch.cuda.device_count() == 1, so no mesh of distinct cards")
    return dict(check, launches=launches)


# -- phase 12 ----------------------------------------------------------------


#: The merge kernel's frames: (padded length, real rows) at 2 and 4
#: shards of 4,095 keys, and a frame of one row.
MERGE_FRAMES = ((8192, 8190), (16384, 16380), (8192, 1))
MERGE_OPS = ("add", "min", "max")
MERGE_ENCS = ("raw", "int8", "bf16")
MERGE_DTYPES = ("int32", "float32")
#: The merge kernel's name, as the profiler lists it.
MERGE_KERNEL = ("merge_round",)
#: Fields of the bit-exact round cases: (op, encoding, table dtype) a
#: field; a stats round as the tier ships it quantized and exact, and a
#: mix of every encoding.
MERGE_ROUND_FIELDS = {
    "stats_int8": (("min", "int8", "float32"), ("max", "int8", "float32"),
                   ("add", "int8", "float32"), ("add", "raw", "int32")),
    "stats_bf16": (("min", "bf16", "float32"), ("max", "bf16", "float32"),
                   ("add", "bf16", "float32"), ("add", "raw", "int32")),
    "exact_int32": (("min", "raw", "int32"), ("max", "raw", "int32"),
                    ("add", "raw", "int32"), ("add", "raw", "int32")),
    "mixed": (("add", "raw", "float32"), ("min", "int8", "int32"), ("max", "bf16", "int32")),
}
#: Frames of a bit-exact round, in peer order: (padded length, real
#: rows), cycled.
MERGE_ROUND_FRAMES = ((8192, 8190), (16384, 16380), (8192, 1), (8192, 5000))
#: Timed rounds: a stats round of the tier at 2 and 4 processes with
#: one shard each (a frame a process, every key: 4,095 a shard).
MERGE_ROUND_TIMED = (("stats_int8_2p", 2, "int8"), ("stats_bf16_2p", 2, "bf16"),
                     ("stats_int8_4p", 4, "int8"), ("stats_bf16_4p", 4, "bf16"))
#: Timed merge shapes: a quantized float frame's sum field, its count
#: field, and a bf16 min field, at 2 and 4 shards.
MERGE_TIMED = (
    ("sum_int8_f32", "add", "int8", "float32"),
    ("count_raw_i32", "add", "raw", "int32"),
    ("min_bf16_f32", "min", "bf16", "float32"),
)
#: Phase 12's flows: 1BRC columnar batches (2^20 rows, int16 stations
#: and deci-degrees), read by P partitions, one a process.
GLOBAL_BATCHES = 8
GLOBAL_STATIONS = 413
GLOBAL_WIDE_STATIONS = 10_000
GLOBAL_WIDE_PROCS = 4
#: Epoch interval of the phase's runs (several exchange rounds a run).
GLOBAL_EPOCH_S = 0.05
#: Keys a shard of the cluster-wide tier holds (its last slot is
#: exchange scratch).
GLOBAL_SHARD_KEYS = 4095
#: The quantized runs' bounds, as tests/test_cluster.py sets them for
#: values up to the largest |value| (99.9 degrees here): min and max
#: within one quantization step, means within 5% of max(|mean|, 1).
QUANT_TOL = {"int8": 99.9 / 254.0, "bf16": 99.9 * 2.0**-8}
QUANT_MEAN_RTOL = 0.05


def _merge_case(op: str, enc: str, dtype: str, padded: int, n: int, seed: int):
    """One frame's field and a merge table of ``padded // 4095`` shards
    of 4,096 slots: ``n`` unique real targets, the padding on shard 0's
    scratch slot, NaN, ±inf and negative values among the rows, a third
    of the table folded already (NaN and ±inf among those slots)."""
    import numpy as np

    from bytewax_tpu_torch.engine import xla as txla

    rng = np.random.default_rng(seed)
    size = 4096 * max(2, -(-padded // 4095))
    real = np.setdiff1d(np.arange(size), np.arange(4095, size, 4096))
    gidx = np.full(padded, 4095, dtype=np.int32)
    gidx[:n] = rng.permutation(real)[:n]
    init = {"add": 0.0, "min": float("inf"), "max": float("-inf")}[op]
    table = txla.agg_merge_table(size, init, dtype).numpy()
    touched = rng.choice(real, size // 3, replace=False)
    if dtype == "float32":
        table[touched] = rng.normal(0, 300, len(touched)).astype(np.float32)
        table[touched[:3]] = [np.nan, np.inf, -np.inf]
    else:
        table[touched] = rng.integers(-(2**20), 2**20, len(touched))
    k = min(n, 6)
    if enc == "raw":
        if dtype == "float32":
            vals = rng.normal(0, 300, padded).astype(np.float32)
            vals[:k] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.5][:k]
        else:
            vals = rng.integers(-(2**31), 2**31, padded, dtype=np.int64).astype(np.int32)
        parts = (vals,)
    elif enc == "int8":
        scales = (rng.random(-(-padded // 1024)) * 4).astype(np.float32)
        scales[0] = np.inf if dtype == "float32" else 3e7
        parts = (scales, rng.integers(-127, 128, padded).astype(np.int8))
    else:
        f = rng.normal(0, 3e3, padded).astype(np.float32)
        f[:k] = [np.nan, np.inf, -np.inf, 3e9, -3e9, -2.75][:k]
        parts = ((f.view(np.uint32) >> 16).astype(np.uint16).view(np.int16),)
    return table, gidx, parts


def _on_card(table, gidx, parts):
    import torch

    return (
        torch.from_numpy(table.copy()).to(DEV),
        torch.from_numpy(gidx).to(DEV),
        [torch.from_numpy(p).to(DEV) for p in parts],
    )


def _merge_library(table, gidx, n: int, enc: str, parts, op: str) -> None:
    """One PyTorch call that computes the merge, as a yardstick the port
    never calls: the dequantize, then one ``scatter_reduce_``."""
    import torch

    if enc == "raw":
        vals = parts[0][:n]
    elif enc == "int8":
        vals = parts[1][:n].to(torch.float32) * parts[0].repeat_interleave(1024)[:n]
    else:
        vals = (parts[0][:n].to(torch.int32) << 16).view(torch.float32)
    reduce = {"add": "sum", "min": "amin", "max": "amax"}[op]
    table.scatter_reduce_(0, gidx[:n].long(), vals.to(table.dtype), reduce)


def _merge_bound_ms(n: int, enc: str) -> float:
    """Bytes over the card's memory rate: each row's target, part and
    scale read once, and its table slot read and written once."""
    part = {"raw": 4, "int8": 1, "bf16": 2}[enc]
    scales = 4 * -(-n // 1024) if enc == "int8" else 0
    return (n * (4 + part + 8) + scales) / HBM_BYTES_PER_S * 1e3


def _merge_round_case(fields, n_frames: int, seed: int):
    """A round of ``n_frames`` frames (:data:`MERGE_ROUND_FRAMES`) over
    ``fields`` into tables of 20,480 slots: the tables (a third of their
    slots folded already) and, per frame, its targets, real rows and
    each field's ``(enc, parts)``.  Frames share slots, so a slot takes
    several frames' rows, in order."""
    tables, frames = [], []
    for f in range(n_frames):
        padded, n = MERGE_ROUND_FRAMES[f % len(MERGE_ROUND_FRAMES)]
        gidx, parts_of = None, []
        for k, (op, enc, dtype) in enumerate(fields):
            table, g, parts = _merge_case(op, enc, dtype, 16384, n, seed + 31 * f + k)
            if f == 0:
                tables.append(table)
            gidx = g[:padded] if gidx is None else gidx
            if enc == "int8":  # (scales, q): a scale a 1,024 rows
                parts = (parts[0][: -(-padded // 1024)], parts[1][:padded])
            else:
                parts = (parts[0][:padded],)
            parts_of.append((enc, parts))
        frames.append((gidx, n, parts_of))
    return tables, frames


def _stats_round(procs: int, quant: str, seed: int):
    """The tier's stats round at ``procs`` processes of one shard each:
    one frame a process over every key (4,095 a shard) into tables of
    ``procs * 4096`` slots (min, max and sum quantized, count exact);
    returns the tables on the card, the ops and the frames."""
    import numpy as np
    import torch

    from bytewax_tpu_torch.engine import xla as txla

    rng = np.random.default_rng(seed)
    size = procs * 4096
    real = np.setdiff1d(np.arange(size), np.arange(4095, size, 4096))
    n = len(real)
    spec = (("min", float("inf"), "float32"), ("max", float("-inf"), "float32"),
            ("add", 0.0, "float32"), ("add", 0.0, "int32"))
    tables = [txla.agg_merge_table(size, init, dtype, DEV) for _op, init, dtype in spec]
    frames = []
    for _ in range(procs):
        vals = rng.normal(20, 15, (3, n)).astype(np.float32)
        parts_of = []
        for v in vals:
            if quant == "int8":
                blocks = -(-n // 1024)
                padded = np.zeros(blocks * 1024, dtype=np.float32)
                padded[:n] = v
                scales = np.abs(padded.reshape(blocks, 1024)).max(axis=1).astype(np.float32) / 127
                q = np.rint(padded / np.repeat(np.maximum(scales, 1e-30), 1024)).astype(np.int8)[:n]
                parts_of.append(("int8", (scales, q)))
            else:
                parts_of.append(("bf16", ((v.view(np.uint32) >> 16).astype(np.uint16).view(np.int16),)))
        parts_of.append(("raw", (rng.integers(1, 500, n).astype(np.int32),)))
        frames.append((rng.permutation(real).astype(np.int32), n, parts_of))
    return tables, [op for op, _i, _d in spec], frames


def _merge_round_library(tables, ops, rnd) -> None:
    """The PyTorch sequence that computes a round, as a yardstick the
    port never calls: a frame and a field at a time, the dequantize and
    one ``scatter_reduce_``."""
    for f in range(rnd.n_frames):
        gidx, n = rnd.frame(f)
        for k, (table, op) in enumerate(zip(tables, ops)):
            enc, parts = rnd.field(f, k, table.dtype)
            _merge_library(table, gidx, n, enc, parts, op)


def _merge_round_bound_ms(rnd, tables) -> float:
    """Bytes over the card's memory rate: each frame's targets and
    parts read once, and each row's slot of each table read and written
    once."""
    total = 0
    for f in range(rnd.n_frames):
        _g, n = rnd.frame(f)
        total += 4 * n
        for k, table in enumerate(tables):
            _enc, parts = rnd.field(f, k, table.dtype)
            total += sum(p.numel() * p.element_size() for p in parts) + 8 * n
    return total / HBM_BYTES_PER_S * 1e3


def _merge_round_cases() -> dict:
    """The round kernel against the plain version folded frame by frame,
    on the card, bit for bit, each round run twice: every field set of
    :data:`MERGE_ROUND_FIELDS` over rounds of 1, 2 and 4 frames; then a
    repeated target and a target outside the tables, each of which must
    raise naming its frame."""
    import torch

    from bytewax_tpu_torch.engine import xla as txla
    from bytewax_tpu_torch.ops import merge_kernel

    cases = 0
    for i, (name, spec) in enumerate(sorted(MERGE_ROUND_FIELDS.items())):
        ops = [op for op, _enc, _dt in spec]
        for n_frames in (1, 2, 4):
            tables, frames = _merge_round_case(spec, n_frames, seed=200 + 10 * i + n_frames)
            rnd = txla.pack_merge_round(frames, len(spec), pin=True).to(DEV)
            want = [torch.from_numpy(t.copy()).to(DEV) for t in tables]
            txla.agg_merge_round_plain(want, ops, rnd)
            want = [t.view(torch.int32).cpu() for t in want]
            for run in range(2):
                got = [torch.from_numpy(t.copy()).to(DEV) for t in tables]
                before = merge_kernel.launches
                txla.agg_merge_round(got, ops, rnd)
                if merge_kernel.launches != before + 1:
                    msg = f"agg_merge round {name}/{n_frames}: {merge_kernel.launches - before} launches"
                    raise AssertionError(msg)
                for k, (g, w) in enumerate(zip(got, want)):
                    if not torch.equal(g.view(torch.int32).cpu(), w):
                        msg = f"agg_merge round {name}/{n_frames}, field {k}, run {run}: bits differ"
                        raise AssertionError(msg)
            cases += 1
    spec = MERGE_ROUND_FIELDS["stats_int8"]
    ops = [op for op, _enc, _dt in spec]
    tables, frames = _merge_round_case(spec, 3, seed=300)
    gidx, n, parts = frames[1]
    bad = gidx.copy()
    bad[7] = bad[3]
    outside = frames[2][0].copy()
    outside[0] = tables[0].shape[0]
    for fault, at in (((frames[0], (bad, n, parts), frames[2]), 1),
                      ((frames[0], frames[1], (outside,) + frames[2][1:]), 2)):
        rnd = txla.pack_merge_round(list(fault), len(spec), pin=True).to(DEV)
        try:
            txla.agg_merge_round([torch.from_numpy(t.copy()).to(DEV) for t in tables], ops, rnd)
        except ValueError as exc:
            if f"frame {at} " not in str(exc):
                msg = f"agg_merge round: the error does not name frame {at}: {exc}"
                raise AssertionError(msg) from exc
        else:
            msg = f"agg_merge round: frame {at}'s fault did not raise"
            raise AssertionError(msg)
    return {"round_cases": cases, "round_fields": sorted(MERGE_ROUND_FIELDS), "round_frames": [1, 2, 4],
            "faults_named": [1, 2]}


def _time_merge_rounds(card: dict) -> dict:
    """``merge_round_time`` lines at the tier's stats round shapes."""
    import torch

    from bytewax_tpu_torch.engine import xla as txla
    from bytewax_tpu_torch.ops import merge_kernel

    times = {}
    for label, procs, quant in MERGE_ROUND_TIMED:
        tables, ops, frames = _stats_round(procs, quant, seed=procs)
        host_rnd = txla.pack_merge_round(frames, len(tables), pin=True)
        rnd = host_rnd.to(DEV)
        lib_tables = [t.clone() for t in tables]
        plain_tables = [t.clone() for t in tables]

        def apply(tables=tables, ops=ops, host_rnd=host_rnd):
            txla.agg_merge_round(tables, ops, host_rnd.to(DEV))

        def launch(tables=tables, ops=ops, rnd=rnd):
            merge_kernel.launch_round(tables, ops, rnd.desc_tensor(), rnd.n_frames, rnd.buf.data_ptr(),
                                      rnd.max_rows)

        def pack(frames=frames, n_fields=len(tables)):
            txla.pack_merge_round(frames, n_fields, pin=True)

        def plain(tables=plain_tables, ops=ops, rnd=rnd):
            txla.agg_merge_round_plain(tables, ops, rnd)

        def library(tables=lib_tables, ops=ops, rnd=rnd):
            _merge_round_library(tables, ops, rnd)

        prof = _profiled(launch, 200, names=MERGE_KERNEL)
        whole = _profiled(apply, 50, names=MERGE_KERNEL)
        host = _host_us_alternating({"apply": apply, "launch": launch, "pack": pack}, 100)
        tm = {
            "ms": prof["ms"],
            "graph_ms": _graph_ms(launch),
            "host_us": host["apply"],
            "launch_host_us": host["launch"],
            "pack_us": host["pack"],
            "plain_ms": _time_ms(plain, 20),
            "bound_ms": _merge_round_bound_ms(rnd, tables),
            "bound_by": "bytes",
            "library_ms": _time_ms(library, 20),
        }
        times[label] = tm
        _emit(card, "merge_round_time", shape=label, processes=procs, frames=rnd.n_frames,
              fields=len(tables), rows_a_frame=frames[0][1], table_slots=tables[0].shape[0], encoding=quant,
              round_bytes=host_rnd.nbytes, launches_per_round=whole["host_launches_per_call"],
              device_trace_launches_per_round=whole["launches_per_call"],
              host_memsets_per_round=whole["host_memsets_per_call"],
              library="per frame and field: the dequantize, then one scatter_reduce_", **tm)
    return times


def phase_merge_kernel(card: dict) -> dict:
    """Phase 12 (a): hold the dequantize-and-merge kernel against its
    plain version on the card bit for bit: single frame-and-field calls
    (every op, encoding and table dtype; frames of 8,192 and 16,384 rows
    with n below the padded length and a frame of one row; NaN, ±inf
    and negative values), each run twice (the two runs bit-identical
    too), then whole rounds (:func:`_merge_round_cases`); then time it:
    a frame's field alone (``merge_kernel_time``) and whole stats rounds
    (``merge_round_time``)."""
    import torch

    from bytewax_tpu_torch.engine import xla as txla
    from bytewax_tpu_torch.ops import merge_kernel

    cases = 0
    for i, (op, enc, dtype) in enumerate(
        (o, e, d) for o in MERGE_OPS for e in MERGE_ENCS for d in MERGE_DTYPES
    ):
        for padded, n in MERGE_FRAMES:
            table, gidx, parts = _merge_case(op, enc, dtype, padded, n, seed=100 + i)
            t, g, p = _on_card(table, gidx, parts)
            want = txla.agg_merge_plain(t.clone(), g, n, enc, p, op).view(torch.int32).cpu()
            runs = []
            for _ in range(2):
                got = t.clone()
                txla.agg_merge(got, g, n, enc, p, op)
                runs.append(got.view(torch.int32).cpu())
            for k, got in enumerate(runs):
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    msg = f"agg_merge {op}/{enc}/{dtype}/{padded}/{n}, run {k}: {bad} slots differ in their bits"
                    raise AssertionError(msg)
            cases += 1
    rounds = _merge_round_cases()
    _emit(card, "merge_kernel", cases=cases, runs_per_case=2, frames=[list(f) for f in MERGE_FRAMES],
          ops=list(MERGE_OPS), encodings=list(MERGE_ENCS), table_dtypes=list(MERGE_DTYPES),
          bit_exact=True, max_abs_err=0.0, **rounds)

    times = {}
    for padded, n in MERGE_FRAMES[:2]:
        shards = padded // 4096
        for label, op, enc, dtype in MERGE_TIMED:
            table, gidx, parts = _merge_case(op, enc, dtype, padded, n, seed=7)
            t, g, p = _on_card(table, gidx, parts)
            lib_t = t.clone()
            one = txla.pack_merge_round([(gidx, n, [(enc, parts)])], 1, pin=True).to(DEV)

            def call(t=t, g=g, n=n, enc=enc, p=p, op=op):
                merge_kernel.merge(t, g, n, enc, p, op)

            def launch(t=t, op=op, one=one):
                merge_kernel.launch_round([t], [op], one.desc_tensor(), 1, one.buf.data_ptr(), n)

            def plain(t=t, g=g, n=n, enc=enc, p=p, op=op):
                txla.agg_merge_plain(t, g, n, enc, p, op)

            def library(t=lib_t, g=g, n=n, enc=enc, p=p, op=op):
                _merge_library(t, g, n, enc, p, op)

            prof = _profiled(launch, 200, names=MERGE_KERNEL)
            host = _host_us_alternating({"call": call, "launch": launch}, 200)
            tm = {
                "ms": prof["ms"],
                "graph_ms": _graph_ms(launch),
                "host_us": host["call"],
                "launch_host_us": host["launch"],
                "plain_ms": _time_ms(plain, 20),
                "bound_ms": _merge_bound_ms(n, enc),
                "bound_by": "bytes",
                "library_ms": _time_ms(library, 50),
            }
            name = f"{label}_{shards}sh"
            times[name] = tm
            _emit(card, "merge_kernel_time", shape=name, rows=n, padded=padded, shards=shards, op=op,
                  encoding=enc, table_dtype=dtype, launches_per_call=prof["launches_per_call"],
                  host_launches_per_call=prof["host_launches_per_call"],
                  host_memsets_per_call=prof["host_memsets_per_call"],
                  library="the dequantize, then one scatter_reduce_", **tm)
    return {"times": times, "round_times": _time_merge_rounds(card)}


def _global_data(work: Path, n_stations: int, seed: int):
    """Phase 12's 1BRC batches in ``work`` (the children map them);
    returns the stations and the float64 oracle in deci-degrees."""
    import numpy as np

    from bytewax_tpu_torch.models.brc import generate_batches

    work.mkdir()
    batches = generate_batches(GLOBAL_BATCHES * BATCH_ROWS, BATCH_ROWS, n_stations, seed=seed)
    ids = np.concatenate([b.numpy("key_id") for b in batches])
    deci = np.concatenate([b.numpy("value") for b in batches])
    np.save(work / "gbrc_ids.npy", ids)
    np.save(work / "gbrc_deci.npy", deci)
    stations = batches[0].key_vocab
    return stations, _brc_deci_oracle(stations, ids.astype(np.int64), deci.astype(np.int64))


def _largest_shard(stations, procs: int) -> int:
    """Keys of the fullest shard of the cluster-wide tier with one lane
    and one device a process: a key's shard is its lane's process,
    ``adler32(key) % procs`` (``GlobalAggState._owner_shard``)."""
    import zlib

    import numpy as np

    owners = [zlib.adler32(str(s).encode()) % procs for s in stations]
    return int(np.bincount(owners, minlength=procs).max())


def _read_global_out(name: str, out: Path) -> dict:
    """The union of the processes' files: ``{station: (count, min,
    mean, max)}``, each station once."""
    got = {}
    for path in sorted(out.iterdir()):
        for line in path.read_text().splitlines():
            station, mn, mean, mx, count = line.split(";")
            if station in got:
                msg = f"{name}: station {station} emitted twice"
                raise AssertionError(msg)
            got[station] = (int(count), float(mn), float(mean), float(mx))
    return got


def _check_global(name: str, got: dict, want: dict, scale: float, quant: str) -> dict:
    """A run's output against the float64 oracle: counts exact; min and
    max exact after rounding and means within 1e-5 of the mean |value|
    (phase 10's tolerances), or within the quantized bounds where the
    floats rode ``quant``; returns the worst errors."""
    if set(got) != set(want):
        msg = f"{name}: {len(got)} stations out, {len(want)} expected"
        raise AssertionError(msg)
    unit = 10.0 if scale else 1.0  # output units a deci-degree
    worst = {"mean": 0.0, "min_max": 0.0}
    for station, (count, mn, mx, mean, mean_abs) in want.items():
        gcount, gmn, gmean, gmx = got[station]
        if gcount != count:
            msg = f"{name}, {station}: count {gcount} != {count}"
            raise AssertionError(msg)
        gmean_deg = gmean * unit / 10.0
        if quant == "off" or not scale:
            if (round(gmn * unit), round(gmx * unit)) != (mn, mx):
                msg = f"{name}, {station}: min/max {gmn}/{gmx} against {mn}/{mx} deci"
                raise AssertionError(msg)
            worst["mean"] = max(worst["mean"], _check_mean(gmean_deg, mean, mean_abs, f"{name}, {station}"))
            continue
        err = max(abs(gmn - mn / 10.0), abs(gmx - mx / 10.0))
        merr = abs(gmean - mean)
        if err > QUANT_TOL[quant] or merr > QUANT_MEAN_RTOL * max(abs(mean), 1.0):
            msg = f"{name}, {station}: {got[station]} against min {mn}, max {mx} deci, mean {mean} ({quant})"
            raise AssertionError(msg)
        worst["min_max"] = max(worst["min_max"], err)
        worst["mean"] = max(worst["mean"], merr)
    return worst


def _same_floats(name: str, got: dict, other: dict, what: str) -> bool:
    """Two exact runs of the same float rows: the same counts, min and
    max, and means within 1e-5 relative (float32 sums fold in an order
    that depends on the kernel's atomics and on how the rows split into
    rounds); returns whether every value is also the same."""
    if set(got) != set(other):
        msg = f"{name}: {len(got)} stations, {len(other)} in {what}"
        raise AssertionError(msg)
    for station, (count, mn, mean, mx) in other.items():
        g = got[station]
        if (g[0], g[1], g[3]) != (count, mn, mx) or abs(g[2] - mean) > 1e-5 * max(abs(mean), 1.0):
            msg = f"{name}, {station}: {g} against {other[station]} in {what}"
            raise AssertionError(msg)
    return got == other


def _rounds(err: str, proc: int) -> int:
    """Exchange rounds that process ``proc`` printed (the tier's debug
    line; peers share the stream)."""
    return err.count(f"global-exchange: proc {proc} flushed")


def _global_reports(name: str, reports: Path, procs: int, err: str, distributed: bool,
                    quant: str, host_fold: bool) -> list:
    """Every process's report, held to the phase's rules: on
    ``cuda:0``, no demotion, and, on the cluster-wide tier, a flush and
    the transport printed by each process, the bucket and fold kernels
    launched (exact) or the merge kernel launched and the merge never
    demoted to the host (quantized, unless ``host_fold``)."""
    reps = _cluster_reports(reports, name, procs, own_checks=True)
    for r in reps:
        where = f"{name}, process {r['proc_id']} (pid {r['pid']})"
        rounds = _rounds(err, r["proc_id"])
        if not distributed:
            if rounds or r["transport"] is not None or r["fold_launches"] <= 0:
                msg = f"{where}: the per-process tier ran {rounds} exchange rounds, {r['fold_launches']} folds"
                raise AssertionError(msg)
            continue
        if not rounds or r["transport"] is None or f"transport {r['transport']}" not in err:
            msg = f"{where}: {rounds} exchange rounds printed, transport {r['transport']}"
            raise AssertionError(msg)
        host_bytes = r["counters"].get("gsync_merge_host_bytes", 0)
        if quant == "off" and (r["bucket_launches"] <= 0 or r["fold_launches"] <= 0):
            msg = f"{where}: bucket {r['bucket_launches']}, fold {r['fold_launches']} launches on the exact tier"
            raise AssertionError(msg)
        if quant != "off" and host_fold != (host_bytes > 0):
            msg = f"{where}: host fold bytes {host_bytes} (host fold expected: {host_fold})"
            raise AssertionError(msg)
        if quant != "off" and not host_fold and r["merge_launches"] <= 0:
            msg = f"{where}: the merge kernel was launched no time"
            raise AssertionError(msg)
    return reps


def _global_run(card: dict, work: Path, data: Path, name: str, procs: int, stations: int,
                scale: float, want: dict, distributed: bool = True, **knobs) -> dict:
    """One flow through ``python -m bytewax_tpu_torch.testing -p procs``
    with every process on ``cuda:0``; emits its ``global`` line and
    returns the output, the launches of each kernel and the transport."""
    reports, out = _fresh_dirs(work, name)
    env = _cluster_env(data, reports, out, CLUSTER_FLOW="gbrc", CLUSTER_PARTS=procs,
                       CLUSTER_STATIONS=stations, CLUSTER_BATCH_ROWS=BATCH_ROWS, CLUSTER_SCALE=scale,
                       BYTEWAX_TPU_ACCEL=1, BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG=1, **knobs)
    for knob in ("BYTEWAX_TPU_GSYNC_OVERLAP", "BYTEWAX_TPU_GSYNC_DEPTH", "BYTEWAX_TPU_GSYNC_QUANT",
                 "BYTEWAX_TPU_WIRE", "BYTEWAX_TPU_DISTRIBUTED"):
        if knob not in knobs:
            env.pop(knob, None)
    if distributed:
        env["BYTEWAX_TPU_DISTRIBUTED"] = "1"
    cmd = [sys.executable, "-m", "bytewax_tpu_torch.testing", f"{work / 'cluster_flows.py'}:flow",
           "-p", str(procs), "-s", str(GLOBAL_EPOCH_S)]
    seconds, err = _run_cluster_cmd(name, cmd, env, work)
    quant = knobs.get("BYTEWAX_TPU_GSYNC_QUANT", "off")
    host_fold = knobs.get("BYTEWAX_TPU_WIRE") == "pickle"
    reps = sorted(_global_reports(name, reports, procs, err, distributed, quant, host_fold),
                  key=lambda r: r["proc_id"])
    got = _read_global_out(name, out)
    worst = _check_global(name, got, want, scale, quant)
    rows = GLOBAL_BATCHES * BATCH_ROWS
    after = max(r["end_s"] for r in reps) - max(r["first_batch_s"] for r in reps)
    launches = {key: [r[f"{key}_launches"] for r in reps] for key in ("bucket", "fold", "merge")}
    rounds = [_rounds(err, r["proc_id"]) for r in reps]
    if distributed and quant != "off" and not host_fold and launches["merge"] != rounds:
        msg = f"{name}: merge launches {launches['merge']} against exchange rounds {rounds}: one a round expected"
        raise AssertionError(msg)
    transports = sorted({r["transport"] for r in reps if r["transport"]})
    _emit(
        card,
        "global",
        run=name,
        entry=f"python -m bytewax_tpu_torch.testing -p {procs}",
        tier="cluster-wide exchange" if distributed else "per-process cluster",
        processes=procs,
        rows=rows,
        stations=stations,
        values="deci-degrees x 0.1" if scale else "integer deci-degrees",
        knobs={k: str(v) for k, v in knobs.items()},
        transport=transports[0] if len(transports) == 1 else transports or None,
        seconds=seconds,
        rows_per_s=rows / seconds,
        # From the last process's first batch to the last one's end, each
        # counted from its own process's start (they start together).
        rows_per_s_after_startup=rows / after,
        exchange_rounds=rounds,
        gsync_s=[r["phase_seconds"].get("gsync", 0.0) for r in reps],
        collective_lane_s=[r["phase_seconds"].get("collective_lane", 0.0) for r in reps],
        device_s=[r["phase_seconds"].get("device", 0.0) for r in reps],
        h2d_bytes=[r["counters"].get("device_transfer_bytes_h2d", 0) for r in reps],
        d2h_bytes=[r["counters"].get("device_transfer_bytes_d2h", 0) for r in reps],
        merge_h2d_bytes=[r["counters"].get("gsync_merge_h2d_bytes", 0) for r in reps],
        merge_host_bytes=[r["counters"].get("gsync_merge_host_bytes", 0) for r in reps],
        bucket_launches=launches["bucket"],
        fold_launches=launches["fold"],
        merge_launches=launches["merge"],
        merge_launches_per_round=[m / r if r else None for m, r in zip(launches["merge"], rounds)],
        max_mean_err=worst["mean"],
        max_min_max_err=worst["min_max"],
        cpu_count=os.cpu_count(),
        **_child_fields(reps),
    )
    return {"out": got, "launches": {k: sum(v) for k, v in launches.items()}, "seconds": seconds}


def _live_gsync_rows(db: Path) -> list:
    """The cluster-wide tier's rows a store still holds live (the
    latest row of the key is not a tombstone)."""
    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

    store = RecoveryStore(db)
    try:
        return [key for _step, key, _ser in store.iter_snaps(1 << 40) if key.startswith("\x00gsync-")]
    finally:
        store.close()


def _global_store_run(card: dict, work: Path, data: Path, name: str, want: dict, scale: float,
                      **knobs) -> dict:
    """The 2-process lock-step data through the cluster-wide tier with a
    recovery store under ``BYTEWAX_TPU_GSYNC_OVERLAP=1``, one epoch a
    batch; process 1 crashes inside a send at epoch 4 and the
    supervisors restart both processes, which install the store's
    baseline (if any) and replay its rounds on the card.  Fails unless
    the run ends cleanly, exactly once against the oracle, with every
    process restarted and its restarted run launching the merge
    (quantized) or the bucket and fold (exact) kernels, and no live
    gsync row left in the store.  Emits its ``global`` line and returns
    each kernel's launches."""
    reports, out = _fresh_dirs(work, name)
    db = work / f"{name}_db"
    db.mkdir()
    env = _cluster_env(data, reports, out, CLUSTER_FLOW="gbrc", CLUSTER_PARTS=2,
                       CLUSTER_STATIONS=GLOBAL_STATIONS, CLUSTER_BATCH_ROWS=BATCH_ROWS, CLUSTER_SCALE=scale,
                       CLUSTER_HOLD_CLOSES=GLOBAL_STORE_HOLD, BYTEWAX_TPU_ACCEL=1, BYTEWAX_TPU_DISTRIBUTED=1,
                       BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG=1, BYTEWAX_TPU_GSYNC_OVERLAP=1,
                       BYTEWAX_TPU_INGEST_TARGET_ROWS=0, BYTEWAX_TPU_FAULTS=GLOBAL_STORE_FAULT,
                       BYTEWAX_TPU_MAX_RESTARTS=3, BYTEWAX_TPU_RESTART_BACKOFF_S=0.1, **knobs)
    for knob in ("BYTEWAX_TPU_GSYNC_DEPTH", "BYTEWAX_TPU_GSYNC_QUANT", "BYTEWAX_TPU_WIRE",
                 "BYTEWAX_TPU_GSYNC_BASELINE_EVERY"):
        if knob not in knobs:
            env.pop(knob, None)
    subprocess.run([sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
                   env=env, check=True, timeout=120)
    cmd = [sys.executable, "-m", "bytewax_tpu_torch.testing", f"{work / 'cluster_flows.py'}:flow",
           "-p", "2", "-r", str(db), "-s", str(GLOBAL_EPOCH_S), "-b", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=work, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    # Drain stderr on a thread: the children's debug lines must not
    # fill the pipe while the store is polled here.
    import threading

    err_parts = []
    reader = threading.Thread(target=lambda: err_parts.append(proc.stderr.read()))
    reader.start()
    recovered = None
    first_ex = None
    deadline = time.monotonic() + CLUSTER_TIMEOUT_S
    try:
        while proc.poll() is None:
            if time.monotonic() > deadline:
                msg = f"{name}: the run did not end in {CLUSTER_TIMEOUT_S} s"
                raise AssertionError(msg)
            fronts = _fronts(db, 1)
            if fronts and first_ex is None:
                first_ex = min(f[0] for f in fronts)
            if recovered is None and first_ex is not None and any(
                ex > first_ex and epoch > resume for ex, epoch, resume in fronts
            ):
                recovered = time.time()
            time.sleep(0.01)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        reader.join()
    seconds = time.perf_counter() - t0
    err = "".join(err_parts)
    if proc.returncode != 0:
        msg = f"{name}: exit {proc.returncode}\n{err[-3000:]}"
        raise AssertionError(msg)
    if "supervised restart" not in err:
        msg = f"{name}: no supervised restart\n{err[-3000:]}"
        raise AssertionError(msg)
    quant = knobs.get("BYTEWAX_TPU_GSYNC_QUANT", "off")
    reps = sorted(_global_reports(name, reports, 2, err, True, quant, False), key=lambda r: r["proc_id"])
    after = {}
    for r in reps:
        where = f"{name}, process {r['proc_id']} (pid {r['pid']})"
        if not r["restarts"]:
            msg = f"{where}: never restarted"
            raise AssertionError(msg)
        last = r["restarts"][-1]
        after[r["proc_id"]] = {k: r[f"{k}_launches"] - last[k] for k in ("bucket", "fold", "merge")}
        if quant != "off" and after[r["proc_id"]]["merge"] <= 0:
            msg = f"{where}: the restarted run launched no merge"
            raise AssertionError(msg)
        if quant == "off" and (after[r["proc_id"]]["bucket"] <= 0 or after[r["proc_id"]]["fold"] <= 0):
            msg = f"{where}: the restarted run launched bucket {after[r['proc_id']]['bucket']}, fold " \
                  f"{after[r['proc_id']]['fold']} times"
            raise AssertionError(msg)
    resumed = {}
    for r in reps:
        mark = f"global-exchange: proc {r['proc_id']} resumed baseline round "
        lines = [ln.split(mark, 1)[1] for ln in err.splitlines() if mark in ln]
        if len(lines) != 1:
            msg = f"{name}, process {r['proc_id']}: {len(lines)} resume lines"
            raise AssertionError(msg)
        base, rounds = lines[0].split(", replayed rounds ", 1)
        resumed[r["proc_id"]] = {"baseline_round": None if base == "None" else int(base),
                                 "replayed_rounds": rounds.split(" in ", 1)[0]}
        if "BYTEWAX_TPU_GSYNC_BASELINE_EVERY" in knobs and base == "None":
            msg = f"{name}, process {r['proc_id']}: no baseline installed"
            raise AssertionError(msg)
        if resumed[r["proc_id"]]["replayed_rounds"] == "[]":
            msg = f"{name}, process {r['proc_id']}: no round replayed"
            raise AssertionError(msg)
    live = _live_gsync_rows(db)
    if live:
        msg = f"{name}: the store still holds {len(live)} gsync rows after a clean end: {live[:4]}"
        raise AssertionError(msg)
    if recovered is None:
        msg = f"{name}: process 1 committed no epoch after the restart"
        raise AssertionError(msg)
    got = _read_global_out(name, out)
    worst = _check_global(name, got, want, scale, quant)
    crashed = min(r["restarts"][0]["at"] for r in reps)
    rows = GLOBAL_BATCHES * BATCH_ROWS

    def counter(key):
        return [r["counters"].get(key, 0) for r in reps]

    launches = {key: [r[f"{key}_launches"] for r in reps] for key in ("bucket", "fold", "merge")}
    _emit(
        card,
        "global",
        run=name,
        entry="python -m bytewax_tpu_torch.testing -p 2 -r db -s %g -b 0" % GLOBAL_EPOCH_S,
        tier="cluster-wide exchange, store-composable overlap",
        processes=2,
        rows=rows,
        stations=GLOBAL_STATIONS,
        values="deci-degrees x 0.1" if scale else "integer deci-degrees",
        knobs={k: str(v) for k, v in knobs.items()},
        fault=GLOBAL_STORE_FAULT,
        transport=reps[0]["transport"],
        seconds=seconds,
        rows_per_s=rows / seconds,
        time_to_recover_s=recovered - crashed,
        restarts=[len(r["restarts"]) for r in reps],
        resumed=[resumed[r["proc_id"]] for r in reps],
        gsync_rows_written=counter("gsync_store_rows"),
        gsync_rows_tombstoned=counter("gsync_store_tombstones"),
        gsync_rounds_replayed=counter("gsync_replayed_rounds"),
        gsync_baselines_installed=counter("gsync_baseline_installs"),
        gsync_replay_s=counter("gsync_replay_seconds"),
        exchange_rounds=[_rounds(err, r["proc_id"]) for r in reps],
        bucket_launches=launches["bucket"],
        fold_launches=launches["fold"],
        merge_launches=launches["merge"],
        launches_after_restart=[after[r["proc_id"]] for r in reps],
        max_mean_err=worst["mean"],
        max_min_max_err=worst["min_max"],
        exactly_once=True,
        **_child_fields(reps),
    )
    return {k: sum(v) for k, v in launches.items()}


#: Phase 12's store runs: the fault (process 1 crashes inside a send at
#: epoch 4, with earlier rounds committed), the closes each process
#: holds EOF for, and (name, integer values, knobs).
GLOBAL_STORE_FAULT = "comm.send:crash:4:1:x1"
GLOBAL_STORE_HOLD = 6
GLOBAL_STORE_RUNS = (
    ("global_store_d1", False, {}),
    ("global_store_d2_int8", True,
     {"BYTEWAX_TPU_GSYNC_DEPTH": 2, "BYTEWAX_TPU_GSYNC_QUANT": "int8", "BYTEWAX_TPU_GSYNC_BASELINE_EVERY": 2}),
)

#: Phase 12's runs: (name, processes, wide data, integer values, the
#: cluster-wide tier, knobs).
GLOBAL_RUNS = (
    ("global_exact", 2, False, False, True, {}),
    ("global_overlap_d1", 2, False, False, True, {"BYTEWAX_TPU_GSYNC_OVERLAP": 1}),
    ("global_overlap_d2", 2, False, False, True,
     {"BYTEWAX_TPU_GSYNC_OVERLAP": 1, "BYTEWAX_TPU_GSYNC_DEPTH": 2}),
    ("global_int8", 2, False, False, True, {"BYTEWAX_TPU_GSYNC_QUANT": "int8"}),
    ("global_bf16", 2, False, False, True, {"BYTEWAX_TPU_GSYNC_QUANT": "bf16"}),
    ("global_int8_pickle", 2, False, False, True,
     {"BYTEWAX_TPU_GSYNC_QUANT": "int8", "BYTEWAX_TPU_WIRE": "pickle"}),
    ("global_ints_exact", 2, False, True, True, {}),
    ("global_ints_int8_device", 2, False, True, True,
     {"BYTEWAX_TPU_GSYNC_QUANT": "int8", "BYTEWAX_TPU_GSYNC_OVERLAP": 1, "BYTEWAX_TPU_GSYNC_DEPTH": 2}),
    ("global_ints_int8_host", 2, False, True, True,
     {"BYTEWAX_TPU_GSYNC_QUANT": "int8", "BYTEWAX_TPU_WIRE": "pickle"}),
    ("global_wide_p4", GLOBAL_WIDE_PROCS, True, False, True, {}),
    ("per_process_p2", 2, False, False, False, {}),
    ("per_process_wide_p4", GLOBAL_WIDE_PROCS, True, False, False, {}),
)


def _global_cards(card: dict, work: Path, data: Path, want: dict) -> None:
    """Where the host has several cards: the lock-step flow again with
    one process a card (``python -m bytewax_tpu_torch.run -a … -i p``,
    each child under ``CUDA_VISIBLE_DEVICES=p``), on NCCL; else one
    line saying it was not reached."""
    import socket

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        _emit(card, "global_cards", reached=False,
              reason="one card: torch.cuda.device_count() == 1, so no process had a card of its own")
        return
    procs = min(n, GLOBAL_WIDE_PROCS)
    name = f"global_cards_p{procs}"
    reports, out = _fresh_dirs(work, name)
    ports = []
    for _ in range(procs):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    addrs = ";".join(f"127.0.0.1:{p}" for p in ports)
    env = _cluster_env(data, reports, out, CLUSTER_FLOW="gbrc", CLUSTER_PARTS=procs,
                       CLUSTER_STATIONS=GLOBAL_STATIONS, CLUSTER_BATCH_ROWS=BATCH_ROWS, CLUSTER_SCALE=0.1,
                       BYTEWAX_TPU_ACCEL=1, BYTEWAX_TPU_DISTRIBUTED=1, BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG=1)
    t0 = time.perf_counter()
    children = [
        subprocess.Popen(
            [sys.executable, "-m", "bytewax_tpu_torch.run", f"{work / 'cluster_flows.py'}:flow",
             "-a", addrs, "-i", str(p), "-s", str(GLOBAL_EPOCH_S)],
            env=dict(env, CUDA_VISIBLE_DEVICES=str(p), BYTEWAX_PROCESS_ID=str(p)), cwd=work,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
        for p in range(procs)
    ]
    errs = []
    try:
        errs = [c.communicate(timeout=CLUSTER_TIMEOUT_S)[1] for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    seconds = time.perf_counter() - t0
    codes = [c.returncode for c in children]
    if any(codes):
        msg = f"{name}: exits {codes}\n" + "\n".join(e[-2000:] for e in errs)
        raise AssertionError(msg)
    reps = _global_reports(name, reports, procs, "\n".join(errs), True, "off", False)
    if any(not r["transport"].startswith("nccl") for r in reps):
        msg = f"{name}: transports {[r['transport'] for r in reps]}, NCCL expected"
        raise AssertionError(msg)
    worst = _check_global(name, _read_global_out(name, out), want, 0.1, "off")
    rows = GLOBAL_BATCHES * BATCH_ROWS
    _emit(card, "global_cards", reached=True, run=name, processes=procs, rows=rows,
          transport=reps[0]["transport"], seconds=seconds, rows_per_s=rows / seconds,
          max_mean_err=worst["mean"],
          bucket_launches=[r["bucket_launches"] for r in reps],
          fold_launches=[r["fold_launches"] for r in reps])


def phase_global(card: dict) -> dict:
    """Phase 12: the merge kernel against its plain version, timed; then
    the cluster-wide exchange tier's flows on the one card (one
    temporary directory, removed at the end), each against its oracle,
    beside the per-process cluster tier; returns the kernel times and
    each run's launches of each kernel."""
    import tempfile

    check = phase_merge_kernel(card)
    launches = {}
    outs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_global_") as tmp:
        work = Path(tmp)
        (work / "cluster_flows.py").write_text(CLUSTER_FLOW_MODULE)
        narrow, wide = work / "data_413", work / "data_10000"
        stations, want = _global_data(narrow, GLOBAL_STATIONS, seed=0)
        wide_stations, wide_want = _global_data(wide, GLOBAL_WIDE_STATIONS, seed=1)
        largest = _largest_shard(wide_stations, GLOBAL_WIDE_PROCS)
        if largest >= GLOBAL_SHARD_KEYS:
            msg = f"10,000 stations over {GLOBAL_WIDE_PROCS} shards: one holds {largest} keys"
            raise AssertionError(msg)
        _emit(card, "global_placement", stations=GLOBAL_WIDE_STATIONS, shards=GLOBAL_WIDE_PROCS,
              largest_shard_keys=largest, shard_capacity=GLOBAL_SHARD_KEYS)
        for name, procs, is_wide, ints, distributed, knobs in GLOBAL_RUNS:
            run = _global_run(card, work, wide if is_wide else narrow, name, procs,
                              GLOBAL_WIDE_STATIONS if is_wide else GLOBAL_STATIONS, 0 if ints else 0.1,
                              wide_want if is_wide else want, distributed=distributed, **knobs)
            outs[name] = run["out"]
            launches[name] = run["launches"]
        for name, ints, knobs in GLOBAL_STORE_RUNS:
            launches[name] = _global_store_run(card, work, narrow, name, want, 0 if ints else 0.1, **knobs)
        same = {
            "global_overlap_d1": _same_floats("global_overlap_d1", outs["global_overlap_d1"],
                                              outs["global_exact"], "the lock-step run"),
            "global_overlap_d2": _same_floats("global_overlap_d2", outs["global_overlap_d2"],
                                              outs["global_exact"], "the lock-step run"),
        }
        for name in ("global_ints_int8_device", "global_ints_int8_host"):
            if outs[name] != outs["global_ints_exact"]:
                msg = f"{name}: output differs from the exact tier's on integer values"
                raise AssertionError(msg)
        _emit(card, "global_compare", float_runs_identical_to_lockstep=same,
              integer_runs_identical=["global_ints_exact", "global_ints_int8_device", "global_ints_int8_host"])
        _global_cards(card, work, narrow, want)
    return dict(check, launches=launches)


# -- phase 13 ----------------------------------------------------------------

#: Phase 13: 1BRC messages on the in-process broker's partitions.
KAFKA_MESSAGES = 1 << 20
KAFKA_PARTITIONS = 4
KAFKA_STATIONS = 10_000
KAFKA_BROKER = "inmem://chip-smoke"
KAFKA_TOPIC = "measurements"


def _kafka_messages(n: int, n_stations: int, seed: int):
    """Produce ``n`` 1BRC messages into the in-process broker (the
    default partitioner spreads the stations over the partitions);
    returns the stations, ids and deci-degrees."""
    import numpy as np

    from bytewax_tpu_torch.connectors.kafka import inmem

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_stations, size=n)
    deci = np.clip(np.round(rng.randn(n) * 100 + 120), -999, 999).astype(np.int64)
    stations = np.array([f"station_{i:05d}" for i in range(n_stations)])
    keys = [s.encode() for s in stations.tolist()]
    temps = [f"{q / 10:.1f}".encode() for q in range(-999, 1000)]
    broker = inmem.broker_for(KAFKA_BROKER)
    broker.create_topic(KAFKA_TOPIC, partitions=KAFKA_PARTITIONS)
    for i, d in zip(ids.tolist(), deci.tolist()):
        broker.produce(KAFKA_TOPIC, value=temps[d + 999], key=keys[i])
    return stations, ids, deci


def phase_kafka(card: dict) -> int:
    """Phase 13: the Kafka connector's columnar source over the port's
    in-process broker into ``xla.stats_final`` on the card; returns the
    fold launches of the run."""
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.connectors.kafka import KafkaSource, inmem
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.testing import TestingSink

    inmem.reset()
    t0 = time.perf_counter()
    stations, ids, deci = _kafka_messages(KAFKA_MESSAGES, KAFKA_STATIONS, seed=13)
    produce_s = time.perf_counter() - t0
    want = _stats_oracle(stations, ids, deci)
    polls = {"columnar": 0, "itemized": 0}

    class _Counted(KafkaSource):
        # Counts the partitions' polls that brought rows, by form.
        def build_part(self, step_id, for_part, resume_state):
            part = super().build_part(step_id, for_part, resume_state)
            nxt = part.next_batch

            def counted():
                out = nxt()
                if isinstance(out, ArrayBatch):
                    polls["columnar"] += 1
                elif out:
                    polls["itemized"] += 1
                return out

            part.next_batch = counted
            return part

    def decode(batch):
        if not isinstance(batch, ArrayBatch):  # an itemized poll
            return [(m.key.decode(), float(np.float32(m.value))) for m in batch]
        return ArrayBatch({"key": batch.cols["key"].astype("U"), "value": batch.cols["value"].astype(np.float32)})

    out = []
    states, _timers, undo = _recording_states()
    try:
        # The broker stands in for ``confluent_kafka`` from the source's
        # construction on.
        with inmem.installed():
            flow = Dataflow("kafka_brc")
            s = op.input("inp", flow, _Counted([KAFKA_BROKER], [KAFKA_TOPIC], tail=False, columnar=True))
            s = op.flat_map_batch("decode", s, decode)
            s = xla.stats_final("stats", s)
            op.output("out", s, TestingSink(out))
            run = _run_flow(flow)
    finally:
        undo()
        inmem.reset()
    _require_launches(run["launches"], "Kafka 1BRC")
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"Kafka 1BRC: device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    got = dict(out)
    if set(got) != set(want):
        msg = f"Kafka 1BRC: {len(got)} stations out, {len(want)} expected"
        raise AssertionError(msg)
    worst = 0.0
    for station, (mn, mean, mx, count, mean_abs) in want.items():
        gmn, gmean, gmx, gcount = got[station]
        if (gmn, gmx, gcount) != (mn, mx, count):
            msg = f"Kafka 1BRC, {station}: {got[station]} != {want[station]}"
            raise AssertionError(msg)
        worst = max(worst, _check_mean(gmean, mean, mean_abs, f"Kafka 1BRC, {station}"))
    _emit(
        card,
        "kafka",
        flow="KafkaSource(columnar) -> flat_map_batch (numpy decode) -> stats_final",
        broker="in-process (bytewax_tpu_torch.connectors.kafka.inmem)",
        messages=KAFKA_MESSAGES,
        partitions=KAFKA_PARTITIONS,
        stations=len(want),
        produce_s=produce_s,
        seconds=run["seconds"],
        messages_per_s=KAFKA_MESSAGES / run["seconds"],
        columnar_polls=polls["columnar"],
        itemized_polls=polls["itemized"],
        fold_launches=run["launches"],
        table_capacity=states[0].capacity,
        max_mean_rel_err=worst,
        ingest_rows_columnar=run["counters"].get("ingest_rows_columnar", 0),
        h2d_bytes=run["counters"].get("device_transfer_bytes_h2d", 0),
        phase_seconds=run["phase_seconds"],
    )
    return run["launches"]


# -- phase 14 ----------------------------------------------------------------

#: (run, the data's windows, batches of ``WINDOW_BATCH_ROWS``, seed) of
#: the public operators that lower to the fold kernel, at full width
#: (the min and the max share their rows).
OPS_LOWERED = (
    ("fold_mean_tumbling", "tumbling", 8, 140),
    ("fold_sum_sliding", "sliding", 2, 141),
    ("reduce_min_tumbling", "tumbling", 4, 142),
    ("reduce_max_tumbling", "tumbling", 4, 142),
    ("mean_window_session", "session", 4, 144),
)
OPS_FINAL_BATCHES = 8
#: The fall-back runs and their lowered counterparts: 2^16 rows of the
#: tumbling data, four event-minutes of 2^14 rows.
OPS_SMALL_BATCHES = 4
OPS_SMALL_ROWS = 1 << 14
#: (fall-back run, the lowered run on the same rows) pairs.
OPS_FALLBACKS = (
    ("plain_folder", "sum_tumbling"),
    ("sum_items_unpromotable", "sum_tumbling"),
    ("session_custom_merger", "sum_session"),
)
OPS_HOST_ROWS = 1 << 16
OPS_BUDGET_S = 90.0


class _Reading(float):
    """A reading that carries its event time as ``at``, not as the
    ``ts`` of ``xla.TsValue``: the window tier's itemized promotion
    cannot read it, so a lowered numeric fold fed such rows falls back
    to the host on first contact (the reference's rule)."""

    def __new__(cls, value: float, at):
        self = super().__new__(cls, value)
        self.at = at
        return self


def _ops_window(case: str, s, align):
    """The windowed operator of ``case`` over stream ``s``; returns its
    ``WindowOut`` and whether the port lowers it to the card."""
    import operator
    from datetime import timedelta

    import bytewax_tpu_torch.operators.windowing as win
    from bytewax_tpu_torch import xla

    wait = timedelta(seconds=WINDOW_WAIT_S)
    clock = win.EventClock(ts_getter=xla.column_ts, wait_for_system_duration=wait)
    tumbling = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
    sliding = win.SlidingWindower(
        length=timedelta(minutes=10), offset=timedelta(minutes=1), align_to=align
    )
    session = win.SessionWindower(gap=timedelta(seconds=60))
    if case == "fold_mean_tumbling":
        mean = xla.MEAN
        return win.fold_window("w", s, clock, tumbling, mean.make_acc, mean, mean.merge), True
    if case == "fold_sum_sliding":
        return win.fold_window("w", s, clock, sliding, lambda: 0.0, xla.SUM, operator.add), True
    if case == "reduce_min_tumbling":
        return win.reduce_window("w", s, clock, tumbling, xla.MIN), True
    if case == "reduce_max_tumbling":
        return win.reduce_window("w", s, clock, tumbling, xla.MAX), True
    if case == "mean_window_session":
        return win.mean_window("w", s, clock, session), True
    if case == "sum_tumbling":
        return win.reduce_window("w", s, clock, tumbling, xla.SUM), True
    if case == "sum_items_promoted":
        # ``(station, TsValue)`` rows promote onto the card through the
        # native host library's encoder; where it does not build they
        # fall back to the host, as the reference defines.
        from bytewax_tpu_torch.native import is_available

        return win.reduce_window("w", s, clock, tumbling, xla.SUM), is_available()
    if case == "sum_session":
        return win.fold_window("w", s, clock, session, lambda: 0, xla.SUM, xla.SUM), True
    if case == "plain_folder":
        return win.fold_window(
            "w", s, clock, tumbling, lambda: 0.0, lambda acc, v: acc + v, operator.add
        ), False
    if case == "sum_items_unpromotable":
        items_clock = win.EventClock(ts_getter=lambda v: v.at, wait_for_system_duration=wait)
        return win.reduce_window("w", s, items_clock, tumbling, xla.SUM), False
    if case == "session_custom_merger":
        merger = lambda a, b: a + b  # noqa: E731 (the same sum, not xla.SUM)
        return win.fold_window("w", s, clock, session, lambda: 0, xla.SUM, merger), False
    raise ValueError(case)


def _ops_batches(ids_b, ts_b, deci_b, vocab, align, form: str):
    """Phase 6's columnar batches, or the same rows itemized as
    ``(station, TsValue)`` (``form="tsvalue"``) or ``(station,
    _Reading)`` (``form="reading"``)."""
    from datetime import timedelta

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.xla import TsValue

    if form == "columnar":
        return [
            ArrayBatch({"key_id": i, "ts": t, "value": d}, key_vocab=vocab, value_scale=0.1)
            for i, t, d in zip(ids_b, ts_b, deci_b)
        ]
    cls = TsValue if form == "tsvalue" else _Reading
    batches = []
    for i_b, t_b, d_b in zip(ids_b, ts_b, deci_b):
        vals = (d_b * 0.1).astype("float32").tolist()
        batches.append(
            [
                (vocab[i], cls(v, align + timedelta(microseconds=t - _T0_US)))
                for i, t, v in zip(i_b.tolist(), t_b.tolist(), vals)
            ]
        )
    return batches


_OPS_DATA = {}


def _ops_data(data: str, n_batches: int, n: int, seed: int, session: bool):
    """Phase 6's rows for a phase 14 run and their float64 oracle, made
    once for the runs that share them: the batches' ids, times and
    int16 values, the late rows' count, and the on-time rows' windows
    (sessions: ``{(station, open µs, close µs): (mean, count, mean
    |value|)}``; else :func:`_window_oracle`'s)."""
    import numpy as np

    key = (data, n_batches, n, seed, session)
    if key not in _OPS_DATA:
        ids_b, ts_b, deci_b = _window_data(data, n_batches, n, WINDOW_KEYS, seed)
        ids = np.concatenate(ids_b)
        ts = np.concatenate(ts_b)
        vals = (np.concatenate(deci_b) * 0.1).astype(np.float32).astype(np.float64)
        late_rows = _late_oracle(ids, ts, WINDOW_WAIT_S * 1_000_000)
        ok = ~late_rows
        if session:
            want = {
                cell: (total / c, c, abs_total / c)
                for cell, (c, total, abs_total) in _sessions(ids[ok], ts[ok], vals[ok]).items()
            }
        else:
            want = _window_oracle(data, ids[ok], ts[ok], vals[ok], WINDOW_KEYS)
        _OPS_DATA[key] = (ids_b, ts_b, deci_b, int(late_rows.sum()), want)
    return _OPS_DATA[key]


def _ops_window_run(card: dict, case: str, data: str, n_batches: int, n: int, seed: int,
                    form: str = "columnar") -> dict:
    """One windowed operator through ``run_main`` over phase 6's data
    (``data``: its tumbling, sliding or session rows), held against the
    float64 oracle: counts, min and max exact; a mean, and a sum over
    its count, within ``MEAN_RTOL`` of the window's mean |value|.  A
    lowered run must fold on the card (launches, state on ``cuda``, no
    demotion); a run the port keeps on or moves to the host must fold
    nothing on the card.  Emits an ``operators`` line; returns the
    run with its windows (``cells``: station and window id, or for
    sessions station, open and close µs, to the value) and the oracle's
    count and mean |value| of each (``scale``)."""
    from datetime import datetime, timedelta, timezone

    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.testing import TestingSink

    session = "session" in case
    ids_b, ts_b, deci_b, n_late, want = _ops_data(data, n_batches, n, seed, session)
    vocab = np.array([f"station_{i:05d}" for i in range(WINDOW_KEYS)])
    align = datetime.fromtimestamp(_T0_US / 1e6, tz=timezone.utc)
    batches = _ops_batches(ids_b, ts_b, deci_b, vocab, align, form)
    source, emitted = _timed_source(batches)
    meta_sink, metas = _timed_sink()
    flow = Dataflow(f"operators_{case}")
    s = op.input("inp", flow, source)
    wo, lowered = _ops_window(case, s, align)
    down, late = [], []
    op.output("down", wo.down, TestingSink(down))
    op.output("late", wo.late, TestingSink(late))
    op.output("meta", wo.meta, meta_sink)

    demoted = _demotions()
    states, timers, undo = _recording_states(timed=("_scatter",))
    try:
        run = _run_flow(flow)
    finally:
        undo()
    folds = sum(t["_scatter"].calls for t in timers)
    if lowered:
        _require_launches(run["launches"], case)
        if len(states) != 1 or states[0].device.type != DEV or not folds:
            msg = f"{case}: no fold on cuda: {[s.device for s in states]}, {folds} folds"
            raise AssertionError(msg)
        if _demotions() != demoted:
            msg = f"{case}: the lowered step was demoted to the host tier"
            raise AssertionError(msg)
    elif run["launches"] or folds:
        # A run that falls back at its first delivery may have built
        # its window state, but folds nothing into it.
        msg = f"{case}: a host run folded on the card ({folds} folds, {run['launches']} launches)"
        raise AssertionError(msg)

    expand = 10 if data == "sliding" else 1
    if len(late) != n_late * expand:
        msg = f"{case}: {len(late)} late events, oracle {n_late} × {expand}"
        raise AssertionError(msg)
    meta_of = {(k, wid): m for _wall, (k, (wid, m)) in metas}
    if len(meta_of) != len(down):
        msg = f"{case}: {len(down)} closes but {len(meta_of)} metadata events"
        raise AssertionError(msg)

    def us(dt):
        return (dt - align) // timedelta(microseconds=1) + _T0_US

    if session:
        cells = {
            (int(k[8:]), us(meta_of[(k, wid)].open_time), us(meta_of[(k, wid)].close_time)): v
            for k, (wid, v) in down
        }
    else:
        cells = {(int(k[8:]), wid): v for k, (wid, v) in down}
    if len(cells) != len(down) or set(cells) != set(want):
        msg = f"{case}: {len(cells)} windows out, {len(want)} expected"
        raise AssertionError(msg)
    worst = 0.0
    scale = {}
    for cell, w in want.items():
        got, where = cells[cell], f"{case} window {cell}"
        if session:
            mean, count, mean_abs = w
        else:
            mn, mean, mx, count, mean_abs = w
        scale[cell] = (count, mean_abs)
        if case.startswith("reduce_m"):
            if got != (mn if "min" in case else mx):
                msg = f"{where}: {got} != {(mn, mx)}"
                raise AssertionError(msg)
            continue
        if case == "fold_mean_tumbling":
            total, got_count = got
            if got_count != count:
                msg = f"{where}: count {got_count} != {count}"
                raise AssertionError(msg)
            got = total / got_count
        elif case != "mean_window_session":
            got = got / count  # a sum, checked as its mean
        worst = max(worst, _check_mean(got, mean, mean_abs, where))

    lats = _close_latencies(
        "session" if session else data, metas, ids_b, ts_b, emitted, WINDOW_KEYS, align
    )
    _emit(
        card,
        "operators",
        case=case,
        tier="device" if lowered else "host",
        rows_form=form,
        rows=n * n_batches,
        batches=n_batches,
        stations=WINDOW_KEYS,
        windows_closed=len(down),
        late_events=len(late),
        seconds=run["seconds"],
        rows_per_s=n * n_batches / run["seconds"],
        kernel_launches=run["launches"],
        p99_close_latency_s=lats[int(len(lats) * 0.99)] if lats else None,
        closes_timed=len(lats),
        max_mean_rel_err=worst,
        states_built=len(states),
        device_folds=folds,
        phase_seconds=run["phase_seconds"],
    )
    return dict(run, cells=cells, scale=scale)


def _ops_same_windows(fallback: str, host: dict, lowered: str, dev: dict) -> float:
    """A fall-back run's windows against the lowered run's on the same
    rows: the same windows, each sum within ``MEAN_RTOL`` of the
    window's mean |value| over its count."""
    if set(host["cells"]) != set(dev["cells"]):
        msg = f"{fallback}: {len(host['cells'])} windows, {len(dev['cells'])} in {lowered}"
        raise AssertionError(msg)
    worst = 0.0
    for cell, (count, mean_abs) in dev["scale"].items():
        worst = max(
            worst,
            _check_mean(
                host["cells"][cell] / count,
                dev["cells"][cell] / count,
                mean_abs,
                f"{fallback} against {lowered}, window {cell}",
            ),
        )
    return worst


def _ops_final_run(card: dict, kind: str, n_batches: int, n: int, seed: int) -> int:
    """``reduce_final(xla.MIN or MAX)`` with no window over phase 6's
    dictionary-encoded tumbling batches (the station ids and the int16
    values, no ``ts``), every station's result exact against the
    float32 product the fixed-point fold computes (``float32(q) *
    float32(0.1)``, monotonic in ``q``); returns the launches."""
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.testing import TestingSink

    ids_b, _ts_b, deci_b = _window_data("tumbling", n_batches, n, WINDOW_KEYS, seed)
    vocab = np.array([f"station_{i:05d}" for i in range(WINDOW_KEYS)])
    batches = [
        ArrayBatch({"key_id": i, "value": d}, key_vocab=vocab, value_scale=0.1)
        for i, d in zip(ids_b, deci_b)
    ]
    source, _emitted = _timed_source(batches)
    flow = Dataflow(f"operators_final_{kind}")
    s = op.input("inp", flow, source)
    s = op.reduce_final("r", s, getattr(xla, kind.upper()))
    out = []
    op.output("out", s, TestingSink(out))
    demoted = _demotions()
    states, _timers, undo = _recording_states()
    try:
        run = _run_flow(flow)
    finally:
        undo()
    case = f"reduce_final_{kind}"
    _require_launches(run["launches"], case)
    if len(states) != 1 or states[0].device.type != DEV or _demotions() != demoted:
        msg = f"{case}: state not on cuda, or demoted: {[s.device for s in states]}"
        raise AssertionError(msg)
    ids = np.concatenate(ids_b)
    q = np.concatenate(deci_b).astype(np.int64)
    pick = np.full(WINDOW_KEYS, 1 << 20 if kind == "min" else -(1 << 20), dtype=np.int64)
    (np.minimum if kind == "min" else np.maximum).at(pick, ids, q)
    seen = np.bincount(ids, minlength=WINDOW_KEYS) > 0
    want = {
        str(vocab[i]): float(np.float32(pick[i]) * np.float32(0.1))
        for i in np.flatnonzero(seen).tolist()
    }
    got = dict(out)
    if len(got) != len(out) or got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])[:3]
        msg = f"{case}: {len(got)} stations out, {len(want)} expected; differ at {bad}"
        raise AssertionError(msg)
    _emit(
        card,
        "operators",
        case=case,
        tier="device",
        rows_form="columnar",
        rows=n * n_batches,
        batches=n_batches,
        stations=len(want),
        seconds=run["seconds"],
        rows_per_s=n * n_batches / run["seconds"],
        kernel_launches=run["launches"],
        table_capacity=states[0].capacity,
        phase_seconds=run["phase_seconds"],
    )
    return run["launches"]


def _ops_host_runs(card: dict) -> dict:
    """``join``, ``join_window`` (tumbling) and ``collect_window``
    (tumbling) over ``OPS_HOST_ROWS`` keyed rows on the card's host,
    each equal to a Python oracle, each launching the fold kernel no
    time; returns their launches."""
    from collections import defaultdict
    from datetime import datetime, timedelta, timezone

    import numpy as np

    import bytewax_tpu_torch.operators as op
    import bytewax_tpu_torch.operators.windowing as win
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.testing import TestingSink, TestingSource

    n = OPS_HOST_ROWS
    rng = np.random.RandomState(141)
    keys = [f"k{i:05d}" for i in range(n)]
    left = [(keys[i], i) for i in rng.permutation(n).tolist()]
    right = [(keys[i], -i) for i in rng.permutation(n).tolist() if i % 7]
    # Keyed rows (station, (event time, i)), event times rising over
    # four minutes, and a side of the window join for each.
    align = datetime.fromtimestamp(_T0_US / 1e6, tz=timezone.utc)
    step = 4 * _MINUTE_US // n
    rows = [
        (f"station_{k:05d}", (align + timedelta(microseconds=i * step), i))
        for i, k in enumerate(rng.randint(0, WINDOW_KEYS, size=n).tolist())
    ]
    sides = (rng.rand(n) < 0.5).astype(int).tolist()
    # The two sides of the join arrive through two inputs polled in
    # turn: a wait past the data's four minutes keeps either from
    # running the other's rows late, so every window closes at EOF.
    wait = timedelta(minutes=10)
    tumbling = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)

    def clock():
        return win.EventClock(ts_getter=lambda v: v[0], wait_for_system_duration=wait)

    def wid(v):
        return (v[0] - align) // timedelta(minutes=1)

    cells = defaultdict(list)
    last = defaultdict(lambda: [None, None])
    for (k, v), side in zip(rows, sides):
        cells[(k, wid(v))].append(v[1])
        last[(k, wid(v))][side] = v[1]

    def join_flow(out):
        flow = Dataflow("operators_join")
        lefts = op.input("l", flow, TestingSource(left, batch_size=4096))
        rights = op.input("r", flow, TestingSource(right, batch_size=4096))
        op.output("out", op.join("join", lefts, rights), TestingSink(out))
        return flow, sorted((keys[i], (i, -i)) for i in range(n) if i % 7), sorted

    def join_window_flow(out):
        flow = Dataflow("operators_join_window")
        inputs = [
            op.input(f"side{j}", flow, TestingSource(
                [r for r, side in zip(rows, sides) if side == j], batch_size=4096
            ))
            for j in (0, 1)
        ]
        wo = win.join_window("jw", clock(), tumbling, *inputs)
        op.output("out", wo.down, TestingSink(out))
        want = sorted((k, (w, tuple(last[(k, w)]))) for k, w in last)

        def shape(got):
            return sorted(
                (k, (w, tuple(None if v is None else v[1] for v in row))) for k, (w, row) in got
            )

        return flow, want, shape

    def collect_window_flow(out):
        flow = Dataflow("operators_collect_window")
        s = op.input("inp", flow, TestingSource(rows, batch_size=4096))
        wo = win.collect_window("cw", s, clock(), tumbling)
        op.output("out", wo.down, TestingSink(out))
        want = sorted((k, (w, vals)) for (k, w), vals in cells.items())

        def shape(got):
            return sorted((k, (w, [v[1] for v in vals])) for k, (w, vals) in got)

        return flow, want, shape

    launches = {}
    for name, build in (
        ("join", join_flow),
        ("join_window", join_window_flow),
        ("collect_window", collect_window_flow),
    ):
        out = []
        flow, want, shape = build(out)
        states, _timers, undo = _recording_states()
        try:
            run = _run_flow(flow)
        finally:
            undo()
        if shape(out) != want:
            msg = f"{name}: {len(out)} rows out, {len(want)} expected, or they differ"
            raise AssertionError(msg)
        if run["launches"] or states:
            msg = f"{name}: a host operator folded on the card"
            raise AssertionError(msg)
        rows_in = len(left) + len(right) if name == "join" else n
        _emit(
            card,
            "operators",
            case=name,
            tier="host",
            rows=rows_in,
            rows_out=len(out),
            seconds=run["seconds"],
            rows_per_s=rows_in / run["seconds"],
            kernel_launches=run["launches"],
            phase_seconds=run["phase_seconds"],
        )
        launches[name] = run["launches"]
    return launches


def phase_operators(card: dict) -> dict:
    """Phase 14: the public window and keyed operators that lower to
    the fold kernel at full width, the fall-backs the reference
    defines (each launching the kernel no time and equal to the
    lowered output on the same rows), and host operators on the card's
    host; returns each run's fold launches.  Fails past
    ``OPS_BUDGET_S``."""
    t0 = time.perf_counter()
    launches = {}
    for case, data, n_batches, seed in OPS_LOWERED:
        run = _ops_window_run(card, case, data, n_batches, WINDOW_BATCH_ROWS, seed)
        launches[case] = run["launches"]
    _OPS_DATA.clear()
    for kind in ("min", "max"):
        launches[f"reduce_final_{kind}"] = _ops_final_run(
            card, kind, OPS_FINAL_BATCHES, WINDOW_BATCH_ROWS, seed=147
        )
    small = {}
    for case, form in (
        ("sum_tumbling", "columnar"),
        ("sum_items_promoted", "tsvalue"),
        ("sum_session", "columnar"),
        ("plain_folder", "columnar"),
        ("sum_items_unpromotable", "reading"),
        ("session_custom_merger", "columnar"),
    ):
        small[case] = _ops_window_run(
            card, case, "tumbling", OPS_SMALL_BATCHES, OPS_SMALL_ROWS, seed=148, form=form
        )
        launches[case] = small[case]["launches"]
    worst = {
        case: _ops_same_windows(case, small[case], lowered, small[lowered])
        for case, lowered in OPS_FALLBACKS + (("sum_items_promoted", "sum_tumbling"),)
    }
    _OPS_DATA.clear()
    launches.update(_ops_host_runs(card))
    seconds = time.perf_counter() - t0
    _emit(card, "operators_phase", phase_seconds=seconds, budget_s=OPS_BUDGET_S,
          fallback_max_mean_rel_err=worst, launches=launches)
    if seconds > OPS_BUDGET_S:
        msg = f"phase 14 took {seconds:.1f} s, over its {OPS_BUDGET_S} s budget"
        raise AssertionError(msg)
    return launches


# -- phase 15 ----------------------------------------------------------------

#: Phase 15's station dictionary; the ring the hot band advances
#: around, the band, its step a batch and its share of a batch's rows
#: (the rest are uniform over the dictionary).  The band would come
#: back to the ring's first keys in batch 15 (half of it) and wholly
#: from batch ``RES_RING // RES_STEP`` = 16 on.
RES_KEYS = 1 << 20
RES_RING = 1 << 18
RES_BAND = 1 << 15
RES_STEP = 1 << 14
RES_HOT_SHARE = 0.98
RES_ROWS = 1 << 18
#: Batches of the budgeted fold, of the crash run and the epoch it
#: aborts at, and of the scan and sharded runs.  Cut from 24, 24 (12),
#: 8 and 8 to fit the phase's 90 s on the H100's host with room for a
#: slower host, where a batch that spills costs 4-5 s (one SQLite
#: statement a key spilled or read back): the fold's last 2 batches
#: spill, and the uniform rows read spilled keys back from disk, but
#: the band does not come back; the other runs stay before the spill.
RES_BATCHES = 10
RES_CRASH_BATCHES = 6
RES_CRASH_EPOCH = 3
RES_SCAN_BATCHES = 4
RES_SHARD_BATCHES = 4
#: Device-resident and host-resident key budgets a step.
RES_BUDGET = 65536
RES_HOST_BUDGET = 131072
#: The restore-fault run: 2^16 rows in 16 batches, all from a band
#: small enough that its keys reach all three tiers before the band
#: comes back (at batch 15) and the first restore fails.
RES_FAULT_BATCHES = 16
RES_FAULT_ROWS = 1 << 12
RES_FAULT_BUDGET = 1024
RES_FAULT_RING = 4096
RES_FAULT_BAND = 512
RES_FAULT_STEP = 256
#: The coalescer runs: 1BRC rows, rows a source batch, stations.
COALESCE_ROWS = 1 << 22
COALESCE_BATCH_ROWS = 1 << 12
COALESCE_STATIONS = 10_000
RES_BUDGET_S = 90.0

_RES_VOCAB = []


def _res_vocab():
    """The phase's dictionary of ``RES_KEYS`` station names (made once)."""
    import numpy as np

    if not _RES_VOCAB:
        _RES_VOCAB.append(np.array([f"station_{i:07d}" for i in range(RES_KEYS)]))
    return _RES_VOCAB[0]


def _band_ids(n_batches: int, rows: int, seed: int, ring=None, band=None, step=None, hot_share=None):
    """Per-batch station ids: ``hot_share`` of each batch's rows from
    the hot band (``band`` keys from ``b * step``, modulo ``ring``; by
    default the phase's), the rest uniform over ``RES_KEYS``."""
    import numpy as np

    ring, band, step = ring or RES_RING, band or RES_BAND, step or RES_STEP
    share = RES_HOT_SHARE if hot_share is None else hot_share
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n_batches):
        hot = rng.rand(rows) < share
        in_band = (b * step + rng.randint(0, band, rows)) % ring
        out.append(np.where(hot, in_band, rng.randint(0, RES_KEYS, rows)).astype(np.int32))
    return out


def _band_batches(n_batches: int, rows: int, seed: int, **shape):
    """Band traffic as dictionary-encoded batches of float32
    one-decimal readings; returns the batches and their float64
    oracle."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch

    ids_b = _band_ids(n_batches, rows, seed, **shape)
    rng = np.random.RandomState(seed + 1)
    vals_b = [np.round(rng.randn(rows) * 10.0 + 12.0, 1).astype(np.float32) for _ in ids_b]
    vocab = _res_vocab()
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in zip(ids_b, vals_b)]
    return batches, _res_oracle(ids_b, vals_b)


def _res_oracle(ids_b, vals_b) -> dict:
    """Per-station count, sum, min and max in float64, and the rows'
    mean absolute value (the scale of a float32 sum's error)."""
    import numpy as np

    ids = np.concatenate(ids_b)
    vals = np.concatenate(vals_b).astype(np.float64)
    # Rows sorted by (station, value): each station's first and last
    # row hold its min and max.
    order = np.lexsort((vals, ids))
    ids_s, vals_s = ids[order], vals[order]
    heads = np.flatnonzero(np.r_[True, ids_s[1:] != ids_s[:-1]])
    tails = np.r_[heads[1:] - 1, len(ids_s) - 1]
    mn = np.full(RES_KEYS, np.inf)
    mx = np.full(RES_KEYS, -np.inf)
    mn[ids_s[heads]] = vals_s[heads]
    mx[ids_s[tails]] = vals_s[tails]
    return {
        "count": np.bincount(ids, minlength=RES_KEYS),
        "sum": np.bincount(ids, weights=vals, minlength=RES_KEYS),
        "min": mn,
        "max": mx,
        "scale": float(np.abs(vals).mean()),
    }


def _res_finals(finals) -> dict:
    """``stats`` finals ``[(station, (min, mean, max, count))]`` as
    columns indexed by station id."""
    import numpy as np

    n = len(finals)
    ids = np.fromiter((int(k[len("station_"):]) for k, _v in finals), dtype=np.int64, count=n)
    cols = np.array([v for _k, v in finals], dtype=np.float64).reshape(n, 4)
    return {"ids": ids, "min": cols[:, 0], "mean": cols[:, 1], "max": cols[:, 2], "count": cols[:, 3]}


def _check_res_finals(finals, want: dict, where: str) -> float:
    """The finals of a budgeted run against the float64 oracle: every
    station once, counts, min and max exact, means within
    ``MEAN_RTOL`` of the rows' mean |value|; returns the worst mean
    error in that unit."""
    import numpy as np

    got = _res_finals(finals)
    live = np.flatnonzero(want["count"])
    order = np.argsort(got["ids"])
    ids = got["ids"][order]
    if not np.array_equal(ids, live):
        msg = f"{where}: {len(ids)} stations out ({len(np.unique(ids))} distinct), {len(live)} expected"
        raise AssertionError(msg)
    for name in ("count", "min", "max"):
        bad = np.flatnonzero(got[name][order] != want[name][live])
        if len(bad):
            i = live[bad[0]]
            msg = f"{where}: {len(bad)} stations' {name} differ (station {i}: {got[name][order][bad[0]]} vs {want[name][i]})"
            raise AssertionError(msg)
    err = np.abs(got["mean"][order] - want["sum"][live] / want["count"][live]) / want["scale"]
    worst = float(err.max())
    if not worst <= MEAN_RTOL:
        msg = f"{where}: a mean is off by {worst} of the mean |value|"
        raise AssertionError(msg)
    return worst


def _check_res_same(finals, other, where: str) -> float:
    """Two budgeted runs' finals over the same rows: the same stations,
    counts, min and max, and means within ``MEAN_RTOL`` of each other
    relative to the larger |mean| (float32 sums fold in another order
    on each tier)."""
    import numpy as np

    a, b = _res_finals(finals), _res_finals(other)
    oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
    if not np.array_equal(a["ids"][oa], b["ids"][ob]):
        raise AssertionError(f"{where}: the two runs' stations differ")
    for name in ("count", "min", "max"):
        if not np.array_equal(a[name][oa], b[name][ob]):
            raise AssertionError(f"{where}: {name} differs between the runs")
    scale = np.maximum(1.0, np.maximum(np.abs(a["mean"][oa]), np.abs(b["mean"][ob])))
    worst = float((np.abs(a["mean"][oa] - b["mean"][ob]) / scale).max())
    if not worst <= MEAN_RTOL:
        raise AssertionError(f"{where}: means differ by {worst} between the runs")
    return worst


def _check_rounded(out, finals, where: str) -> None:
    """``brc_flow_columnar``'s rounded rows are the captured finals,
    rounded, one a station."""
    got = dict(out)
    if len(got) != len(out) or len(got) != len(finals):
        raise AssertionError(f"{where}: {len(out)} rows out for {len(finals)} stations")
    for key, (mn, mean, mx, _count) in finals:
        if got.get(key) != (round(mn, 1), round(mean, 1), round(mx, 1)):
            raise AssertionError(f"{where}, {key}: {got.get(key)} out of {(mn, mean, mx)}")


class _Residency:
    """For one run: what the residency managers return from
    ``finalize``, the spilled keys read back to the card (spill-store
    reads inside ``prepare``), the tiers' sizes when a demotion drains
    them, and the seconds of ``load_many`` (a resume's install) —
    by wrapping those methods for a ``with`` block.  Every peak
    resident-key counter is set back to 0 on the way in, so the block
    reads its own runs' peaks."""

    def __enter__(self):
        from bytewax_tpu_torch.engine import flight
        from bytewax_tpu_torch.engine.residency import ResidentKeyState, SpillStore

        for key in [k for k in flight.RECORDER.counters if k.startswith("state_resident_keys_peak[")]:
            del flight.RECORDER.counters[key]
        self.finals, self.drained = [], []
        self.disk_restores = 0
        self.load_many_s = 0.0
        self._saved = [
            (ResidentKeyState, name, ResidentKeyState.__dict__[name])
            for name in ("finalize", "prepare", "demotion_snapshots", "load_many")
        ] + [(SpillStore, "get", SpillStore.__dict__["get"])]
        orig = {name: fn for _cls, name, fn in self._saved}
        probe = self
        inside = []

        def finalize(state):
            out = orig["finalize"](state)
            probe.finals.extend(out)
            return out

        def prepare(state, *args, **kwargs):
            inside.append(True)
            try:
                return orig["prepare"](state, *args, **kwargs)
            finally:
                inside.pop()

        def get(store, key):
            if inside:
                probe.disk_restores += 1
            return orig["get"](store, key)

        def demotion_snapshots(state):
            probe.drained.append(state.status())
            return orig["demotion_snapshots"](state)

        def load_many(state, items):
            t0 = time.perf_counter()
            try:
                return orig["load_many"](state, items)
            finally:
                probe.load_many_s += time.perf_counter() - t0

        ResidentKeyState.finalize = finalize
        ResidentKeyState.prepare = prepare
        ResidentKeyState.demotion_snapshots = demotion_snapshots
        ResidentKeyState.load_many = load_many
        SpillStore.get = get
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        return False

    @staticmethod
    def peak() -> int:
        from bytewax_tpu_torch.engine import flight

        return max(
            (v for k, v in flight.RECORDER.counters.items() if k.startswith("state_resident_keys_peak[")),
            default=0,
        )


def _res_knobs(root: Path, name: str, budget=None, host_budget=None, **extra) -> dict:
    """The residency settings of one run (by default the phase's
    budgets), its spill files under ``root`` (local disk)."""
    return {
        "BYTEWAX_TPU_STATE_BUDGET": str(budget or RES_BUDGET),
        "BYTEWAX_TPU_HOST_STATE_BUDGET": str(host_budget or RES_HOST_BUDGET),
        "BYTEWAX_TPU_SPILL_DIR": str(root / f"spill_{name}"),
        **extra,
    }


def _res_run(card: dict, name: str, flow, rows: int, knobs: dict, tier: str = "single", db=None,
             demote: bool = False) -> dict:
    """Run ``flow`` once under ``knobs`` (with a store in ``db``, one
    epoch a batch; without one, the default epoch interval: a close
    with no store still reads, then drops, every touched key's
    snapshot); check that its one device state stayed on the card, on
    the tier asked for, that it launched its kernels, held the budget
    at every drain point, and demoted (only where ``demote``); return
    its ``residency`` line with the finals and the demotion's tiers."""
    from datetime import timedelta

    from bytewax_tpu_torch.recovery import RecoveryConfig

    demoted_before = _demotions()
    kwargs = {}
    if db is not None:
        kwargs = {"epoch_interval": timedelta(0), "recovery_config": RecoveryConfig(str(db))}
    states, _timers, undo = _recording_states()
    try:
        with _Knobs(**knobs), _Tier(tier, "cuda:0"), _Residency() as res, _StoreProbe() as probe:
            run = _run_flow(flow, **kwargs)
            peak = res.peak()
    finally:
        undo()
    demoted = _demotions() - demoted_before
    if demoted != (1 if demote else 0):
        raise AssertionError(f"{name}: {demoted} steps demoted to the host tier")
    if len(states) != 1:
        raise AssertionError(f"{name}: {len(states)} device states")
    state = states[0]
    devices = state.mesh.devices if tier == "sharded" else [state.device]
    if any(d.type != DEV for d in devices) or type(state).__name__.startswith("Sharded") != (tier == "sharded"):
        raise AssertionError(f"{name}: {type(state).__name__} on {devices}")
    if run["launches"] <= 0:
        raise AssertionError(f"{name}: the segment-fold kernel was launched no time")
    if (run["bucket_launches"] > 0) != (tier == "sharded"):
        raise AssertionError(f"{name}: shard_bucket launched {run['bucket_launches']} times")
    budget = int(knobs["BYTEWAX_TPU_STATE_BUDGET"])
    if not 0 < peak <= budget:
        raise AssertionError(f"{name}: {peak} keys resident at a drain point, budget {budget}")
    counters = run["counters"]
    line = {
        "flow": name,
        "tier": tier,
        "rows": rows,
        "seconds": run["seconds"],
        "rows_per_s": rows / run["seconds"],
        "fold_launches": run["launches"],
        "scan_launches": run["scan_launches"],
        "bucket_launches": run["bucket_launches"],
        "budget": budget,
        "host_budget": int(knobs["BYTEWAX_TPU_HOST_STATE_BUDGET"]),
        "peak_resident_keys": peak,
        "evictions": counters.get("state_evictions_count", 0),
        "restores": counters.get("residency_restore_count", 0),
        "disk_restores": res.disk_restores,
        "spill_bytes": counters.get("state_spill_bytes", 0),
        "evict_s": run["phase_seconds"].get("evict", 0.0),
        "restore_s": run["phase_seconds"].get("restore", 0.0),
        "step_demotions": demoted,
        "drained_tiers": res.drained,
        "table_capacity": getattr(state, "capacity", None),
        "phase_seconds": run["phase_seconds"],
    }
    if db is not None:
        line.update(probe.numbers(), resident_load_many_s=res.load_many_s)
    return dict(line, finals=res.finals, run=run)


def _res_emit(card: dict, line: dict, **extra) -> dict:
    shown = {k: v for k, v in line.items() if k not in ("finals", "run")}
    _emit(card, "residency", **shown, **extra)
    return line


def _res_fold(card: dict, root: Path, batches, want: dict) -> dict:
    """15.1: the budgeted fold over every batch: exact against the
    oracle, one fold a batch, evictions, restores from the host and
    from disk, and spill bytes."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow_columnar
    from bytewax_tpu_torch.testing import TestingSink

    out = []
    flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
    line = _res_run(card, "budgeted_fold", flow, RES_ROWS * len(batches), _res_knobs(root, "fold"))
    if line["fold_launches"] != len(batches):
        raise AssertionError(f"budgeted fold: {line['fold_launches']} folds for {len(batches)} batches")
    for what in ("evictions", "restores", "disk_restores", "spill_bytes"):
        if not line[what] > 0:
            raise AssertionError(f"budgeted fold: {what} {line[what]}")
    worst = _check_res_finals(line["finals"], want, "budgeted fold")
    _check_rounded(out, line["finals"], "budgeted fold")
    return _res_emit(card, line, max_abs_mean_err=worst, batches=len(batches))


def _res_scan(card: dict, root: Path, times: dict) -> dict:
    """15.2: ``anomaly_flow`` over band traffic at ``RES_KEYS`` sensors
    under the budget, held against phase 8's float64 oracle (on the
    sensors the traffic touches)."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.anomaly import anomaly_flow
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    ids_b = _band_ids(RES_SCAN_BATCHES, RES_ROWS, seed=152)
    touched, compact = np.unique(np.concatenate(ids_b), return_inverse=True)
    compact_b = np.split(compact.astype(np.int32), np.cumsum([len(b) for b in ids_b])[:-1])
    data = _make_anomaly_data(RES_SCAN_BATCHES, RES_ROWS, len(touched), 153, ids_b=compact_b)
    vocab = _res_vocab()
    index = {name: i for i, name in enumerate(vocab[touched].tolist())}
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in zip(ids_b, data["vals_b"])]
    rows = RES_ROWS * RES_SCAN_BATCHES
    with _Knobs(**_res_knobs(root, "scan")), _Residency() as res:
        run = _scan_flow_case(
            card, "budgeted_anomaly_flow",
            lambda sink: anomaly_flow(ArrayBatchSource(batches), sink, threshold=THRESHOLD),
            data, "zscore", slice(0, rows), index, times["welford"]["ms"], phase="residency",
        )
        peak = res.peak()
    evictions = run["counters"].get("state_evictions_count", 0)
    restores = run["counters"].get("residency_restore_count", 0)
    if not (evictions > 0 and restores > 0 and 0 < peak <= RES_BUDGET):
        raise AssertionError(f"budgeted scan: {evictions} evictions, {restores} restores, peak {peak}")
    _emit(card, "residency", flow="budgeted_anomaly_flow", rows=rows, rows_per_s=rows / run["seconds"],
          scan_launches=run["scan_launches"], peak_resident_keys=peak, evictions=evictions,
          restores=restores, disk_restores=res.disk_restores,
          spill_bytes=run["counters"].get("state_spill_bytes", 0),
          evict_s=run["phase_seconds"].get("evict", 0.0), sensors=len(touched))
    return run


def _res_sharded(card: dict, root: Path, batches) -> dict:
    """15.3: the budgeted fold over ``RES_SHARD_BATCHES`` batches on 4
    shards of the card and on the single-device tier: the same
    finals, each exact against the oracle."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow_columnar
    from bytewax_tpu_torch.testing import TestingSink

    some = batches[:RES_SHARD_BATCHES]
    want = _res_oracle([b.cols["key_id"] for b in some], [b.cols["value"] for b in some])
    rows = RES_ROWS * len(some)
    lines = {}
    for tier in ("sharded", "single"):
        out = []
        flow = brc_flow_columnar(ArrayBatchSource(some), TestingSink(out))
        line = _res_run(card, f"budgeted_fold_{tier}_{len(some)}", flow, rows, _res_knobs(root, tier), tier=tier)
        line["max_abs_mean_err"] = _check_res_finals(line["finals"], want, f"budgeted {tier}")
        _check_rounded(out, line["finals"], f"budgeted {tier}")
        lines[tier] = line
    line = lines["sharded"]
    line["max_mean_diff_to_single"] = _check_res_same(line["finals"], lines["single"]["finals"], "sharded against single")
    _res_emit(card, lines["single"])
    _res_emit(card, line, single_rows_per_s=lines["single"]["rows_per_s"], shards=SHARDS)
    return {"fold": line["fold_launches"], "bucket": line["bucket_launches"],
            "single_fold": lines["single"]["fold_launches"]}


def _res_crash(card: dict, root: Path, batches) -> dict:
    """15.4: the budgeted fold over the first ``RES_CRASH_BATCHES``
    batches with a recovery store, one epoch a batch, aborted before
    batch ``RES_CRASH_EPOCH`` and resumed: exactly once against the
    oracle."""
    from bytewax_tpu_torch.engine.xla import DeviceAggState
    from bytewax_tpu_torch.models.brc import brc_flow_columnar
    from bytewax_tpu_torch.testing import TestingSink

    batches = batches[:RES_CRASH_BATCHES]
    want = _res_oracle([b.cols["key_id"] for b in batches], [b.cols["value"] for b in batches])
    db = _fresh_store(root, "residency_store")
    source = _batch_source(batches, aborts=[RES_CRASH_EPOCH])
    out = []
    flow = brc_flow_columnar(source, TestingSink(out))
    first = _res_run(card, "budgeted_store_aborted", flow, RES_ROWS * RES_CRASH_EPOCH,
                     _res_knobs(root, "crash"), db=db)
    if out or first["finals"]:
        raise AssertionError("budgeted store run: output before the abort")
    _res_emit(card, first)
    # Time to recover: the resumed run's start to its first fold.
    fold = DeviceAggState.update_batch
    started, first_fold = [0.0], []

    def timed_fold(state, batch):
        if not first_fold:
            first_fold.append(time.perf_counter() - started[0])
        return fold(state, batch)

    DeviceAggState.update_batch = timed_fold
    try:
        flow = brc_flow_columnar(source, TestingSink(out))
        started[0] = time.perf_counter()
        resumed = _res_run(card, "budgeted_store_resumed", flow, RES_ROWS * (len(batches) - RES_CRASH_EPOCH),
                           _res_knobs(root, "crash"), db=db)
    finally:
        DeviceAggState.update_batch = fold
    if resumed["fold_launches"] != len(batches) - RES_CRASH_EPOCH:
        raise AssertionError(f"budgeted store resume: {resumed['fold_launches']} folds")
    if not resumed["resume_rows_read"]:
        raise AssertionError("budgeted store resume: read no state from the store")
    worst = _check_res_finals(resumed["finals"], want, "budgeted store resume")
    _check_rounded(out, resumed["finals"], "budgeted store resume")
    _res_emit(card, resumed, max_abs_mean_err=worst, time_to_recover_s=first_fold[0])
    return {"fold_launches": first["fold_launches"] + resumed["fold_launches"]}


def _res_faults(card: dict, root: Path) -> dict:
    """15.5: a small budgeted fold whose every restore fails
    (``residency_restore``): the step demotes once, after all three
    tiers hold keys, and its output equals the oracle."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow_columnar
    from bytewax_tpu_torch.testing import TestingSink

    batches, want = _band_batches(RES_FAULT_BATCHES, RES_FAULT_ROWS, seed=154, ring=RES_FAULT_RING,
                                  band=RES_FAULT_BAND, step=RES_FAULT_STEP, hot_share=1.0)
    out = []
    flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
    knobs = _res_knobs(root, "faults", budget=RES_FAULT_BUDGET, host_budget=RES_FAULT_BUDGET,
                       BYTEWAX_TPU_FAULTS="residency_restore:error:*")
    line = _res_run(card, "restore_faults", flow, RES_FAULT_ROWS * RES_FAULT_BATCHES, knobs, demote=True)
    (tiers,) = line["drained_tiers"]
    if not (tiers["resident"] > 0 and tiers["evicted"] > 0 and tiers["spilled"] > 0):
        raise AssertionError(f"restore faults: the demotion drained {tiers}")
    live = want["count"] > 0
    vocab = _res_vocab()
    rounded = {
        str(vocab[i]): (want["min"][i], want["sum"][i] / want["count"][i], want["max"][i])
        for i in live.nonzero()[0]
    }
    worst = _check_brc(out, rounded, "restore faults")
    return _res_emit(card, line, max_abs_mean_err=worst)


def _res_coalesce(card: dict) -> dict:
    """15.6: 1BRC rows as many small dictionary-encoded batches, at
    the default coalescing target and with coalescing off."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow_columnar, generate_batches
    from bytewax_tpu_torch.testing import TestingSink

    batches = generate_batches(COALESCE_ROWS, COALESCE_BATCH_ROWS, COALESCE_STATIONS, seed=155)
    # The oracle over the rows as one batch (its histogram is per batch).
    whole = ArrayBatch(
        {name: np.concatenate([b.cols[name] for b in batches]) for name in ("key_id", "value")},
        key_vocab=batches[0].key_vocab,
        value_scale=batches[0].value_scale,
    )
    want = _reference([whole], COALESCE_STATIONS)
    runs = {}
    for name, target in (("coalesced", None), ("uncoalesced", "0")):
        out = []
        flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
        states, _timers, undo = _recording_states()
        demoted_before = _demotions()
        try:
            with _Knobs(**({} if target is None else {"BYTEWAX_TPU_INGEST_TARGET_ROWS": target})):
                run = _run_flow(flow)
        finally:
            undo()
        if _demotions() != demoted_before or len(states) != 1 or states[0].device.type != DEV:
            raise AssertionError(f"coalescer {name}: demoted, or its state is not on the card")
        worst = _check_brc(out, want, f"coalescer {name}")
        runs[name] = dict(run, worst=worst)
    fewer, every = runs["coalesced"]["launches"], runs["uncoalesced"]["launches"]
    if every != len(batches) or not 0 < fewer <= len(batches) // 8:
        raise AssertionError(f"coalescer: {fewer} folds coalesced, {every} uncoalesced, {len(batches)} batches")
    polls = runs["coalesced"]["counters"].get("ingest_coalesced_polls", 0)
    _emit(card, "coalesce", rows=COALESCE_ROWS, batches=len(batches), batch_rows=COALESCE_BATCH_ROWS,
          stations=COALESCE_STATIONS, fold_launches=fewer, uncoalesced_fold_launches=every,
          ingest_coalesced_polls=polls,
          rows_per_s=COALESCE_ROWS / runs["coalesced"]["seconds"],
          uncoalesced_rows_per_s=COALESCE_ROWS / runs["uncoalesced"]["seconds"],
          max_abs_mean_err=max(r["worst"] for r in runs.values()),
          phase_seconds=runs["coalesced"]["phase_seconds"],
          uncoalesced_phase_seconds=runs["uncoalesced"]["phase_seconds"])
    return {"coalesced": fewer, "uncoalesced": every}


def phase_residency(card: dict, times: dict) -> dict:
    """Phase 15: key-state residency and the ingest coalescer on the
    card (``times``: phase 7's scan times); returns each run's
    launches of each kernel.  Fails past ``RES_BUDGET_S``."""
    import tempfile

    t0 = time.perf_counter()
    fold, scan, bucket, steps = {}, {}, {}, {}

    def step(name, fn, *args):
        s0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            steps[name] = time.perf_counter() - s0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_residency_") as tmp:
        root = Path(tmp)
        batches, want = step("data", _band_batches, RES_BATCHES, RES_ROWS, 150)
        fold["residency_fold"] = step("fold", _res_fold, card, root, batches, want)["fold_launches"]
        sharded = step("sharded", _res_sharded, card, root, batches)
        fold["residency_sharded"] = sharded["fold"]
        fold["residency_single"] = sharded["single_fold"]
        bucket["residency_sharded"] = sharded["bucket"]
        fold["residency_store"] = step("store", _res_crash, card, root, batches)["fold_launches"]
        del batches, want
        scan["residency_anomaly"] = step("scan", _res_scan, card, root, times)["scan_launches"]
        fold["residency_faults"] = step("faults", _res_faults, card, root)["fold_launches"]
    for name, n in step("coalesce", _res_coalesce, card).items():
        fold[f"coalesce_{name}"] = n
    seconds = time.perf_counter() - t0
    _emit(card, "residency_phase", phase_seconds=seconds, budget_s=RES_BUDGET_S, step_seconds=steps,
          launches={"segment_fold": fold, "segment_scan": scan, "shard_bucket": bucket})
    if seconds > RES_BUDGET_S:
        raise AssertionError(f"phase 15 took {seconds:.1f} s, over its {RES_BUDGET_S} s budget")
    return {"fold": fold, "scan": scan, "bucket": bucket}


# -- phase 16 -----------------------------------------------------------------

#: Phase 16: the 1BRC readings (dictionary-encoded stations, float32
#: one-decimal values): batches of the transient-fault, stop and
#: observed runs, rows a batch, stations.
RESIL_BATCHES = 8
RESIL_ROWS = 1 << 20
RESIL_KEYS = 10_000
#: The demotion runs: batches folded on the card before the faulting
#: epochs, then a tail of ``RESIL_TAIL_ROWS`` rows in
#: ``RESIL_TAIL_BATCHES`` batches (the host tier folds it a row at a
#: time), at each pipeline depth of ``RESIL_DEPTHS``.
RESIL_CARD_BATCHES = 6
RESIL_TAIL_ROWS = 1 << 16
RESIL_TAIL_BATCHES = 4
RESIL_DEPTHS = (1, 3)
#: Event-minute batches of the window run and 2^20-row batches of the
#: scan run on the card before their tails.
RESIL_WINDOW_BATCHES = 4
RESIL_SCAN_BATCHES = 4
#: The graceful stop is requested once this many epochs are durable.
RESIL_STOP_AFTER = 4
#: The connector edge: lines of 1BRC text, one in this many undecodable.
RESIL_LINES = 1 << 22
RESIL_POISON_EVERY = 1000
#: The observed run's API port (loopback only).
RESIL_API_PORT = 13316
RESIL_BUDGET_S = 90.0


def _resil_batches(n_batches: int, rows: int, seed: int):
    """1BRC readings as dictionary-encoded batches (int32 station ids,
    float32 one-decimal values over ``_res_vocab``'s first
    ``RESIL_KEYS`` names) and their per-batch columns."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch

    rng = np.random.RandomState(seed)
    ids_b = [rng.randint(0, RESIL_KEYS, rows).astype(np.int32) for _ in range(n_batches)]
    vals_b = [np.round(rng.randn(rows) * 10.0 + 12.0, 1).astype(np.float32) for _ in ids_b]
    vocab = _res_vocab()[:RESIL_KEYS]
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in zip(ids_b, vals_b)]
    return batches, ids_b, vals_b


def _resil_flow(source, out: list, flow_id: str = "brc"):
    """``brc_flow_columnar``'s fold (``xla.stats_final``), its finals
    ``(station, (min, mean, max, count))`` read before the rounding
    step, into ``out``."""
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.testing import TestingSink

    flow = Dataflow(flow_id)
    s = op.input("inp", flow, source)
    s = xla.stats_final("stats", s)
    op.output("out", s, TestingSink(out))
    return flow


class _Demotions:
    """For a ``with`` block: each demotion's kernel launches when it
    read the device state back (``demotion_snapshots``, after the
    pipeline's drain), the folds still in flight when it began, and
    the ``demotion`` events and metric it left."""

    def __enter__(self):
        from bytewax_tpu_torch.engine import scan_accel, window_accel
        from bytewax_tpu_torch.engine import xla as engine_xla
        from bytewax_tpu_torch.engine.driver import _StatefulBatchRt
        from bytewax_tpu_torch.ops import fold_kernel, scan_kernel

        self.at, self.in_flight = [], []
        self.t0 = time.time()
        self.metric0 = _demotions()
        probe = self
        self._saved = []
        for cls in (engine_xla.DeviceAggState, window_accel.DeviceWindowAggState, scan_accel.DeviceScanState):
            orig = cls.__dict__["demotion_snapshots"]
            self._saved.append((cls, "demotion_snapshots", orig))

            def snapshots(state, _orig=orig):
                probe.at.append({"fold": fold_kernel.launches, "scan": scan_kernel.launches,
                                 "state": type(state).__name__})
                return _orig(state)

            cls.demotion_snapshots = snapshots
        demote = _StatefulBatchRt.__dict__["_demote"]
        self._saved.append((_StatefulBatchRt, "_demote", demote))

        def demoting(rt, reason):
            pipe = getattr(rt, "_pipe", None)
            probe.in_flight.append(len(pipe) if pipe is not None else 0)
            return demote(rt, reason)

        _StatefulBatchRt._demote = demoting
        return self

    def __exit__(self, *exc):
        from bytewax_tpu_torch.engine import flight

        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self.events = [
            {"step": e["step"], "keys": e["keys"], "reason": e["reason"]}
            for e in flight.RECORDER.tail(1 << 16)
            if e["kind"] == "demotion" and e["t"] >= self.t0
        ]
        self.count = _demotions() - self.metric0
        return False


def _resil_run(name: str, flow, knobs: dict, db=None, demotions: int = 0) -> dict:
    """Run ``flow`` once, one epoch a batch (and a recovery store in
    ``db``) under ``knobs``; check every device state it built stayed
    on the card and that it demoted exactly ``demotions`` times (the
    planned ones); return ``_run_flow``'s record with its demotions
    and states."""
    from datetime import timedelta

    from bytewax_tpu_torch.recovery import RecoveryConfig

    kwargs = {"epoch_interval": timedelta(0)}
    if db is not None:
        kwargs["recovery_config"] = RecoveryConfig(str(db))
    states, _timers, undo = _recording_states()
    scan_states, undo_scan = _recording_device_states()
    knobs = {"BYTEWAX_FLIGHT_RECORDER": "1", "BYTEWAX_TPU_INGEST_TARGET_ROWS": "0", **knobs}
    try:
        with _Knobs(**knobs), _Demotions() as dem:
            run = _run_flow(flow, **kwargs)
    finally:
        undo()
        undo_scan()
    built = states + scan_states
    if not built or any(s.device.type != DEV for s in built):
        raise AssertionError(f"{name}: device states on {[s.device for s in built]}")
    if dem.count != demotions or len(dem.at) != demotions:
        raise AssertionError(f"{name}: {dem.count} demotions ({len(dem.at)} read-backs), {demotions} planned")
    return dict(run, dem=dem, states=built)


def _resil_emit(card: dict, case: str, run: dict, rows: int, **extra) -> None:
    counters = run["counters"]
    _emit(card, "resilience", case=case, rows=rows, seconds=run["seconds"],
          rows_per_s=rows / run["seconds"], fold_launches=run["launches"],
          scan_launches=run["scan_launches"], faults=counters.get("fault_injected_count", 0),
          io_retries=counters.get("io_retries_count", 0),
          restarts=counters.get("worker_restart_count", 0), demotions=run["dem"].count,
          demotion_events=run["dem"].events, phase_seconds=run["phase_seconds"], **extra)


def _planned_demotion(name: str, run: dict, launches_before: int, kernel: str, faults: int,
                      keys: int, step: str) -> None:
    """A run that must demote once: ``faults`` faults, one demotion of
    ``step`` migrating ``keys`` keys, read back after exactly
    ``launches_before`` launches of ``kernel``, and none after."""
    dem = run["dem"]
    got_faults = run["counters"].get("fault_injected_count", 0)
    launched = run["launches"] if kernel == "fold" else run["scan_launches"]
    if got_faults != faults or len(dem.events) != 1:
        raise AssertionError(f"{name}: {got_faults} faults, demotion events {dem.events}")
    if not dem.events[0]["step"].startswith(step) or dem.events[0]["keys"] != keys:
        raise AssertionError(f"{name}: demoted {dem.events[0]}, want {step} with {keys} keys")
    if dem.at[0][kernel] != launches_before or launched != launches_before:
        raise AssertionError(f"{name}: {dem.at[0][kernel]} launches before the demotion and "
                             f"{launched - dem.at[0][kernel]} after, want {launches_before} and 0")


def _resil_transient(card: dict, batches, want) -> int:
    """16.1: two transient device faults, retried in place."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    out = []
    run = _resil_run("transient", _resil_flow(ArrayBatchSource(batches), out),
                     {"BYTEWAX_TPU_FAULTS": "device_dispatch:error:3:x2", "BYTEWAX_TPU_DEMOTE_AFTER": "3"})
    faults = run["counters"].get("fault_injected_count", 0)
    if faults != 2 or run["launches"] != len(batches):
        raise AssertionError(f"transient faults: {faults} faults, {run['launches']} folds for {len(batches)} batches")
    worst = _check_res_finals(out, want, "transient faults")
    _resil_emit(card, "transient_device_faults", run, RESIL_ROWS * len(batches), max_abs_mean_err=worst,
                fault_spec="device_dispatch:error:3:x2", demote_after=3)
    return run["launches"]


def _resil_demote(card: dict, batches, ids_b, vals_b) -> dict:
    """16.2: the fold demoted mid-run with its state, at each depth."""
    from bytewax_tpu_torch.models.brc import ArrayBatchSource

    tail, tail_ids, tail_vals = _resil_batches(RESIL_TAIL_BATCHES, RESIL_TAIL_ROWS // RESIL_TAIL_BATCHES, 162)
    fed = batches[:RESIL_CARD_BATCHES] + tail
    want = _res_oracle(ids_b[:RESIL_CARD_BATCHES] + tail_ids, vals_b[:RESIL_CARD_BATCHES] + tail_vals)
    rows = RESIL_ROWS * RESIL_CARD_BATCHES + RESIL_TAIL_ROWS
    spec = f"device_dispatch:error:{RESIL_CARD_BATCHES + 1}+"
    launches = {}
    for depth in RESIL_DEPTHS:
        name = f"demotion_depth{depth}"
        out = []
        run = _resil_run(name, _resil_flow(ArrayBatchSource(fed), out),
                         {"BYTEWAX_TPU_FAULTS": spec, "BYTEWAX_TPU_DEMOTE_AFTER": "3",
                          "BYTEWAX_TPU_PIPELINE_DEPTH": str(depth)}, demotions=1)
        _planned_demotion(name, run, RESIL_CARD_BATCHES, "fold", 3, RESIL_KEYS, "brc.stats")
        worst = _check_res_finals(out, want, name)
        _resil_emit(card, name, run, rows, max_abs_mean_err=worst, fault_spec=spec, demote_after=3,
                    pipeline_depth=depth, launches_at_demotion=run["dem"].at[0]["fold"],
                    in_flight_at_demotion=run["dem"].in_flight[0], tail_rows=RESIL_TAIL_ROWS)
        launches[name] = run["launches"]
    return launches


def _resil_windows(card: dict) -> int:
    """16.3a: tumbling ``stats_window`` over phase 6's stations and
    event-minutes (values as float32), demoted with its open windows
    when the tail arrives."""
    from datetime import datetime, timedelta, timezone

    import numpy as np

    import bytewax_tpu_torch.operators as op
    import bytewax_tpu_torch.operators.windowing as win
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource
    from bytewax_tpu_torch.testing import TestingSink
    from bytewax_tpu_torch.xla import column_ts

    n_batches = RESIL_WINDOW_BATCHES + 1
    ids_b, ts_b, deci_b = _window_data("tumbling", n_batches, WINDOW_BATCH_ROWS, WINDOW_KEYS, seed=163)
    cut = slice(0, RESIL_TAIL_ROWS)
    ids_b[-1], ts_b[-1], deci_b[-1] = ids_b[-1][cut], ts_b[-1][cut], deci_b[-1][cut]
    vals_b = [(d * 0.1).astype(np.float32) for d in deci_b]
    vocab = np.array([f"station_{i:05d}" for i in range(WINDOW_KEYS)])
    batches = [ArrayBatch({"key_id": i, "ts": t, "value": v}, key_vocab=vocab)
               for i, t, v in zip(ids_b, ts_b, vals_b)]
    align = datetime.fromtimestamp(_T0_US / 1e6, tz=timezone.utc)
    clock = win.EventClock(ts_getter=column_ts, wait_for_system_duration=timedelta(seconds=WINDOW_WAIT_S))
    windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
    flow = Dataflow("resil_windows")
    s = op.input("inp", flow, ArrayBatchSource(batches))
    wo = win.stats_window("w", s, clock, windower)
    down, late = [], []
    op.output("down", wo.down, TestingSink(down))
    op.output("late", wo.late, TestingSink(late))
    spec = f"device_dispatch:error:{RESIL_WINDOW_BATCHES + 1}+"
    run = _resil_run("window_demotion", flow, {"BYTEWAX_TPU_FAULTS": spec, "BYTEWAX_TPU_DEMOTE_AFTER": "2"},
                     demotions=1)
    _planned_demotion("window demotion", run, RESIL_WINDOW_BATCHES, "fold", 2, WINDOW_KEYS, "resil_windows.w")
    dem = run["dem"]
    ids = np.concatenate(ids_b)
    ts = np.concatenate(ts_b)
    vals = np.concatenate(vals_b).astype(np.float64)
    late_rows = _late_oracle(ids, ts, WINDOW_WAIT_S * 1_000_000)
    want = _window_oracle("tumbling", ids[~late_rows], ts[~late_rows], vals[~late_rows], WINDOW_KEYS)
    if len(late) != int(late_rows.sum()):
        raise AssertionError(f"window demotion: {len(late)} late events, oracle {int(late_rows.sum())}")
    got = {(int(k[8:]), wid): value for k, (wid, value) in down}
    if len(got) != len(down) or set(got) != set(want):
        raise AssertionError(f"window demotion: {len(got)} windows out, {len(want)} expected")
    worst = 0.0
    for kw, (mn, mean, mx, count, mean_abs) in want.items():
        gmn, gmean, gmx, gcount = got[kw]
        if (gmn, gmx, gcount) != (mn, mx, count):
            raise AssertionError(f"window demotion, window {kw}: {got[kw]} != {want[kw]}")
        worst = max(worst, _check_mean(gmean, mean, mean_abs, f"window demotion, window {kw}"))
    rows = len(ids)
    _resil_emit(card, "window_demotion", run, rows, max_mean_rel_err=worst, fault_spec=spec, demote_after=2,
                windows_closed=len(down), late_events=len(late), migrated_windows=dem.events[0]["keys"],
                launches_at_demotion=dem.at[0]["fold"], tail_rows=RESIL_TAIL_ROWS)
    return run["launches"]


def _resil_scan(card: dict) -> int:
    """16.3b: ``anomaly_flow`` at 10,000 sensors demoted when its tail
    arrives: the Welford state crosses to the host logics."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.anomaly import anomaly_flow
    from bytewax_tpu_torch.models.brc import ArrayBatchSource
    from bytewax_tpu_torch.testing import TestingSink

    rng = np.random.RandomState(164)
    tail = RESIL_TAIL_ROWS // RESIL_TAIL_BATCHES
    ids_b = [rng.randint(0, SCAN_KEYS, SCAN_ROWS).astype(np.int32) for _ in range(RESIL_SCAN_BATCHES)]
    ids_b += [rng.randint(0, SCAN_KEYS, tail).astype(np.int32) for _ in range(RESIL_TAIL_BATCHES)]
    data = _make_anomaly_data(len(ids_b), 0, SCAN_KEYS, 165, ids_b=ids_b)
    vocab = np.array([f"sensor_{i:07d}" for i in range(SCAN_KEYS)])
    index = {k: i for i, k in enumerate(vocab.tolist())}
    batches = [ArrayBatch({"key_id": i, "value": v}, key_vocab=vocab) for i, v in zip(data["ids_b"], data["vals_b"])]
    out = []
    spec = f"device_dispatch:error:{RESIL_SCAN_BATCHES + 1}+"
    run = _resil_run("scan_demotion", anomaly_flow(ArrayBatchSource(batches), TestingSink(out), threshold=THRESHOLD),
                     {"BYTEWAX_TPU_FAULTS": spec, "BYTEWAX_TPU_DEMOTE_AFTER": "2"}, demotions=1)
    _planned_demotion("scan demotion", run, RESIL_SCAN_BATCHES, "scan", 2, SCAN_KEYS, "anomaly_detector.zscore")
    rows = len(data["ids"])
    checked = _check_scored("scan demotion", out, index, data, slice(0, rows), "zscore")
    _resil_emit(card, "scan_demotion", run, rows, fault_spec=spec, demote_after=2,
                launches_at_demotion=run["dem"].at[0]["scan"], tail_rows=RESIL_TAIL_ROWS, **checked)
    return run["scan_launches"]


def _stoppable_source(batches, hold_from: int, released):
    """A resumable source of ``batches`` (its snapshot is the next
    batch's index) that holds from index ``hold_from`` (empty polls,
    woken every 2 ms) until ``released`` is set, at most 30 s."""
    from datetime import datetime, timedelta, timezone

    from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition

    deadline = time.monotonic() + 30.0

    class _Part(StatefulSourcePartition):
        def __init__(self, at):
            self.at = at
            self.awake = None

        def next_batch(self):
            if self.at >= len(batches):
                raise StopIteration()
            if self.at >= hold_from and not released.is_set() and time.monotonic() < deadline:
                self.awake = datetime.now(timezone.utc) + timedelta(milliseconds=2)
                return []
            self.awake = None
            self.at += 1
            return batches[self.at - 1]

        def next_awake(self):
            return self.awake

        def snapshot(self):
            return self.at

    class _Source(FixedPartitionedSource):
        def list_parts(self):
            return ["batches"]

        def build_part(self, step_id, for_part, resume_state):
            return _Part(resume_state or 0)

    return _Source()


def _resil_stop(card: dict, root: Path, batches, want) -> int:
    """16.4: ``request_stop()`` from another thread once epoch
    ``RESIL_STOP_AFTER`` is durable; the run returns ``GracefulStop``
    and its store resumes with zero epochs replayed."""
    import threading

    from bytewax_tpu_torch.engine import driver, flight
    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore
    from bytewax_tpu_torch.errors import GracefulStop

    db = _fresh_store(root, "resilience_stop")
    released = threading.Event()
    base = flight.RECORDER.counters.get("epoch_close_count", 0)
    asked = []

    def stopper():
        # Synchronous checkpoints: a close counted is a close committed.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if flight.RECORDER.counters.get("epoch_close_count", 0) - base >= RESIL_STOP_AFTER:
                asked.append(time.perf_counter())
                driver.request_stop()
                break
            time.sleep(0.001)
        released.set()

    out = []
    thread = threading.Thread(target=stopper, daemon=True)
    driver.reset_stop()
    thread.start()
    try:
        first = _resil_run("stop", _resil_flow(_stoppable_source(batches, RESIL_STOP_AFTER, released), out), {}, db=db)
    finally:
        returned = time.perf_counter()
        released.set()
        thread.join(timeout=30)
        driver.reset_stop()
    status = first["status"]
    if not asked:
        raise AssertionError("graceful stop: the stop was never requested")
    store = RecoveryStore(str(db))
    try:
        resume_epoch = store.resume_from().resume_epoch
    finally:
        store.close()
    if not isinstance(status, GracefulStop) or out or resume_epoch != status.epoch + 1:
        raise AssertionError(f"graceful stop: returned {status!r}, {len(out)} rows out, resume at {resume_epoch}")
    consumed = first["launches"]
    if not RESIL_STOP_AFTER <= consumed < len(batches):
        raise AssertionError(f"graceful stop: {consumed} batches folded before the stop")
    again = _resil_run("stop_resumed", _resil_flow(_stoppable_source(batches, 0, released), out), {}, db=db)
    if again["status"] is not None or again["launches"] != len(batches) - consumed:
        raise AssertionError(f"graceful stop resume: {again['launches']} folds after {consumed}, {again['status']!r}")
    worst = _check_res_finals(out, want, "graceful stop resume")
    rows = RESIL_ROWS * len(batches)
    _resil_emit(card, "graceful_stop", first, RESIL_ROWS * consumed, stop_epoch=status.epoch,
                resume_epoch=resume_epoch, stop_to_return_s=returned - asked[0], batches_before_stop=consumed)
    _resil_emit(card, "graceful_stop_resumed", again, rows - RESIL_ROWS * consumed, max_abs_mean_err=worst,
                replayed_epochs=resume_epoch - status.epoch - 1)
    return first["launches"] + again["launches"]


class _Collector:
    """A stub OTLP/HTTP collector on the loopback: keeps every span
    name posted to ``/v1/traces``."""

    def __init__(self):
        import http.server
        import threading

        names = self.names = []

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                for rs in doc.get("resourceSpans", []):
                    for ss in rs.get("scopeSpans", []):
                        names.extend(sp["name"] for sp in ss.get("spans", []))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self._srv = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=10)


def _prom_value(text: str, name: str, labels: dict):
    """One sample's value from Prometheus text exposition, or None."""
    import re

    for line in text.splitlines():
        m = re.match(r"^(\w+)(?:\{(.*)\})? (\S+)$", line)
        if not m or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
        if got == labels:
            return float(m.group(3))
    return None


def _resil_observed(card: dict, root: Path, batches, want) -> int:
    """16.5: the endpoints polled while the fold runs on the card, a
    Perfetto dump and an OTLP export."""
    import urllib.request

    import bytewax_tpu_torch.tracing as tracing
    from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
    from bytewax_tpu_torch.ops import fold_kernel

    base = f"http://127.0.0.1:{RESIL_API_PORT}"
    seen = {}
    states_now = []

    def fetch(path, raw=False):
        with urllib.request.urlopen(base + path, timeout=10) as rsp:
            body = rsp.read()
            return (rsp.status, body.decode() if raw else json.loads(body))

    class _Part(StatelessSourcePartition):
        def __init__(self, mine):
            self.i = 0 if mine else len(batches)

        def next_batch(self):
            if self.i >= len(batches):
                raise StopIteration()
            if self.i == len(batches) - 2 and not seen:
                # Polled on the run loop's thread between two folds:
                # the API thread answers while the state sits on the card.
                t0 = time.perf_counter()
                seen["launches"] = fold_kernel.launches
                seen["nbytes"] = sum(
                    int(t.nbytes) for st in states_now for t in st._fields.values()
                )
                seen["devices"] = sorted({t.device.type for st in states_now for t in st._fields.values()})
                seen["status"] = fetch("/status")
                seen["metrics"] = fetch("/metrics", raw=True)
                seen["graph"] = fetch("/graph")
                seen["healthz"] = fetch("/healthz")
                seen["poll_s"] = time.perf_counter() - t0
            self.i += 1
            return batches[self.i - 1]

    class _Source(DynamicSource):
        def build(self, step_id, worker_index, worker_count):
            return _Part(worker_index == 0)

    trace_dir = root / "perfetto"
    collector = _Collector()
    prev = tracing._tracer
    guard = tracing.setup_tracing(tracing.OtlpTracingConfig(service_name="chip-smoke", url=collector.url))
    out = []
    import bytewax_tpu_torch.engine.sharded_state as sharded_state

    make = sharded_state.make_agg_state

    def recording(kind, driver=None):
        st = make(kind, driver=driver)
        states_now.append(st)
        return st

    sharded_state.make_agg_state = recording
    try:
        run = _resil_run("observed", _resil_flow(_Source(), out),
                         {"BYTEWAX_DATAFLOW_API_ENABLED": "1", "BYTEWAX_DATAFLOW_API_PORT": str(RESIL_API_PORT),
                          "BYTEWAX_DATAFLOW_API_HOST": "127.0.0.1", "BYTEWAX_TPU_TRACE_DIR": str(trace_dir),
                          "BYTEWAX_TPU_PIPELINE_DEPTH": "2"})
    finally:
        sharded_state.make_agg_state = make
        guard.shutdown()
        tracing._tracer = prev
        collector.close()
    if run["launches"] != len(batches):
        raise AssertionError(f"observed run: {run['launches']} folds for {len(batches)} batches")
    worst = _check_res_finals(out, want, "observed run")
    (state,) = states_now
    step = next(n for n in seen["graph"][1]["steps"] if n["tier"] == "device")
    tele = step["telemetry"]["0"]
    prom_bytes = _prom_value(seen["metrics"][1], "bytewax_step_device_bytes", {"step_id": step["step_id"]})
    h2d = _prom_value(seen["metrics"][1], "bytewax_device_transfer_bytes_total", {"direction": "h2d"})
    device_s = seen["status"][1]["ledger"]["phase_totals"].get("device", 0.0)
    health = seen["healthz"]
    if seen["devices"] != [DEV] or not seen["nbytes"]:
        raise AssertionError(f"observed run: the state's tensors on {seen['devices']}")
    if tele.get("device_bytes") != seen["nbytes"] or prom_bytes != seen["nbytes"] or tele.get("device_keys") != RESIL_KEYS:
        raise AssertionError(f"observed run: footprint {tele.get('device_bytes')} on /graph, {prom_bytes} on "
                             f"/metrics, {seen['nbytes']} bytes of the state's tensors")
    if not (h2d and h2d > 0 and device_s > 0 and health[0] == 200 and health[1]["ready"]):
        raise AssertionError(f"observed run: h2d {h2d}, device phase {device_s}, healthz {health}")
    dumps = sorted(trace_dir.glob("epoch-p00-*.json"))
    device_spans = sum(
        1 for p in dumps for ev in json.loads(p.read_text())["traceEvents"]
        if ev["ph"] == "X" and ev["name"] == "device"
    )
    otlp = collector.names.count("device_dispatch")
    if not dumps or not device_spans or not otlp:
        raise AssertionError(f"observed run: {len(dumps)} Perfetto dumps, {device_spans} device spans, "
                             f"{otlp} device_dispatch spans at the collector")
    _resil_emit(card, "observed", run, RESIL_ROWS * len(batches), max_abs_mean_err=worst,
                device_bytes=seen["nbytes"], graph_device_bytes=tele["device_bytes"],
                metrics_device_bytes=prom_bytes, device_keys=tele["device_keys"], h2d_bytes_total=h2d,
                ledger_device_s=device_s, endpoint_poll_s=seen["poll_s"],
                status_keys=sorted(seen["status"][1]), perfetto_dumps=len(dumps),
                perfetto_device_spans=device_spans, otlp_device_dispatch_spans=otlp,
                otlp_spans=len(collector.names), launches_when_polled=seen["launches"])
    return run["launches"]


def _resil_edge(card: dict, root: Path) -> int:
    """16.6: 1BRC text with undecodable lines through
    ``FileSource(columnar=True, on_error="dlq")`` and transient
    ``source_poll`` faults into the fold on the card."""
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.connectors.files import FileSource
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.ops import text
    from bytewax_tpu_torch.testing import TestingSink

    rng = np.random.RandomState(166)
    n = RESIL_LINES
    ids = rng.randint(0, INGEST_STATIONS, size=n)
    deci = np.clip(np.round(rng.randn(n) * 100 + 120), -999, 999).astype(np.int64)
    stations = np.array([f"station_{i:05d}" for i in range(INGEST_STATIONS)])
    temps = np.array([f"{q / 10:.1f}" for q in range(-999, 1000)])
    lines = np.char.add(np.char.add(stations[ids], ";"), temps[deci + 999]).astype("S")
    poison = np.arange(n) % RESIL_POISON_EVERY == RESIL_POISON_EVERY - 1
    lines[poison] = b"\xff\xfe broken"
    path = root / "edge.txt"
    path.write_bytes(b"\n".join(lines.tolist()) + b"\n")
    good = ~poison
    want = _stats_oracle(stations, ids[good], deci[good])

    def parse(batch):
        cols = text.split_fields(batch.cols["line"], 2, ";")
        return ArrayBatch({"key": cols[0], "value": cols[1].astype(np.float64)})

    out = []
    flow = Dataflow("resil_edge")
    s = op.input("inp", flow, FileSource(str(path), columnar=True, on_error="dlq", chunk_bytes=4 << 20))
    s = op.flat_map_batch("parse", s, parse)
    s = xla.stats_final("stats", s)
    op.output("out", s, TestingSink(out))
    dlq_dir = root / "dlq"
    run = _resil_run("connector_edge", flow,
                     {"BYTEWAX_TPU_FAULTS": "source_poll:error:*:x3", "BYTEWAX_TPU_IO_RETRIES": "4",
                      "BYTEWAX_TPU_IO_BACKOFF_S": "0.005", "BYTEWAX_TPU_DLQ_DIR": str(dlq_dir)})
    counters = run["counters"]
    dead = (dlq_dir / "dlq-p00.jsonl").read_text().splitlines()
    n_poison = int(poison.sum())
    if counters.get("io_retries_count", 0) != 3 or counters.get("worker_restart_count", 0) \
            or run["launches"] <= 0:
        raise AssertionError(f"connector edge: {counters}")
    if len(dead) != n_poison or counters.get("dlq_records_count", 0) != n_poison:
        raise AssertionError(f"connector edge: {len(dead)} DLQ rows, {counters.get('dlq_records_count')} "
                             f"counted, {n_poison} poison lines")
    if any("UnicodeDecodeError" not in json.loads(r)["error"] for r in dead[:16]):
        raise AssertionError(f"connector edge: DLQ rows {dead[:2]}")
    got = dict(out)
    if set(got) != set(want):
        raise AssertionError(f"connector edge: {len(got)} stations out, {len(want)} expected")
    worst = 0.0
    for station, (mn, mean, mx, count, mean_abs) in want.items():
        gmn, gmean, gmx, gcount = got[station]
        if (gmn, gmx, gcount) != (mn, mx, count):
            raise AssertionError(f"connector edge, {station}: {got[station]} != {want[station]}")
        worst = max(worst, _check_mean(gmean, mean, mean_abs, f"connector edge, {station}"))
    _resil_emit(card, "connector_edge", run, n, max_mean_rel_err=worst, dlq_rows=len(dead),
                poison_lines=n_poison, good_lines=int(good.sum()), fault_spec="source_poll:error:*:x3")
    return run["launches"]


def phase_resilience(card: dict) -> dict:
    """Phase 16: device faults, demotion, the graceful stop, the live
    endpoints and the connector edge on the card; returns each run's
    launches of the fold and scan kernels.  Fails past
    ``RESIL_BUDGET_S``."""
    import tempfile

    t0 = time.perf_counter()
    fold, scan, steps = {}, {}, {}

    def step(name, fn, *args):
        s0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            steps[name] = time.perf_counter() - s0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resilience_") as tmp:
        root = Path(tmp)
        batches, ids_b, vals_b = step("data", _resil_batches, RESIL_BATCHES, RESIL_ROWS, 160)
        want = _res_oracle(ids_b, vals_b)
        fold["resilience_transient"] = step("transient", _resil_transient, card, batches, want)
        for name, n in step("demotion", _resil_demote, card, batches, ids_b, vals_b).items():
            fold[f"resilience_{name}"] = n
        fold["resilience_windows"] = step("windows", _resil_windows, card)
        scan["resilience_anomaly"] = step("scan", _resil_scan, card)
        fold["resilience_stop"] = step("stop", _resil_stop, card, root, batches, want)
        fold["resilience_observed"] = step("observed", _resil_observed, card, root, batches, want)
        fold["resilience_edge"] = step("edge", _resil_edge, card, root)
    seconds = time.perf_counter() - t0
    _emit(card, "resilience_phase", phase_seconds=seconds, budget_s=RESIL_BUDGET_S, step_seconds=steps,
          launches={"segment_fold": fold, "segment_scan": scan})
    if seconds > RESIL_BUDGET_S:
        raise AssertionError(f"phase 16 took {seconds:.1f} s, over its {RESIL_BUDGET_S} s budget")
    return {"fold": fold, "scan": scan}


def main() -> int:
    if not (HERE / "bytewax_tpu_torch" / "csrc" / "segment_fold.cu").exists():
        print(
            "chip_smoke.py must run from a checkout of the repository "
            "(bytewax_tpu_torch/ not found beside it)",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch finds none", file=sys.stderr)
        return 1
    os.environ.pop("BYTEWAX_TPU_PLATFORM", None)  # the card, never the CPU
    card = _card()
    if not phase_analysis(card):
        print("the port's tree breaks an engine contract (above)", file=sys.stderr)
        return 1

    from concurrent.futures import ThreadPoolExecutor

    from bytewax_tpu_torch.ops import bucket_kernel, fold_kernel, merge_kernel, scan_kernel

    # One nvcc for each source, started together.
    kernels = (fold_kernel, scan_kernel, bucket_kernel, merge_kernel)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for built in [pool.submit(mod.build) for mod in kernels]:
            built.result()
    ptxas = [
        ln
        for mod in kernels
        for ln in mod.build_log.splitlines()
        if "registers" in ln or "Compiling entry" in ln
    ]
    _emit(card, "build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    check = phase_kernel(card, KERNEL_ROWS, WINDOW_KERNEL_ROWS)
    launches = {}
    shapes = {}
    for n_stations, capacity in ((413, 1024), (10_000, 16384)):
        times = _time_main_shapes(card, BATCH_ROWS, capacity, n_stations)
        shapes[f"brc_{n_stations}"] = times
        launches[f"main_{n_stations}"] = phase_main(
            card, ROWS, BATCH_ROWS, n_stations, times
        )
    # The windowed folds' batches: tumbling (2^20 rows into ~20,000
    # open windows) and sliding (10·2^20 rows into ~110,000).
    for name, rows, capacity, live in (
        ("window_tumbling", WINDOW_BATCH_ROWS, 32768, 20_000),
        ("window_sliding", WINDOW_KERNEL_ROWS, 131072, 110_000),
    ):
        shapes[name] = _time_main_shapes(card, rows, capacity, live, source="slot")
    launches["items"] = phase_items(card, ITEM_ROWS)
    launches["ingest"] = phase_ingest(card, INGEST_LINES, INGEST_STATIONS, WORDCOUNT_LINES)
    for name, n in phase_windows(card, WINDOW_BATCH_ROWS, WINDOW_KEYS, WINDOW_CASES).items():
        launches[f"windows_{name}"] = n
    scan = phase_scan(card, SCAN_ROWS, SCAN_KEYS)
    scan_launches = phase_anomaly(card, SCAN_ROWS, SCAN_KEYS, scan["times"])
    recovered = phase_recovery(card, BATCH_ROWS)
    for path in ("brc", "windows", "rescale", "anomaly"):
        launches[f"recovery_{path}"] = recovered["fold"].get(path, 0)
        scan_launches[f"recovery_{path}"] = recovered["scan"].get(path, 0)
    clustered = phase_cluster(card)
    launches.update(clustered["fold"])
    scan_launches.update(clustered["scan"])
    sharded = phase_sharded(card)
    bucket_launches = {}
    for path, counts in sharded["launches"].items():
        launches[path] = counts["segment_fold"]
        scan_launches[path] = counts["segment_scan"]
        bucket_launches[path] = counts["shard_bucket"]

    glob = phase_global(card)
    merge_launches = {}
    for path, counts in glob["launches"].items():
        launches[path] = counts["fold"]
        bucket_launches[path] = counts["bucket"]
        merge_launches[path] = counts["merge"]
    launches["kafka"] = phase_kafka(card)
    for path, n in phase_operators(card).items():
        launches[f"operators_{path}"] = n
    resident = phase_residency(card, scan["times"])
    launches.update(resident["fold"])
    scan_launches.update(resident["scan"])
    bucket_launches.update(resident["bucket"])
    resilient = phase_resilience(card)
    launches.update(resilient["fold"])
    scan_launches.update(resilient["scan"])

    times = shapes["brc_413"]
    scan_times = scan["times"]["welford"]
    bucket_times = sharded["times"]["brc_10000"]
    merge_times = glob["round_times"]["stats_int8_2p"]
    keys = ("ms", "host_us", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card["line"])
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "segment_fold",
                        "route": "cuda",
                        "source": "bytewax_tpu_torch/csrc/segment_fold.cu",
                        "replaces": "bytewax_tpu/ops/pallas_fold.py:45",
                        "launches": sum(launches.values()),
                        "launches_by_path": launches,
                        "max_abs_err": check["max_abs_err"],
                        "ms": times["ms"],
                        "host_us": times["host_us"],
                        "plain_ms": times["plain_ms"],
                        "bound_ms": times["bound_ms"],
                        "bound_by": times["bound_by"],
                        "library_ms": times["library_ms"],
                        "shape": "brc_413",
                        "shapes": {
                            name: {key: t[key] for key in keys} for name, t in shapes.items()
                        },
                    },
                    {
                        "name": "segment_scan",
                        "route": "cuda",
                        "source": "bytewax_tpu_torch/csrc/segment_scan.cu",
                        "replaces": "bytewax_tpu/ops/scan.py:234 (zscore_scan_body), "
                        "bytewax_tpu/ops/scan.py:152 (generic_scan_body)",
                        "launches": sum(scan_launches.values()),
                        "launches_by_path": scan_launches,
                        "max_abs_err": scan["max_rel_err"],
                        "max_err_is": "relative to max(1, |plain|); counts and extrema exact",
                        "ms": scan_times["ms"],
                        "cold_ms": scan_times["cold_ms"],
                        "launches_per_call": scan_times["launches_per_call"],
                        "host_us": scan_times["host_us"],
                        "fold_host_us": scan_times["fold_host_us"],
                        "plain_ms": scan_times["plain_ms"],
                        "bound_ms": scan_times["bound_ms"],
                        "bound_by": scan_times["bound_by"],
                        "library_ms": None,
                        "library": "none: no single PyTorch call computes a segmented scan",
                        "shape": "welford, 2^20 rows, 10,000 keys",
                        "shapes": {
                            name: {key: t[key] for key in keys + ("cold_ms",)}
                            for name, t in scan["times"].items()
                        },
                    },
                    {
                        "name": "shard_bucket",
                        "route": "cuda",
                        "source": "bytewax_tpu_torch/csrc/shard_bucket.cu",
                        "replaces": "bytewax_tpu/parallel/exchange.py:27",
                        "launches": sum(bucket_launches.values()),
                        "launches_by_path": bucket_launches,
                        "max_abs_err": sharded["max_abs_err"],
                        "ms": bucket_times["ms"],
                        "passes_per_call": bucket_times["passes_per_call"],
                        "graph_ms": bucket_times["graph_ms"],
                        "host_us": bucket_times["host_us"],
                        "plain_ms": bucket_times["plain_ms"],
                        "bound_ms": bucket_times["bound_ms"],
                        "bound_by": bucket_times["bound_by"],
                        "library_ms": None,
                        "library": "none: no single PyTorch call buckets rows by shard",
                        "shape": "1BRC batch: 2^20 rows, 4 shards, 10,000 stations",
                        "shapes": {
                            name: {key: t[key] for key in keys + ("graph_ms",)}
                            for name, t in sharded["times"].items()
                        },
                    },
                    {
                        "name": "agg_merge",
                        "route": "cuda",
                        "source": "bytewax_tpu_torch/csrc/agg_merge.cu",
                        "replaces": "bytewax_tpu/engine/xla.py:657",
                        "launches": sum(merge_launches.values()),
                        "launches_by_path": merge_launches,
                        "max_abs_err": 0.0,
                        "max_err_is": "bit-exact against the plain version in every case, twice",
                        "ms": merge_times["ms"],
                        "graph_ms": merge_times["graph_ms"],
                        "host_us": merge_times["host_us"],
                        "launch_host_us": merge_times["launch_host_us"],
                        "pack_us": merge_times["pack_us"],
                        "plain_ms": merge_times["plain_ms"],
                        "bound_ms": merge_times["bound_ms"],
                        "bound_by": merge_times["bound_by"],
                        "library_ms": merge_times["library_ms"],
                        "library": "per frame and field: the dequantize, then one scatter_reduce_",
                        "shape": "one int8 stats round of 2 processes: 2 frames x 4 fields, "
                        "8,190 rows a frame, one launch",
                        "shapes": {
                            name: {key: t[key] for key in keys + ("graph_ms", "launch_host_us")}
                            for name, t in {**glob["round_times"], **glob["times"]}.items()
                        },
                    },
                ]
            }
        )
    )
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
