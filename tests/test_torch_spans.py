"""The port's spans, profiler ranges and kernel device times
(``engine/flight.py``: :class:`span`, :class:`phase`,
:func:`open_range`, :data:`DEVICE_TIMES`), on the CPU.

A span adds its seconds to the counter ``<name>_seconds`` and, while a
``torch.profiler`` session records, is the range ``bytewax.<name>`` on
its own thread: a function-scope record, never a user annotation, so
the profiler puts no mirror of it on a device's timeline.  The
dispatch task's spans (``dispatch_vocab``, ``dispatch_copy``), the
mappers' (``mapper``) and text decode's (``decode``) leave the epoch
ledger as the JAX package's engine writes it.  Device times resolve
from event pairs without blocking; fake events stand in for CUDA's.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bytewax_tpu_torch.engine import flight, pipeline
from bytewax_tpu_torch.ops import text
from tests.test_torch_both import (  # noqa: F401
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    unsharded,
)

#: The spans' and the fold's range names, none of them a ledger phase.
SPAN_NAMES = ("dispatch_vocab", "dispatch_copy", "fold", "mapper", "decode")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh flight recorder and device-time queue for one test."""
    rec = flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", rec)
    monkeypatch.setattr(flight, "DEVICE_TIMES", flight.DeviceTimes())
    return rec


def _profiling():
    """A CPU ``torch.profiler`` session over every thread."""
    kwargs = {}
    try:
        kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        )
    except (AttributeError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU], **kwargs)


def _ranges(prof):
    return [e for e in prof.events() if e.name.startswith("bytewax.")]


# -- the helpers ------------------------------------------------------------


def test_span_counts_its_seconds_and_leaves_the_ledger(recorder):
    with flight.span("unit_part"):
        time.sleep(0.002)
    with flight.span("unit_part"):
        pass
    assert recorder.counters["unit_part_seconds"] >= 0.002
    assert recorder.phase_totals == {}
    assert recorder._ledger == {}
    assert recorder._phase_stack == []


def test_span_is_a_function_range_on_every_thread_while_profiling(recorder):
    def work():
        with flight.span("unit_range"):
            time.sleep(0.001)

    with _profiling() as prof:
        work()
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
    found = [e for e in _ranges(prof) if e.name == "bytewax.unit_range"]
    assert len(found) == 2
    assert len({e.thread for e in found}) == 2
    for e in found:
        assert e.device_type == DeviceType.CPU
        assert not e.is_user_annotation
    assert recorder.counters["unit_range_seconds"] >= 0.002


def test_nothing_is_recorded_with_the_profiler_off(recorder):
    assert flight.open_range("unit_off") is None
    flight.close_range(None)
    with flight.span("unit_off"):
        pass
    with _profiling() as prof:
        pass
    assert not _ranges(prof)
    assert recorder.counters["unit_off_seconds"] >= 0.0


def test_phase_is_exclusive_and_reports_through_the_module(monkeypatch, recorder):
    seen = []
    note = flight.note_phase

    def noting(phase, step_id, seconds, gross=None, t0=None, lane=0):
        seen.append((phase, step_id, seconds, gross, lane))
        return note(phase, step_id, seconds, gross=gross, t0=t0, lane=lane)

    monkeypatch.setattr(flight, "note_phase", noting)
    with _profiling() as prof:
        with flight.phase("unit_outer", "s"):
            with flight.phase("unit_inner", "s"):
                time.sleep(0.003)
    assert [s[0] for s in seen] == ["unit_inner", "unit_outer"]
    inner, outer = seen
    assert inner[3] >= 0.003 and outer[3] >= inner[3]
    # The parent records its self time only.
    assert outer[2] == pytest.approx(max(outer[3] - inner[3], 0.0))
    assert all(s[4] == 0 for s in seen)
    assert {e.name for e in _ranges(prof)} == {"bytewax.unit_outer", "bytewax.unit_inner"}
    assert recorder._phase_stack == []


def test_phase_unwinds_on_error(recorder):
    with pytest.raises(KeyError), flight.phase("unit_err", "s"):
        raise KeyError("x")
    assert recorder._phase_stack == []
    assert recorder._ledger[("unit_err", "s")] >= 0.0


# -- device times ------------------------------------------------------------


class FakeEvent:
    """A CUDA event's ``query``/``elapsed_time`` on a settable clock;
    no ``synchronize``, so a resolver that waited would raise."""

    def __init__(self):
        self.at = None
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def _pair(times, start_s, end_s, done=True, device=0):
    start, end = times.pair(device, FakeEvent)
    start.at, end.at = start_s, end_s
    start.done = end.done = done
    return start, end


def test_only_completed_pairs_at_the_head_resolve(recorder):
    times = flight.DeviceTimes()
    times.note("unit", 0, *_pair(times, 0.0, 0.5))
    late = _pair(times, 1.0, 1.25, done=False)
    times.note("unit", 0, *late)
    times.note("unit", 0, *_pair(times, 2.0, 2.125))
    assert times.resolve() == 1
    assert recorder.counters["unit_device_seconds"] == pytest.approx(0.5)
    assert len(times) == 2
    # The pending pair holds back the completed one behind it: launch
    # order is kept.
    assert times.resolve() == 0
    late[1].done = True
    assert times.resolve() == 2
    assert recorder.counters["unit_device_seconds"] == pytest.approx(0.875)
    assert len(times) == 0
    # Resolved events are handed out again.
    reused = times.pair(0, FakeEvent)
    assert all(isinstance(e, FakeEvent) and e.done for e in reused)
    # On their own device only.
    fresh = times.pair(1, FakeEvent)
    assert not any(e.done for e in fresh)


def test_a_resolve_running_elsewhere_makes_this_one_a_no_op(recorder):
    times = flight.DeviceTimes()
    times.note("unit", 0, *_pair(times, 0.0, 1.0))
    with times._lock:
        assert times.resolve() == 0
    assert times.resolve() == 1


def test_a_long_queue_resolves_on_its_own(monkeypatch, recorder):
    monkeypatch.setattr(flight, "_DEVICE_PENDING_CAP", 3)
    times = flight.DeviceTimes()
    for k in range(3):
        times.note("unit", 0, *_pair(times, float(k), k + 0.25))
    assert len(times) == 0
    assert recorder.counters["unit_device_seconds"] == pytest.approx(0.75)


def test_launching_and_resolving_threads_lose_and_repeat_nothing(recorder):
    times = flight.DEVICE_TIMES
    n_threads = (os.cpu_count() or 4) + 4
    per_thread = 300
    resolved = []
    noted = threading.Event()

    class Counted(FakeEvent):
        def elapsed_time(self, end):
            resolved.append(1)
            return super().elapsed_time(end)

    def launch():
        for k in range(per_thread):
            start, end = times.pair(k % 2, Counted)
            start.at, end.at = 0.0, 0.001
            start.done = end.done = True
            times.note("unit", k % 2, start, end)

    def resolve():
        while not noted.is_set():
            times.resolve()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        resolvers = [threading.Thread(target=resolve) for _ in range(2)]
        launchers = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in resolvers + launchers:
            t.start()
        for t in launchers:
            t.join(timeout=60)
        noted.set()
        for t in resolvers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in resolvers + launchers)
    times.resolve()
    total = n_threads * per_thread
    assert len(times) == 0
    assert len(resolved) == total
    assert recorder.counters["unit_device_seconds"] == pytest.approx(total * 0.001)


@pytest.mark.parametrize("depth", [1, 2])
def test_the_pipeline_resolves_at_its_drain_points(recorder, depth):
    times = flight.DEVICE_TIMES
    pipe = pipeline.DevicePipeline("unit_step", depth=depth)
    got = []
    try:
        for k in range(3):
            pipe.push(
                lambda k=k: times.note("unit", 0, *_pair(times, float(k), k + 0.5)),
                got.append,
            )
        pipe.flush()
    finally:
        pipe.shutdown()
    assert len(got) == 3
    assert len(times) == 0
    assert recorder.counters["unit_device_seconds"] == pytest.approx(1.5)


# -- the engine's spans, held against the JAX package ---------------------


def _stats_flow(m, n_batches=6, n_rows=600, keys="ids", sleep_s=0.0):
    """Columnar station stats: dictionary-encoded int16 fixed-point
    batches (``ids``, the packed fold) or string keys (``strings``),
    through a batch mapper."""
    rng = np.random.RandomState(5)
    vocab = np.array([f"st{i:03d}" for i in range(37)])
    batches = []
    for _ in range(n_batches):
        ids = rng.randint(0, len(vocab), size=n_rows).astype(np.int16)
        deci = rng.randint(-999, 999, size=n_rows).astype(np.int16)
        if keys == "ids":
            batches.append(m.ArrayBatch({"key_id": ids, "value": deci}, key_vocab=vocab, value_scale=0.1))
        else:
            batches.append(m.ArrayBatch({"key": vocab[ids], "value": deci * 0.1}))

    def parse(batch):
        time.sleep(sleep_s)
        return batch

    out = []
    flow = m.Dataflow("spans_df")
    s = m.op.input("inp", flow, m.ArrayBatchSource(batches))
    s = m.op.flat_map_batch("parse", s, parse)
    stats = m.xla.stats_final("stats", s)
    m.op.output("out", stats, m.TestingSink(out))
    return flow, out


def _rounded(out):
    return sorted((k, tuple(round(float(x), 3) for x in v)) for k, v in out)


@pytest.mark.parametrize("keys", ["ids", "strings"])
@pytest.mark.parametrize("depth", ["1", "2"])
def test_dispatch_spans_count_and_leave_the_ledger_as_it_was(monkeypatch, depth, keys):
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    names = [f"{n}_seconds" for n in ("dispatch_vocab", "dispatch_copy")]

    def case(m):
        rec = m.flight.RECORDER
        rec._ledgers.clear()
        counters0 = dict(rec.counters)
        flow, out = _stats_flow(m, keys=keys)
        m.run_main(flow, epoch_interval=ZERO_TD)
        records = rec.ledgers()
        assert records
        deltas = {n: rec.counters.get(n, 0.0) - counters0.get(n, 0.0) for n in names + ["fold_device_seconds"]}
        return _rounded(out), [sorted(r) for r in records], records, deltas, dict(rec.phase_totals)

    (want, want_keys, ref_records, _, _), (got, got_keys, records, deltas, totals) = both(case)
    assert got == want
    assert got_keys[-1] == want_keys[-1]
    for name in names:
        assert deltas[name] > 0.0, (name, deltas)
    # The plain fold on the CPU has no device time to count.
    assert deltas["fold_device_seconds"] == 0.0, deltas
    # The spans never enter the sealed records, their close windows,
    # the lifetime totals or the fractions.
    ref_phases = {p for r in ref_records for p in r["phases"]}
    for rec in records:
        assert not set(rec["phases"]) & set(SPAN_NAMES), rec["phases"]
        assert not set(rec["close"]) & set(SPAN_NAMES), rec["close"]
        # Every phase the port seals is one the JAX package's engine
        # seals (``flush`` only where the main thread waited).
        assert set(rec["phases"]) <= ref_phases | {"flush"}, (rec["phases"], ref_phases)
        main = sum(s for p, steps in rec["phases"].items() if p != "device" for s in steps.values())
        assert main <= rec["wall_s"] * 1.05 + 0.002
    assert not set(totals) & set(SPAN_NAMES)
    assert set(flight.ledger_fractions(totals)) == set(flight._FRACTION_BUCKETS)


def test_the_engine_opens_its_ranges_on_their_threads(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    flow, out = _stats_flow(TORCH, n_batches=8)
    with _profiling() as prof:
        TORCH.run_main(flow, epoch_interval=ZERO_TD)
    assert out
    ranges = _ranges(prof)
    threads = {}
    for e in ranges:
        threads.setdefault(e.name, set()).add(e.thread)
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation, e.name
    for name in ("host", "ingest", "device", "readback", "dispatch_vocab", "dispatch_copy", "mapper"):
        assert f"bytewax.{name}" in threads, sorted(threads)
    # The dispatch task and its spans run on the pipeline's worker.
    assert threads["bytewax.device"].isdisjoint(threads["bytewax.host"])
    assert threads["bytewax.dispatch_copy"] <= threads["bytewax.device"]


def test_mapper_seconds_split_out_of_host(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(m):
        before = m.flight.RECORDER.counters.get("mapper_seconds", 0.0)
        host0 = m.flight.RECORDER.phase_totals.get("host", 0.0)
        flow, out = _stats_flow(m, n_batches=4, sleep_s=0.004)
        m.run_main(flow, epoch_interval=ZERO_TD)
        rec = m.flight.RECORDER
        return (
            _rounded(out),
            rec.counters.get("mapper_seconds", 0.0) - before,
            rec.phase_totals.get("host", 0.0) - host0,
        )

    (want, _, _), (got, mapper_s, host_s) = both(case)
    assert got == want
    # At least one mapper call (the source may merge the batches).
    assert mapper_s >= 0.004
    # The mapper runs inside the host phase.
    assert mapper_s <= host_s + 1e-6


@pytest.mark.parametrize("text_device", ["0", "1"])
def test_decode_seconds_and_the_gathers_copies(monkeypatch, text_device):
    monkeypatch.setenv("BYTEWAX_TPU_TEXT_DEVICE", text_device)
    counters = flight.RECORDER.counters
    before = {k: counters.get(k, 0) for k in ("decode_seconds", "device_transfer_bytes_h2d", "device_transfer_bytes_d2h")}
    lines = ["Oslo;1.5", "Ürümqi;-20.25", "A;0.0"]
    body = "".join(f"{ln}\n" for ln in lines).encode()
    got = text.split_lines(body)
    assert got.tolist() == lines
    delta = {k: counters.get(k, 0) - v for k, v in before.items()}
    assert delta["decode_seconds"] > 0.0
    if text_device == "1":
        units = len(body.decode())
        width = max(len(ln) for ln in lines)
        assert delta["device_transfer_bytes_h2d"] == 4 * units + 2 * 8 * len(lines)
        assert delta["device_transfer_bytes_d2h"] == 4 * width * len(lines)
    else:
        assert delta["device_transfer_bytes_h2d"] == 0
        assert delta["device_transfer_bytes_d2h"] == 0


def test_the_run_resolves_what_is_left(monkeypatch, recorder):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    times = flight.DEVICE_TIMES
    pending = []

    def parse(batch):
        # Launches whose events complete only after the last drain
        # point: the run's end resolves them.
        pending.append(_pair(times, 0.0, 0.25, done=False))
        times.note("unit", 0, *pending[-1])
        return batch

    def complete(batch):
        for pair in pending:
            for event in pair:
                event.done = True
        return batch

    out = []
    flow = TORCH.Dataflow("spans_end_df")
    s = TORCH.op.input("inp", flow, TORCH.TestingSource([("a", 1.0), ("b", 2.0)], batch_size=1))
    s = TORCH.op.flat_map_batch("parse", s, parse)
    s = TORCH.op.flat_map_batch("complete", s, complete)
    TORCH.op.output("out", s, TORCH.TestingSink(out))
    TORCH.run_main(flow, epoch_interval=ZERO_TD)
    assert sorted(out) == [("a", 1.0), ("b", 2.0)]
    assert len(pending) == 2
    assert len(times) == 0
    assert recorder.counters["unit_device_seconds"] == pytest.approx(0.5)
