"""Connector-edge resilience of the torch port held against the JAX
package: every case of ``tests/test_io_resilience.py`` (the backoff
ladder, transient classification, retries through the ``source_poll``
and ``sink_write`` fault sites under the three entry points, escalation
to the supervised restart, the dead-letter queue, partition
quarantine, the random soak's site filter, the metric families and the
Kafka classification), each run through both packages
(``tests/test_torch_both.py``) and compared: outputs, error messages,
dead-letter rows, flight-recorder counters and metric samples, beside
the reference test's own assertions.  The 2-process soak is in
``tests/test_torch_chaos_cluster.py``.  Across packages, a DLQ file
one package wrote is truncated for a resume by the other, and a store
with dead letters that one package aborted resumes in the other.

``CSVSource(on_error="dlq")`` dead-letters a row holding a NUL in both
modes: on Python 3.12 ``csv`` no longer raises on NUL, so the port's
connector checks the raw row itself (the JAX package's does not, and
its copy of the itemized case fails there; ROADMAP C).
"""

import errno
import json
import os
import random
import time
from datetime import timedelta
from types import SimpleNamespace

import pytest

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.testing import TestingSink, run_main
from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    both,
    dlq_rows,
    fresh_faults,
    io_env,
    neutral,
    port_on_cpu,
    shape,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)


# -- dead-letter queue --------------------------------------------------


def test_csv_dlq_poison_row_itemized(tmp_path, monkeypatch):
    path = tmp_path / "rows.csv"
    path.write_bytes(b"name,score\na,1\nbad\x00row,9\nb,2\n")
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(tmp_path / "dlq"))
    from bytewax_tpu_torch.connectors.files import CSVSource

    out = []
    flow = Dataflow("csv_dlq_df")
    s = op.input("inp", flow, CSVSource(str(path), on_error="dlq"))
    op.output("out", s, TestingSink(out))
    run_main(flow, epoch_interval=ZERO_TD)
    assert out == [
        {"name": "a", "score": "1"},
        {"name": "b", "score": "2"},
    ]
    rows = [
        json.loads(line)
        for line in (tmp_path / "dlq" / "dlq-p00.jsonl").read_text().splitlines()
    ]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["step_id"] == "csv_dlq_df.inp"
    assert "NUL" in rec["error"]
    assert "bad" in rec["payload"]
    assert rec["epoch"] >= 1 and rec["part"].endswith("rows.csv")


def test_csv_dlq_poison_row_columnar(tmp_path, monkeypatch):
    """The columnar reader's vectorized split would take a NUL row as
    data: the chunk holding it goes through the csv fallback, which
    dead-letters the row with its raw line, and the good rows of the
    chunk still flow."""
    path = tmp_path / "rows.csv"
    path.write_bytes(b"name,score\na,1\nbad\x00row,9\nb,2\n")
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(tmp_path / "dlq"))
    from bytewax_tpu_torch.connectors.files import CSVSource

    out = []
    flow = Dataflow("csv_dlq_col_df")
    s = op.input("inp", flow, CSVSource(str(path), columnar=True, on_error="dlq"))
    op.output("out", s, TestingSink(out))
    run_main(flow, epoch_interval=ZERO_TD)
    assert out == [
        {"name": "a", "score": "1"},
        {"name": "b", "score": "2"},
    ]
    rows = [
        json.loads(line)
        for line in (tmp_path / "dlq" / "dlq-p00.jsonl").read_text().splitlines()
    ]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["step_id"] == "csv_dlq_col_df.inp"
    assert "NUL" in rec["error"]
    assert rec["payload"] == "bad\x00row,9\n"


@pytest.mark.parametrize("columnar", [False, True], ids=["itemized", "columnar"])
def test_csv_dlq_row_ending_in_nul(tmp_path, monkeypatch, columnar):
    """A NUL that ends a line is dead-lettered alike in both modes: the
    columnar reader's fixed-width line arrays would drop it, so in
    dead-letter mode a chunk holding a NUL splits into exact lines and
    takes the csv fallback, which dead-letters the row with its raw
    line as the itemized reader does."""
    path = tmp_path / "rows.csv"
    path.write_bytes(b"name,score\na,1\nbad\x00\nb,2\n")
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(tmp_path / "dlq"))
    from bytewax_tpu_torch.connectors.files import CSVSource

    out = []
    flow = Dataflow("csv_dlq_tail_df")
    s = op.input("inp", flow, CSVSource(str(path), columnar=columnar, on_error="dlq"))
    op.output("out", s, TestingSink(out))
    run_main(flow, epoch_interval=ZERO_TD)
    assert out == [
        {"name": "a", "score": "1"},
        {"name": "b", "score": "2"},
    ]
    rows = [
        json.loads(line)
        for line in (tmp_path / "dlq" / "dlq-p00.jsonl").read_text().splitlines()
    ]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["step_id"] == "csv_dlq_tail_df.inp"
    assert rec["error"] == "Error: line contains NUL"
    assert rec["payload"] == "bad\x00\n"


# -- the unified backoff helper (engine/backoff.py) ---------------------


def test_backoff_deterministic_per_seed_desynced_per_proc():
    def delays(m, proc):
        rng = m.backoff.seeded_rng("io", proc)
        return [m.backoff.backoff_delay(0.5, a, rng=rng) for a in range(1, 7)]

    for proc in (0, 1, 2):
        assert delays(TORCH, proc) == delays(JAX, proc)
    assert delays(TORCH, 0) == delays(TORCH, 0)
    assert delays(TORCH, 0) != delays(TORCH, 1) != delays(TORCH, 2)


def test_backoff_bounds_and_cap():
    def draws(m):
        rng = m.backoff.seeded_rng("bounds", 0)
        out = []
        for attempt in range(1, 12):
            curve = min(0.5 * 2 ** (attempt - 1), 30.0)
            d = m.backoff.backoff_delay(0.5, attempt, rng=rng)
            assert 0.5 * curve <= d < 1.5 * curve
            out.append(d)
        fixed = [m.backoff.backoff_delay(1.0, a, cap=4.0) for a in (1, 2, 3, 4)]
        assert fixed == [1.0, 2.0, 4.0, 4.0]
        assert m.backoff.backoff_delay(0.05, 5000, cap=30.0) == 30.0
        return out

    want, got = both(draws)
    assert got == want


def test_backoff_supervisor_parity():
    for m in BOTH:
        a = m.driver._backoff_delay(0.5, 3, random.Random("x"))
        b = m.backoff.backoff_delay(0.5, 3, rng=random.Random("x"))
        assert a == b
    assert TORCH.driver._backoff_delay(0.5, 3, random.Random("x")) == (
        JAX.driver._backoff_delay(0.5, 3, random.Random("x"))
    )


def test_backoff_ladder_object():
    def ladder(m):
        b = m.backoff.Backoff(0.5, cap=2.0)
        delays = [b.next_delay() for _ in range(3)]
        failures = b.failures
        b.reset()
        return delays, failures, b.failures

    want, got = both(ladder)
    assert got == want == ([0.5, 1.0, 2.0], 3, 0)


# -- transient classification -------------------------------------------


def _classified(m):
    e = m.errors
    cases = [
        e.TransientSourceError("x"),
        e.TransientSinkError("x"),
        TimeoutError(),
        OSError(errno.EAGAIN, os.strerror(errno.EAGAIN)),
        ConnectionResetError(errno.ECONNRESET, "r"),
        OSError(errno.ENOENT, "gone"),
        PermissionError(errno.EACCES, "no"),
        ValueError("bug"),
        e.ClusterPeerDead("peer", peer=1),
    ]
    return [e.is_transient_io_error(c) for c in cases]


def test_transient_classification():
    want, got = both(_classified)
    assert got == want == [True] * 5 + [False] * 4


def test_transient_errors_are_restartable():
    for m in BOTH:
        assert isinstance(m.errors.TransientSourceError("x"), m.driver._RESTARTABLE)
        assert isinstance(m.errors.TransientSinkError("x"), m.driver._RESTARTABLE)
    assert [c.__name__ for c in TORCH.driver._RESTARTABLE] == [
        c.__name__ for c in JAX.driver._RESTARTABLE
    ]


# -- retry through the real fault sites, all 3 entry points -------------


def test_source_poll_transient_retry_exactly_once(entry_point_name, monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "source_poll:error:*:x2")
    io_env(monkeypatch)
    inp = [(f"k{i % 3}", i) for i in range(12)]

    def case(m):
        out = []
        flow = m.Dataflow("io_src_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=2))
        m.op.output("out", s, m.TestingSink(out))
        retries = m.counter("io_retries_count")
        restarts = m.counter("worker_restart_count")
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        assert out == inp
        assert m.counter("io_retries_count") >= retries + 2
        assert m.counter("worker_restart_count") == restarts
        return out, m.counter("io_retries_count") - retries

    want, got = both(case)
    assert got == want


def test_sink_write_transient_retry_exactly_once(entry_point_name, monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "sink_write:error:*:x2")
    io_env(monkeypatch)
    inp = list(range(10))

    def case(m):
        out = []
        flow = m.Dataflow("io_sink_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=2))
        m.op.output("out", s, m.TestingSink(out))
        retries = m.counter("io_retries_count")
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        return out, m.counter("io_retries_count") - retries

    want, got = both(case)
    assert got == want
    assert got[0] == inp


def _flaky_source(m):
    class FlakyPart(m.inputs.StatefulSourcePartition):
        def __init__(self, resume):
            self._i = resume or 0
            self._flaked = 0

        def next_batch(self):
            if self._i >= 5:
                raise StopIteration()
            if self._i == 2 and self._flaked < 2:
                self._flaked += 1
                raise OSError(errno.EAGAIN, "try again")
            self._i += 1
            return [self._i - 1]

        def snapshot(self):
            return self._i

    class FlakySource(m.inputs.FixedPartitionedSource):
        def list_parts(self):
            return ["p0"]

        def build_part(self, step_id, name, resume):
            return FlakyPart(resume)

    return FlakySource()


def test_user_source_transient_oserror_classified(monkeypatch):
    io_env(monkeypatch)

    def case(m):
        out = []
        flow = m.Dataflow("flaky_df")
        s = m.op.input("inp", flow, _flaky_source(m))
        m.op.output("out", s, m.TestingSink(out))
        retries = m.counter("io_retries_count")
        m.run_main(flow, epoch_interval=ZERO_TD)
        return out, m.counter("io_retries_count") - retries

    want, got = both(case)
    assert got == want
    assert got[0] == [0, 1, 2, 3, 4]


# -- escalation: exhaustion -> restartable fault -> supervisor ----------


def _raised_by(m, site, flow_id):
    flow = m.Dataflow(flow_id)
    s = m.op.input("inp", flow, m.TestingSource([1, 2], batch_size=1))
    m.op.output("out", s, m.TestingSink([]))
    with pytest.raises(BaseException) as info:
        m.run_main(flow, epoch_interval=ZERO_TD)
    return info.value


@pytest.mark.parametrize(
    "site,error",
    [("source_poll", "TransientSourceError"), ("sink_write", "TransientSinkError")],
)
def test_exhaustion_escalates_restartable(monkeypatch, site, error):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", f"{site}:error:*")
    io_env(monkeypatch, retries=1)
    monkeypatch.delenv("BYTEWAX_TPU_MAX_RESTARTS", raising=False)
    want, got = both(_raised_by, site, "esc_df")
    for m, ex in ((JAX, want), (TORCH, got)):
        assert isinstance(ex, getattr(m.errors, error)), ex
        assert "exhausted" in str(ex)
    assert neutral(str(got)) == str(want)


def test_sink_plain_oserror_is_not_retried(monkeypatch):
    io_env(monkeypatch)

    def case(m):
        class HalfWrittenPart(m.outputs.StatelessSinkPartition):
            def write_batch(self, items):
                raise OSError(errno.ECONNRESET, "reset mid-batch")

        class HalfWrittenSink(m.outputs.DynamicSink):
            def build(self, step_id, worker_index, worker_count):
                return HalfWrittenPart()

        flow = m.Dataflow("half_sink_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2]))
        m.op.output("out", s, HalfWrittenSink())
        retries = m.counter("io_retries_count")
        with pytest.raises(OSError) as info:
            m.run_main(flow, epoch_interval=ZERO_TD)
        assert m.counter("io_retries_count") == retries
        return type(info.value).__name__, info.value.errno

    want, got = both(case)
    assert got == want


def _stateful_file_flow(m, inp, out_path):
    flow = m.Dataflow("io_esc_df")
    s = m.op.input("inp", flow, m.TestingSource(inp))
    s = m.op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
    s = m.op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    m.op.output("out", s, m.files.FileSink(out_path))
    return flow


@pytest.mark.parametrize("site", ["source_poll", "sink_write"])
def test_escalation_supervised_restart_exactly_once(
    entry_point_name, tmp_path, monkeypatch, site
):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", f"{site}:error:*:x3")
    io_env(monkeypatch, retries=1)
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "3")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    inp = [(f"k{i % 3}", i) for i in range(12)]
    sums, want_lines = {}, []
    for k, v in inp:
        sums[k] = sums.get(k, 0) + v
        want_lines.append(f"{k}={sums[k]}")

    def case(m):
        out_path = tmp_path / m.label / "out.txt"
        rc = m.rc(tmp_path / m.label / "db")
        restarts = m.counter("worker_restart_count")
        m.entry(entry_point_name)(
            _stateful_file_flow(m, inp, str(out_path)),
            epoch_interval=ZERO_TD,
            recovery_config=rc,
        )
        assert m.counter("worker_restart_count") >= restarts + 1
        lines = sorted(out_path.read_text().split())
        assert lines == sorted(want_lines)
        return lines

    want, got = both(case)
    assert got == want


# -- dead-letter queue --------------------------------------------------


def test_file_dlq_undecodable_line_columnar(tmp_path, monkeypatch):
    path = tmp_path / "lines.txt"
    path.write_bytes(b"one\n\xff\xfe broken\ntwo\n")

    def case(m):
        dlq_dir = tmp_path / m.label / "dlq"
        monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(dlq_dir))
        out = []
        flow = m.Dataflow("file_dlq_df")
        src = m.files.FileSource(str(path), columnar=True, on_error="dlq")
        s = m.op.input("inp", flow, src)
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow, epoch_interval=ZERO_TD)
        rows = dlq_rows(dlq_dir / "dlq-p00.jsonl")
        assert out == ["one", "two"]
        assert len(rows) == 1
        assert "UnicodeDecodeError" in rows[0]["error"]
        return out, [{k: r[k] for k in r if k != "t"} for r in rows]

    want, got = both(case)
    assert got == want


def test_file_columnar_strict_mode_still_raises(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_bytes(b"one\n\xff\xfe broken\ntwo\n")

    def case(m):
        flow = m.Dataflow("file_strict_df")
        s = m.op.input("inp", flow, m.files.FileSource(str(path), columnar=True))
        m.op.output("out", s, m.TestingSink([]))
        with pytest.raises(UnicodeDecodeError) as info:
            m.run_main(flow, epoch_interval=ZERO_TD)
        return info.value.reason, info.value.start

    want, got = both(case)
    assert got == want


def _kafka_case(m, tag, frames, on_error=None, **source_kw):
    """Runs one ``KafkaSource`` flow over a broker of its own, built
    from ``frames`` (``("msg", key, value, partition)`` or
    ``("error", partition, code, text)``), under the port's fake
    ``confluent_kafka``, the one both packages' connectors reach."""
    inmem = TORCH.inmem
    address = f"inmem://{tag}-{m.label}"
    broker = inmem.broker_for(address)
    parts = 1 + max(f[3] if f[0] == "msg" else f[1] for f in frames)
    broker.create_topic("ev", partitions=parts)
    for f in frames:
        if f[0] == "msg":
            broker.produce("ev", key=f[1], value=f[2], partition=f[3])
        else:
            broker.inject_error("ev", f[1], f[2], f[3])
    out = []
    kw = dict(tail=False, **source_kw)
    if on_error is not None:
        kw["on_error"] = on_error
    with inmem.installed():
        flow = m.Dataflow(f"kafka_{tag}_df")
        s = m.op.input("inp", flow, m.kafka.KafkaSource([address], ["ev"], **kw))
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow, epoch_interval=ZERO_TD)
    return [msg.value for msg in out]


def test_kafka_dlq_error_frames(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", "")
    frames = [
        ("msg", b"k", b"a", 0),
        ("error", 0, 1, "OFFSET_OUT_OF_RANGE"),
        ("msg", b"k", b"b", 0),
    ]

    def case(m):
        dlq = m.counter("dlq_records_count")
        values = _kafka_case(m, "dlq", frames, on_error="dlq")
        return values, m.counter("dlq_records_count") - dlq

    want, got = both(case)
    assert got == want == ([b"a", b"b"], 1)


def test_kafka_dlq_transient_frames_take_retry_ladder(monkeypatch):
    io_env(monkeypatch)
    frames = [
        ("msg", b"k", b"a", 0),
        ("error", 0, -195, "broker transport failure"),
        ("msg", b"k", b"b", 0),
    ]

    def case(m):
        dlq = m.counter("dlq_records_count")
        retries = m.counter("io_retries_count")
        values = _kafka_case(m, "dlqt", frames, on_error="dlq")
        assert m.counter("io_retries_count") > retries
        return values, m.counter("dlq_records_count") - dlq

    want, got = both(case)
    assert got == want == ([b"a", b"b"], 0)


class _AbortOnce:
    def __init__(self):
        self.spent = False


def _dlq_source(m, items):
    class _DlqPart(m.inputs.StatefulSourcePartition):
        def __init__(self, resume):
            self._i = resume or 0
            self._dead = []

        def next_batch(self):
            if self._i >= len(items):
                raise StopIteration()
            it = items[self._i]
            if isinstance(it, _AbortOnce):
                if not it.spent:
                    it.spent = True
                    raise m.inputs.AbortExecution()
                self._i += 1
                return []
            self._i += 1
            if isinstance(it, tuple) and it[0] == "poison":
                self._dead.append({"error": "poison", "payload": it[1]})
                return []
            return [it]

        def drain_dead_letters(self):
            dead, self._dead = self._dead, []
            return dead

        def snapshot(self):
            return self._i

    class _DlqSource(m.inputs.FixedPartitionedSource):
        def list_parts(self):
            return ["p0"]

        def build_part(self, step_id, name, resume):
            return _DlqPart(resume)

    return _DlqSource()


def _dlq_items():
    return [1, ("poison", "p0"), 2, 3, ("poison", "p1"), _AbortOnce(), 4,
            ("poison", "p2"), 5]


def _dlq_run(m, items, db, out):
    flow = m.Dataflow("dlq_resume_df")
    s = m.op.input("inp", flow, _dlq_source(m, items))
    m.op.output("out", s, m.TestingSink(out))
    m.run_main(flow, epoch_interval=ZERO_TD, recovery_config=m.RecoveryConfig(str(db)))


def _dlq_view(dlq_dir):
    rows = dlq_rows(dlq_dir / "dlq-p00.jsonl")
    return sorted((r["payload"], r["step_id"], r["epoch"], r["error"]) for r in rows)


def test_dlq_rows_survive_abort_resume_exactly_once(tmp_path, monkeypatch):
    def case(m):
        dlq_dir = tmp_path / m.label / "dlq"
        monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(dlq_dir))
        db = tmp_path / m.label / "db"
        m.rc(db)
        items = _dlq_items()
        out = []
        _dlq_run(m, items, db, out)
        _dlq_run(m, items, db, out)
        assert out == [1, 2, 3, 4, 5]
        view = _dlq_view(dlq_dir)
        assert [v[0] for v in view] == ["p0", "p1", "p2"]
        assert {v[1] for v in view} == {"dlq_resume_df.inp"}
        return out, view

    want, got = both(case)
    assert got == want


@pytest.mark.parametrize("first,second", [(JAX, TORCH), (TORCH, JAX)], ids=repr)
def test_dlq_and_store_cross_packages_at_resume(tmp_path, monkeypatch, first, second):
    """A run of one package aborts with dead letters on disk; the other
    package resumes its store, truncates its DLQ file for the resume
    and recaptures the aborted epoch's row: exactly once across the
    two packages, row for row as one package alone gives."""
    dlq_dir = tmp_path / "dlq"
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(dlq_dir))
    db = tmp_path / "db"
    first.rc(db)
    items = _dlq_items()
    out = []
    _dlq_run(first, items, db, out)
    _dlq_run(second, items, db, out)
    assert out == [1, 2, 3, 4, 5]
    crossed = _dlq_view(dlq_dir)

    alone_dir = tmp_path / "alone"
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(alone_dir / "dlq"))
    second.rc(alone_dir / "db")
    items, out = _dlq_items(), []
    _dlq_run(second, items, alone_dir / "db", out)
    _dlq_run(second, items, alone_dir / "db", out)
    assert crossed == _dlq_view(alone_dir / "dlq")


def test_dlq_truncate_for_resume_unit(tmp_path):
    def case(m):
        d = tmp_path / m.label
        d.mkdir()
        dlq = m.dlq.DeadLetterQueue(0, dlq_dir=str(d))
        dlq.capture("s", "p", [{"error": "e1", "payload": "a"}], epoch=1)
        dlq.flush()
        dlq.capture("s", "p", [{"error": "e2", "payload": "b"}], epoch=2)
        dlq.flush()
        dropped = dlq.truncate_for_resume(2)
        rows = [r["payload"] for r in dlq_rows(d / "dlq-p00.jsonl")]
        again = dlq.truncate_for_resume(2)
        return dropped, rows, again

    want, got = both(case)
    assert got == want == (1, ["a"], 0)


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)], ids=repr)
def test_dlq_file_truncated_by_the_other_package(tmp_path, writer, reader):
    """A DLQ file that one package wrote is read and truncated for a
    resume by the other: the formats are one."""
    dlq = writer.dlq.DeadLetterQueue(0, dlq_dir=str(tmp_path))
    for epoch, payload in ((1, "a"), (2, "b"), (3, "c")):
        dlq.capture("s", "p", [{"error": "e", "payload": payload}], epoch=epoch)
        dlq.flush()
    other = reader.dlq.DeadLetterQueue(0, dlq_dir=str(tmp_path))
    assert other.truncate_for_resume(2) == 2
    assert [r["payload"] for r in dlq_rows(tmp_path / "dlq-p00.jsonl")] == ["a"]
    other.capture("s", "p", [{"error": "e", "payload": "b2"}], epoch=2)
    other.flush()
    rows = dlq_rows(tmp_path / "dlq-p00.jsonl")
    assert [(r["payload"], r["epoch"]) for r in rows] == [("a", 1), ("b2", 2)]


# -- partition quarantine -----------------------------------------------


def _two_part_source(m, n, fail_polls, good_delay_ms=0.0):
    from datetime import datetime, timezone

    bad_fails = {"left": fail_polls}

    class Part(m.inputs.StatefulSourcePartition):
        def __init__(self, name, resume):
            self._name = name
            self._i = resume or 0
            self._awake = None

        def next_batch(self):
            if self._name == "p_bad" and bad_fails["left"] > 0:
                bad_fails["left"] -= 1
                raise m.errors.TransientSourceError("edge down")
            if self._i >= n:
                raise StopIteration()
            self._i += 1
            if self._name == "p_good" and good_delay_ms:
                self._awake = datetime.now(timezone.utc) + timedelta(
                    milliseconds=good_delay_ms
                )
            return [(self._name, self._i)]

        def next_awake(self):
            return self._awake

        def snapshot(self):
            return self._i

    class TwoPartSource(m.inputs.FixedPartitionedSource):
        def list_parts(self):
            return ["p_bad", "p_good"]

        def build_part(self, step_id, name, resume):
            return Part(name, resume)

    return TwoPartSource()


def _events_since(m, t0):
    return [e for e in m.flight.RECORDER.tail(512) if e["t"] >= t0]


def test_quarantine_parks_partition_keeps_rest_flowing(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_QUARANTINE", "1")
    io_env(monkeypatch, retries=1, backoff="0.002")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    n = 8

    def case(m):
        out = []
        flow = m.Dataflow("quarantine_df")
        s = m.op.input("inp", flow, _two_part_source(m, n, 4, good_delay_ms=3))
        m.op.output("out", s, m.TestingSink(out))
        t0 = time.time()
        m.run_main(flow, epoch_interval=ZERO_TD)
        events = _events_since(m, t0)
        kinds = [e["kind"] for e in events]
        q_at = kinds.index("quarantine")
        uq_at = kinds.index("unquarantine", q_at)
        assert events[q_at]["part"] == "p_bad"
        assert "epoch_close" in kinds[q_at:uq_at]
        assert events[uq_at]["step"] == "quarantine_df.inp"
        gauge = m.counter("quarantined_partitions[quarantine_df.inp]", None)
        assert gauge == 0
        return sorted(out), gauge

    want, got = both(case)
    assert got == want
    assert got[0] == sorted((p, i) for p in ("p_bad", "p_good") for i in range(1, n + 1))


def test_quarantine_resets_on_runtime_close_and_hands_off_offset(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_QUARANTINE", "1")
    io_env(monkeypatch, retries=1, backoff="0.002")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    n = 8

    def case(m):
        m.flight.RECORDER.activate(True)
        rc = m.rc(tmp_path / m.label / "db")
        seen = {"count": 0}

        def trig(item):
            seen["count"] += 1
            if seen["count"] == n:
                m.driver.request_stop()
            return item

        out = []
        flow = m.Dataflow("q_reset_df")
        s = m.op.input("inp", flow, _two_part_source(m, n, 10_000))
        s = m.op.map("trig", s, trig)
        m.op.output("out", s, m.TestingSink(out))
        status = m.run_main(flow, epoch_interval=ZERO_TD, recovery_config=rc)
        assert status is not None
        gauge = m.counter("quarantined_partitions[q_reset_df.inp]", None)
        assert gauge == 0
        assert any(e["kind"] == "quarantine" for e in m.flight.RECORDER.tail(512))

        out2 = []
        flow2 = m.Dataflow("q_reset_df")
        s2 = m.op.input("inp", flow2, _two_part_source(m, n, 0))
        m.op.output("out", s2, m.TestingSink(out2))
        status2 = m.run_main(flow2, epoch_interval=ZERO_TD, recovery_config=rc)
        assert status2 is None
        return type(status).__name__, sorted(out), sorted(out2)

    want, got = both(case)
    assert got == want
    assert got[1] == [("p_good", i) for i in range(1, n + 1)]
    assert got[2] == [("p_bad", i) for i in range(1, n + 1)]


def test_file_source_itemized_dlq_refused():
    def case(m):
        msgs = []
        for make in (
            lambda: m.files.FileSource("/tmp/x.txt", on_error="dlq"),
            lambda: m.files.DirSource("/tmp", on_error="dlq"),
        ):
            with pytest.raises(ValueError, match="columnar=True") as info:
                make()
            msgs.append(str(info.value))
        return msgs

    want, got = both(case)
    assert neutral(got) == want


def test_quarantined_partition_eof_clears_gauge(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_QUARANTINE", "1")
    io_env(monkeypatch, retries=1, backoff="0.002")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")

    def case(m):
        class DrainedPart(m.inputs.StatefulSourcePartition):
            def __init__(self, name, resume):
                self._name = name
                self._i = resume or 0
                self._fails = 0

            def next_batch(self):
                if self._name == "p_bad":
                    if self._fails < 3:
                        self._fails += 1
                        raise m.errors.TransientSourceError("down")
                    raise StopIteration()
                if self._i >= 4:
                    raise StopIteration()
                self._i += 1
                return [(self._name, self._i)]

            def snapshot(self):
                return self._i

        class Src(m.inputs.FixedPartitionedSource):
            def list_parts(self):
                return ["p_bad", "p_good"]

            def build_part(self, step_id, name, resume):
                return DrainedPart(name, resume)

        out = []
        flow = m.Dataflow("q_eof_df")
        s = m.op.input("inp", flow, Src())
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow, epoch_interval=ZERO_TD)
        return sorted(out), m.counter("quarantined_partitions[q_eof_df.inp]", None)

    want, got = both(case)
    assert got == want == ([("p_good", i) for i in range(1, 5)], 0)


def test_quarantine_off_escalates_instead(monkeypatch):
    monkeypatch.delenv("BYTEWAX_TPU_QUARANTINE", raising=False)
    io_env(monkeypatch, retries=1, backoff="0.002")

    def case(m):
        flow = m.Dataflow("noq_df")
        s = m.op.input("inp", flow, _two_part_source(m, 4, 10))
        m.op.output("out", s, m.TestingSink([]))
        with pytest.raises(m.errors.TransientSourceError, match="exhausted") as info:
            m.run_main(flow, epoch_interval=ZERO_TD)
        return str(info.value)

    want, got = both(case)
    assert neutral(got) == want


def test_source_health_section():
    def case(m):
        rt = m.driver._InputRt.__new__(m.driver._InputRt)
        rt.op = SimpleNamespace(step_id="s")
        rt.parts = {"a": None, "b": None, "c": None}
        rt._quarantined = {
            "a": {
                "since": time.monotonic() - 2.0,
                "fails": 7,
                "last_error": "TransientSourceError: down",
            }
        }
        rt._io_fails = {"b": 2}
        rt._last_io_error = {"b": "OSError: flaky"}
        health = rt.source_health()
        assert health["a"]["parked_s"] >= 1.9
        health["a"].pop("parked_s")
        return health

    want, got = both(case)
    assert got == want
    assert got["a"]["state"] == "quarantined"
    assert got["a"]["consecutive_failures"] == 7
    assert got["b"] == {
        "state": "retrying",
        "consecutive_failures": 2,
        "last_error": "OSError: flaky",
    }
    assert got["c"] == {"state": "ok"}


def test_status_exposes_source_health_and_dlq(monkeypatch):
    def case(m):
        seen = {}
        orig = m.driver._Driver._close_epoch

        def spy(self, workers=None):
            seen.setdefault("status", self._status())
            return orig(self, workers)

        monkeypatch.setattr(m.driver._Driver, "_close_epoch", spy)
        flow = m.Dataflow("status_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        m.op.output("out", s, m.TestingSink([]))
        m.run_main(flow, epoch_interval=ZERO_TD)
        status = seen["status"]
        assert status["source_health"] == {"status_df.inp": {"iterable": {"state": "ok"}}}
        assert set(status["dlq"]) == {"dir", "captured", "pending_flush"}
        return status["source_health"], shape(status["dlq"])

    want, got = both(case)
    assert got == want


# -- chaos soak plumbing ------------------------------------------------


def test_random_soak_site_filter(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "random")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_SITES", "source_poll")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_KINDS", "error")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_RATE", "1.0")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_MIN_GAP_S", "0")

    def case(m):
        m.faults.reset()
        m.faults.configure(0)
        fired = [m.faults.fire("comm.send"), m.faults.fire("barrier")]
        with pytest.raises(m.errors.TransientSourceError) as info:
            m.faults.fire("source_poll", step="s", part="p")
        return fired, str(info.value)

    want, got = both(case)
    assert got == want
    assert got[0] == [None, None]


def test_random_soak_unknown_site_rejected(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "random")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_SITES", "nope")

    def case(m):
        m.faults.reset()
        with pytest.raises(ValueError, match="unknown fault site") as info:
            m.faults.configure(0)
        return str(info.value)

    want, got = both(case)
    assert got == want


def test_metric_families_registered(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "source_poll:error:*:x1")
    io_env(monkeypatch)
    families = (
        "bytewax_io_retries_count",
        "bytewax_dlq_records_count",
        "bytewax_quarantined_partitions",
    )

    def case(m):
        flow = m.Dataflow("fam_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2]))
        m.op.output("out", s, m.TestingSink([]))
        m.run_main(flow, epoch_interval=ZERO_TD)
        text = m.exposition()
        return [f in text for f in families]

    want, got = both(case)
    assert got == want == [True, True, True]
    # The port serves its engine families through its own exposition.
    text = TORCH.metrics.generate_python_metrics()
    assert all(f in text for f in families)


# -- kafka classification ----------------------------------------------


def test_kafka_transient_code_classification():
    inmem = TORCH.inmem

    class Retriable:
        def retriable(self):
            return True

        def code(self):
            return 999

    def case(m):
        is_t = m.kafka.is_transient_kafka_error
        return (
            [
                is_t(inmem.KafkaError(-195, "transport")),
                is_t(inmem.KafkaError(7, "req timeout")),
                is_t(inmem.KafkaError(1, "offset oor")),
                is_t(None),
                is_t(Retriable()),
            ],
            sorted(m.kafka.TRANSIENT_KAFKA_CODES),
        )

    want, got = both(case)
    assert got == want
    assert got[0] == [True, True, False, False, True]
    assert -195 in got[1]


def test_kafka_transient_poll_error_retried_in_place(monkeypatch):
    io_env(monkeypatch)
    frames = (
        [("msg", b"k", str(i).encode(), 0) for i in range(3)]
        + [("error", 0, -195, "broker transport failure")]
        + [("msg", b"k", str(i).encode(), 0) for i in range(3, 6)]
    )

    def case(m):
        restarts = m.counter("worker_restart_count")
        values = _kafka_case(m, "transient", frames, batch_size=100)
        assert m.counter("worker_restart_count") == restarts
        return values

    want, got = both(case)
    assert got == want == [str(i).encode() for i in range(6)]


def test_kafka_partition_quarantine_keeps_others_flowing(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_QUARANTINE", "1")
    io_env(monkeypatch, retries=1, backoff="0.002")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    frames = (
        [("error", 0, -195, "broker transport failure")] * 4
        + [("msg", None, f"p0-{i}".encode(), 0) for i in range(4)]
        + [("msg", None, f"p1-{i}".encode(), 1) for i in range(8)]
    )

    def case(m):
        t0 = time.time()
        values = _kafka_case(m, "quarantine", frames, batch_size=1)
        events = _events_since(m, t0)
        kinds = [e["kind"] for e in events]
        q_at = kinds.index("quarantine")
        uq_at = kinds.index("unquarantine", q_at)
        assert events[q_at]["part"].startswith("0-ev")
        assert "epoch_close" in kinds[q_at:uq_at]
        return sorted(values)

    want, got = both(case)
    assert got == want == sorted(
        [f"p0-{i}".encode() for i in range(4)] + [f"p1-{i}".encode() for i in range(8)]
    )


def test_kafka_nontransient_error_still_raises():
    frames = [("msg", b"k", b"a", 0), ("error", 0, 1, "OFFSET_OUT_OF_RANGE")]

    def case(m):
        with pytest.raises(RuntimeError, match="error consuming") as info:
            _kafka_case(m, "fatal", frames)
        return str(info.value).replace(m.label, "")

    want, got = both(case)
    assert got == want
