"""The asynchronous device-dispatch pipeline (``engine/pipeline.py``)
of the torch port held against the JAX package: every case of
``tests/test_pipeline.py``.

The primitive's cases drive both packages' ``DevicePipeline`` alike;
the flow cases run one flow through both: flush-before-snapshot across
an abort on the device tier and a resume on the host tier (under each
package's three entry points), window streams at depths 1, 2 and 4,
a mid-pipeline ``device_dispatch`` fault that retries and then demotes
with the folds in flight, and the pipeline's metrics.

The window streams are compared as multisets across packages and
depths: which of several windows closing together is emitted first
follows the wall clock (ROADMAP C, a flake of the JAX package's own
test); the port's runs at the three depths must give one stream.
Tolerance: EMA values within 1e-4 of the unbroken host oracle, as the
reference test holds them.
"""

import inspect
from collections import Counter
from datetime import datetime, timedelta, timezone

import pytest

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    unsharded,
)

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)


# -- the DevicePipeline primitive ---------------------------------------


def test_pipeline_depth_env(monkeypatch):
    def case(m):
        monkeypatch.delenv("BYTEWAX_TPU_PIPELINE_DEPTH", raising=False)
        got = [m.pipeline.pipeline_depth()]
        for raw in ("4", "0"):
            monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", raw)
            got.append(m.pipeline.pipeline_depth())
        monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "nope")
        with pytest.raises(ValueError, match="PIPELINE_DEPTH") as info:
            m.pipeline.pipeline_depth()
        return got, str(info.value)

    want, got = both(case)
    assert got == want
    assert got[0] == [2, 4, 1]


def test_pipeline_finalizes_in_submission_order():
    def case(m):
        pipe = m.pipeline.DevicePipeline("s", depth=3)
        done = []
        try:
            for i in range(6):
                pipe.push(lambda i=i: i, lambda r: done.append(r))
            pipe.flush()
        finally:
            pipe.shutdown()
        return done

    want, got = both(case)
    assert got == want == [0, 1, 2, 3, 4, 5]


def test_pipeline_bounds_in_flight_work():
    def case(m):
        pipe = m.pipeline.DevicePipeline("s", depth=2)
        done = []
        try:
            pipe.push(lambda: "a", done.append)
            pipe.push(lambda: "b", done.append)
            seen = (list(done), len(pipe))
            pipe.flush()
        finally:
            pipe.shutdown()
        return seen, done

    want, got = both(case)
    assert got == want == ((["a"], 1), ["a", "b"])


def test_pipeline_depth1_runs_inline():
    def case(m):
        pipe = m.pipeline.DevicePipeline("s", depth=1)
        done = []
        pipe.push(lambda: "now", done.append)
        pending = pipe.pending()
        pipe.shutdown()
        return done, pending, pipe._worker if hasattr(pipe, "_worker") else None

    want, got = both(case)
    assert got == want
    assert got[:2] == (["now"], False)


def test_pipeline_task_error_surfaces_at_drain():
    def case(m):
        pipe = m.pipeline.DevicePipeline("s", depth=2)

        def boom():
            raise RuntimeError("device phase failed")

        try:
            pipe.push(boom, lambda r: None)
            with pytest.raises(RuntimeError, match="device phase failed") as info:
                pipe.flush()
            return str(info.value), pipe.pending()
        finally:
            pipe.shutdown()

    want, got = both(case)
    assert got == want == ("device phase failed", False)


# -- flush-before-snapshot: cross-tier recovery at depth >= 2 -----------


def _scan_flow(m, inp, out):
    flow = m.Dataflow("pipe_scan_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=2))
    s = m.op.stateful_map("scan", s, m.xla.ema(0.5))
    m.op.output("out", s, m.TestingSink(out))
    return flow


def _per_key(rows):
    by = {}
    for k, v in rows:
        by.setdefault(k, []).append(v)
    return by


def test_flush_before_snapshot_cross_tier_recovery(entry_point_name, tmp_path, monkeypatch):
    items = [("a", 1.0), ("a", 2.0), ("b", 5.0), ("a", 4.0)]
    tail = [("a", 3.0), ("b", 6.0)]

    def case(m):
        monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "3")
        monkeypatch.delenv("BYTEWAX_TPU_ACCEL", raising=False)
        rc = m.rc(tmp_path / m.label)
        inp = items + [m.TestingSource.ABORT()] + tail
        run = m.entry(entry_point_name)
        out1, out2 = [], []
        run(_scan_flow(m, inp, out1), epoch_interval=ZERO_TD, recovery_config=rc)
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
        run(_scan_flow(m, inp, out2), epoch_interval=ZERO_TD, recovery_config=rc)
        got = _per_key(out1 + out2)
        assert {k: [v for v, _e in vs] for k, vs in got.items()} == _per_key(items + tail)
        oracle_out = []
        m.run_main(_scan_flow(m, items + tail, oracle_out), epoch_interval=ZERO_TD)
        for key, rows in _per_key(oracle_out).items():
            for (gv, ge), (ov, oe) in zip(got[key], rows):
                assert gv == ov
                assert ge == pytest.approx(oe, abs=1e-4)
        monkeypatch.delenv("BYTEWAX_TPU_ACCEL", raising=False)
        return got

    want, got = both(case)
    assert set(got) == set(want)
    for key in want:
        assert [v for v, _e in got[key]] == [v for v, _e in want[key]]
        assert [e for _v, e in got[key]] == pytest.approx([e for _v, e in want[key]], abs=1e-4)


def _window_run(m, monkeypatch, depth):
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", str(depth))
    n = 300
    inp = [(ALIGN + timedelta(seconds=(i * 7) % 120), f"k{i % 3}") for i in range(n)]
    out = []
    flow = m.Dataflow("pipe_depth_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=16))
    clock = m.win.EventClock(ts_getter=lambda item: item[0], wait_for_system_duration=ZERO_TD)
    windower = m.win.TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
    wo = m.win.count_window("count", s, clock, windower, key=lambda item: item[1])
    m.op.output("out", wo.down, m.TestingSink(out))
    m.run_main(flow, epoch_interval=ZERO_TD)
    return out


def test_windowed_outputs_identical_across_depths(monkeypatch):
    port = [_window_run(TORCH, monkeypatch, d) for d in (1, 2, 4)]
    ref = _window_run(JAX, monkeypatch, 1)
    assert Counter(port[0]) == Counter(port[1]) == Counter(port[2]) == Counter(ref)
    assert port[0]


# -- chaos: mid-pipeline DeviceFault retries then demotes ---------------


def test_mid_pipeline_device_fault_retries_then_demotes(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "3")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "device_dispatch:error:2+")
    monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", "3")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    n = 48
    inp = [(f"k{i % 4}", 1.0) for i in range(n)]

    def case(m):
        out = []
        flow = m.Dataflow("pipe_demote_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=4))
        r = m.op.reduce_final("sum", s, m.xla.SUM)
        m.op.output("out", r, m.TestingSink(out))
        faults = m.counter("fault_injected_count")
        demoted = m.counter("demotion_count")
        m.run_main(flow, epoch_interval=ZERO_TD)
        demotions = [e for e in m.flight.RECORDER.tail() if e["kind"] == "demotion"]
        assert demotions and demotions[-1]["step"].startswith("pipe_demote_df.sum")
        assert m.counter("fault_injected_count") - faults >= 3
        return (dict(out), m.counter("fault_injected_count") - faults,
                m.counter("demotion_count") - demoted, demotions[-1]["step"])

    want, got = both(case)
    assert got == want
    assert got[0] == {f"k{i}": n / 4 for i in range(4)}
    assert got[2] == 1


# -- observability ------------------------------------------------------


def test_pipeline_metrics_exposed(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "2")
    inp = [(f"k{i % 2}", float(i)) for i in range(32)]

    def case(m):
        out = []
        flow = m.Dataflow("pipe_metrics_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=4))
        r = m.op.reduce_final("sum", s, m.xla.SUM)
        m.op.output("out", r, m.TestingSink(out))
        m.run_main(flow)
        text = m.exposition()
        return (sorted(out), m.counter("pipeline_depth", None),
                "bytewax_pipeline_depth" in text,
                "bytewax_pipeline_flush_stall_seconds" in text,
                m.sample("bytewax_pipeline_depth", {"step_id": "pipe_metrics_df.sum"}))

    want, got = both(case)
    assert got == want
    assert got[1:4] == (2, True, True)


def test_global_exchange_tier_never_enters_dispatch_pipeline(monkeypatch):
    monkeypatch.delenv("BYTEWAX_TPU_GSYNC_OVERLAP", raising=False)
    for m in BOTH:
        assert m.pipeline.DevicePipeline.__init__.__defaults__ == (None, "device")
        src = inspect.getsource(m.driver._StatefulBatchRt.__init__)
        assert "global_exchange" in src and "DevicePipeline" in src
        assert m.sharded_state._gsync_overlap() is False
