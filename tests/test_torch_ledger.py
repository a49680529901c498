"""The epoch ledger and its consumers (``engine/flight.py``): per-epoch
time attribution, ``/status``, Prometheus, the Perfetto
``trace_event`` dump, the attribution-backed rescale hint,
``/healthz``, ``/stacks`` and crash post-mortems, of the torch port
held against the JAX package (the single-process cases of
``tests/test_ledger.py``; the two-process cases are in
``tests/test_torch_ledger_cluster.py``).

Each package keeps its own recorder; a case that reads per-run records
clears its package's sealed-record buffer first.  Times are compared
by their bounds, not their values; phase names, steps, counts and the
documents' shapes are compared exactly.
"""

import json
import os
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from tests.test_torch_both import (  # noqa: F401
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    unsharded,
)

API_PORT = {"jax": 13149, "torch": 13249}


def _main_phases_only(phases):
    return {p: v for p, v in phases.items() if p != "device"}


def _reset_ledger(m):
    rec = m.flight.RECORDER
    rec._ledgers.clear()
    rec.last_ledger = None
    rec._ledger = {}
    rec._ledger_pre_close = None
    rec._epoch_t0 = time.monotonic()


def _phase_sum(phases):
    return sum(s for steps in phases.values() for s in steps.values())


# -- phase attribution sums --------------------------------------------


def test_ledger_phase_sums_all_entry_points(entry_point_name):
    def case(m):
        _reset_ledger(m)
        out = []
        flow = m.Dataflow("ledger_df")
        s = m.op.input("inp", flow, m.TestingSource(list(range(30)), batch_size=6))
        s = m.op.map("work", s, lambda x: (time.sleep(0.002), x * 2)[1])
        m.op.output("out", s, m.TestingSink(out))
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        assert out and len(out) == 30
        records = m.flight.RECORDER.ledgers()
        assert records, "no ledger records sealed"
        for rec in records:
            assert isinstance(rec["epoch"], int)
            main_sum = _phase_sum(_main_phases_only(rec["phases"]))
            assert main_sum <= rec["wall_s"] * 1.05 + 0.002, rec
            assert sum(rec["close"].values()) <= rec["close_s"] * 1.1 + 0.002, rec
            assert rec["close_s"] <= rec["wall_s"] * 1.05 + 0.002
        tail = records[1:]
        if tail:
            wall = sum(r["wall_s"] for r in tail)
            attributed = sum(_phase_sum(_main_phases_only(r["phases"])) for r in tail)
            assert attributed >= 0.45 * wall, (attributed, wall)
        hosts = [r["phases"].get("host", {}) for r in records]
        assert any("ledger_df.work.flat_map_batch" in h for h in hosts), hosts
        return sorted(out), sorted(records[-1])

    want, got = both(case)
    assert got == want


def _windowed_accel_flow(m, n_rows=200):
    align = datetime(2022, 1, 1, tzinfo=timezone.utc)
    base = np.datetime64(align.replace(tzinfo=None), "us")
    batches = [
        m.ArrayBatch(
            {
                "key_id": (np.arange(n_rows) % 2).astype(np.int32),
                "ts": base + (np.arange(n_rows) // 10).astype("timedelta64[s]"),
            },
            key_vocab=np.array(["0", "1"]),
        )
    ]
    clock = m.win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=ZERO_TD)
    windower = m.win.TumblingWindower(align_to=align, length=timedelta(seconds=10))
    out = []
    flow = m.Dataflow("lag_df")
    s = m.op.input("in", flow, m.ArrayBatchSource(batches))
    wo = m.win.count_window("count", s, clock, windower, key=lambda x: x)
    m.op.output("out", wo.down, m.TestingSink(out))
    return flow, out


def test_source_lag_and_device_phase(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(m):
        _reset_ledger(m)
        m.flight.RECORDER._lag.clear()
        device_before = m.flight.RECORDER.phase_totals.get("device", 0.0)
        flow, out = _windowed_accel_flow(m)
        m.run_main(flow, epoch_interval=ZERO_TD)
        assert out
        lag = m.flight.RECORDER._lag
        assert lag.get(("lag_df.in", "event_time"), 0.0) > 0.0
        assert any(kind == "processing" for (_s, kind) in lag), lag
        assert m.sample("bytewax_source_lag_seconds",
                        {"step_id": "lag_df.in", "kind": "event_time"}) > 0.0
        assert m.flight.RECORDER.phase_totals.get("device", 0.0) > device_before
        text = m.exposition()
        assert "bytewax_epoch_phase_seconds" in text
        assert "bytewax_source_lag_seconds" in text
        return sorted(out), sorted(lag)

    want, got = both(case)
    assert got == want


def test_event_lag_nat_timestamp_is_skipped():
    now = datetime.now(timezone.utc)
    ts = np.array(["2022-01-01T00:00:00", "NaT"], dtype="datetime64[us]")

    def case(m):
        batch = m.ArrayBatch({"key_id": np.zeros(2, dtype=np.int32), "ts": ts},
                             key_vocab=np.array(["0"]))
        ok = m.ArrayBatch({"key_id": np.zeros(2, dtype=np.int32), "ts": ts[:1].repeat(2)},
                          key_vocab=np.array(["0"]))
        return m.driver._batch_event_lag_s(batch, now), m.driver._batch_event_lag_s(ok, now)

    want, got = both(case)
    assert got == want
    assert got[0] is None and got[1] > 0


# -- fraction buckets and the attribution-backed rescale hint ----------


def test_ledger_fractions_buckets():
    def case(m):
        fr = m.flight.ledger_fractions({"host": 1.0, "ingest": 1.0, "device": 1.0, "barrier": 1.0})
        return fr, m.flight.ledger_fractions({})

    want, got = both(case)
    assert got == want
    fr, none = got
    assert fr["host"] == 0.5 and fr["device"] == 0.25 and fr["barrier"] == 0.25
    assert abs(sum(fr.values()) - 1.0) < 0.01
    assert none is None


HINTS = {
    "ledger_device_dominated_grows": (
        dict(worker_count=1, epoch_interval_s=10.0, close_p99_s=0.1,
             phase_fractions={"device": 0.4, "flush": 0.2, "host": 0.4}),
        "grow", ("ledger", "device")),
    "barrier_dominated_vetoes_grow": (
        dict(worker_count=2, epoch_interval_s=10.0, close_p99_s=6.0,
             phase_fractions={"barrier": 0.7, "host": 0.3}),
        "hold", ("barrier",)),
    "barrier_dominated_shrinks_when_not_loud": (
        dict(worker_count=2, epoch_interval_s=10.0, close_p99_s=None,
             phase_fractions={"barrier": 0.8, "host": 0.2}),
        "shrink", ("barrier",)),
}


@pytest.mark.parametrize("name", sorted(HINTS))
def test_rescale_hint(name):
    kwargs, advice, words = HINTS[name]

    def case(m):
        return m.driver.derive_rescale_hint(stall_s_per_close=0.0, restores_per_close=0.0,
                                            **kwargs)

    want, got = both(case)
    assert got == want
    assert got[0] == advice
    assert any(all(w in r for w in words) for r in got[1])


# -- Perfetto trace_event export ---------------------------------------


def _trace_events(trace_dir):
    files = sorted(trace_dir.glob("epoch-p00-*.json"))
    assert files, list(trace_dir.iterdir())
    return [(path, json.loads(path.read_text())["traceEvents"]) for path in files]


def test_perfetto_trace_dump(monkeypatch, tmp_path):
    def case(m):
        trace_dir = tmp_path / m.label
        monkeypatch.setenv("BYTEWAX_TPU_TRACE_DIR", str(trace_dir))
        _reset_ledger(m)
        out = []
        flow = m.Dataflow("trace_df")
        s = m.op.input("inp", flow, m.TestingSource(list(range(20)), batch_size=5))
        s = m.op.map("double", s, lambda x: x * 2)
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow, epoch_interval=ZERO_TD)
        assert out
        saw_phase_slice = False
        counter_ts = {}
        kinds = set()
        for path, events in _trace_events(trace_dir):
            assert isinstance(events, list) and events
            for ev in events:
                assert isinstance(ev["name"], str)
                assert ev["ph"] in ("M", "X", "C")
                assert isinstance(ev["pid"], int)
                kinds.add((ev["ph"], ev["name"].split(" ")[0]))
                if ev["ph"] == "X":
                    assert isinstance(ev["ts"], (int, float))
                    assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
                    if ev.get("args", {}).get("step_id"):
                        saw_phase_slice = True
                elif ev["ph"] == "C":
                    assert isinstance(ev["ts"], (int, float))
                    assert ev["args"], ev
                    for v in ev["args"].values():
                        assert isinstance(v, (int, float)), ev
                    counter_ts.setdefault((str(path), ev["name"]), []).append(ev["ts"])
        assert saw_phase_slice
        assert counter_ts
        assert any(name.startswith("rows/s ") for (_p, name) in counter_ts)
        for (path, name), stamps in counter_ts.items():
            assert len(stamps) >= 2, (path, name, stamps)
            assert stamps == sorted(stamps), (path, name, stamps)
        return out, sorted(kinds)

    want, got = both(case)
    assert got[0] == want[0]
    # Which phases an epoch's dump holds follows the run's timing; the
    # event types and the per-step rows/s tracks do not.
    assert {ph for ph, _n in got[1]} == {ph for ph, _n in want[1]} == {"M", "X", "C"}
    assert ("C", "rows/s") in got[1] and ("C", "rows/s") in want[1]


# -- /healthz and /stacks ----------------------------------------------


def test_healthz_and_stacks_during_run(monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label]
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        captured = {}

        class _ProbePartition(m.outputs.StatelessSinkPartition):
            def write_batch(self, items):
                if "health" not in captured:
                    base = f"http://127.0.0.1:{port}"
                    with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
                        captured["health_code"] = resp.status
                        captured["health"] = json.loads(resp.read())
                    with urllib.request.urlopen(base + "/stacks", timeout=5) as resp:
                        captured["stacks"] = resp.read().decode()

        class _ProbeSink(m.outputs.DynamicSink):
            def build(self, step_id, worker_index, worker_count):
                return _ProbePartition()

        flow = m.Dataflow("health_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        m.op.output("out", s, _ProbeSink())
        m.run_main(flow)
        health = captured["health"]
        assert captured["health_code"] == 200
        assert health["live"] is True and health["ready"] is True
        assert health["proc_id"] == 0
        assert isinstance(health["epoch"], int)
        assert "MainThread" in captured["stacks"]
        assert "Thread " in captured["stacks"]
        return captured["health_code"], {k: v for k, v in health.items() if k != "epoch"}

    want, got = both(case)
    assert got == want


def test_healthz_not_ready_is_503(monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label] + 1
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        flow = m.Dataflow("unready_df")
        s = m.op.input("inp", flow, m.TestingSource([1]))
        m.op.output("out", s, m.TestingSink([]))
        srv = m.webserver.maybe_start_server(
            flow, health_fn=lambda: {"ready": False, "phase": "startup"}
        )
        try:
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5)
            return exc_info.value.code, json.loads(exc_info.value.read())
        finally:
            srv.shutdown()

    want, got = both(case)
    assert got == want
    assert got[0] == 503
    assert got[1]["live"] is True and got[1]["ready"] is False


# -- crash post-mortems ------------------------------------------------


def test_postmortem_write_unit(monkeypatch, tmp_path):
    def case(m):
        monkeypatch.delenv("BYTEWAX_TPU_POSTMORTEM_DIR", raising=False)
        assert m.flight.write_postmortem(0, 0, "DeviceFault") is None
        d = tmp_path / m.label
        monkeypatch.setenv("BYTEWAX_TPU_POSTMORTEM_DIR", str(d))
        m.flight.note_phase("host", "pm_df.step", 0.01)
        path = m.flight.write_postmortem(3, 2, "DeviceFault", "boom")
        assert path is not None and os.path.exists(path)
        assert os.path.basename(path) == "postmortem-3-2.json"
        doc = json.loads(open(path).read())
        assert doc["ledger"]["in_flight"]["host"]["pm_df.step"] > 0
        return (sorted(doc), doc["proc_id"], doc["generation"], doc["cause"], doc["detail"])

    want, got = both(case)
    assert got == want
    keys, proc_id, generation, cause, detail = got
    assert (proc_id, generation, cause, detail) == (3, 2, "DeviceFault", "boom")
    assert {"counters", "tail", "ledger"} <= set(keys)


def test_postmortem_on_supervised_restart(monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "snapshot.commit:crash:3:x1")
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")

    def case(m):
        pm_dir = tmp_path / m.label / "pm"
        monkeypatch.setenv("BYTEWAX_TPU_POSTMORTEM_DIR", str(pm_dir))
        rc = m.rc(tmp_path / m.label / "db")
        out = []
        flow = m.Dataflow("pm_df")
        s = m.op.input("inp", flow, m.TestingSource(list(range(12)), batch_size=2))
        s = m.op.map("id", s, lambda x: x)
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow, epoch_interval=ZERO_TD, recovery_config=rc)
        path = pm_dir / "postmortem-0-0.json"
        assert path.exists(), list(pm_dir.iterdir() if pm_dir.exists() else [])
        doc = json.loads(path.read_text())
        assert {"ledger", "counters", "tail"} <= set(doc)
        return doc["cause"], doc["generation"], sorted(doc), sorted(os.listdir(pm_dir))

    want, got = both(case)
    assert got == want
    assert got[:2] == ("InjectedCrash", 0)


# -- comm contract: the piggyback grew, the frame inventory did not ----


def test_ledger_rides_existing_telemetry_no_new_frames():
    def case(m):
        rec = m.flight.FlightRecorder()
        rec.ledger_add("host", "s1", 0.01)
        rec.note_epoch_close(1, 0.002)
        summary = rec.summary(1)
        assert summary["ledger"]["epoch"] == 1
        assert summary["ledger"]["phases"]["host"]["s1"] > 0
        assert not any("ledger" in kind for kind in m.contracts.CONTROL_FRAMES)
        return sorted(summary), sorted(summary["ledger"])

    want, got = both(case)
    assert got == want
    diags, _suppressed, _project = TORCH.analysis.analyze_tree()
    assert not diags, [str(d) for d in diags]
