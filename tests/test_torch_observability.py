"""Metrics, the API server, the flight recorder and local tracing
(``_metrics.py``, ``engine/webserver.py``, ``engine/flight.py``,
``tracing.py``) of the torch port held against the JAX package: the
single-process cases of ``tests/test_observability.py`` (the two
cluster cases are in ``tests/test_torch_observability_cluster.py``).

The port's engine families live on ``_metrics.ENGINE_REGISTRY``; its
``/metrics`` serves that registry after the default one.  It has no
``bytewax_xla_compile_*`` families (nothing compiles XLA;
``tests/test_torch_static_contracts.py``), so the family check holds
every other family.  Each package's API server gets a port of its own.
"""

import json
import logging
import threading
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    both,
    fresh_faults,
    port_on_cpu,
    shape,
    unsharded,
)

API_PORT = {"jax": 13131, "torch": 13231}


def _fetch(port, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        body = resp.read()
    return body.decode() if raw else json.loads(body)


def _probe_sink(m, poll):
    class _ProbePartition(m.outputs.StatelessSinkPartition):
        def write_batch(self, items):
            poll()

    class _ProbeSink(m.outputs.DynamicSink):
        def build(self, step_id, worker_index, worker_count):
            return _ProbePartition()

    return _ProbeSink()


def test_item_counters_increment():
    def case(m):
        out = []
        flow = m.Dataflow("metrics_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        s = m.op.map("double", s, lambda x: x * 2)
        m.op.output("out", s, m.TestingSink(out))
        labels = {"step_id": "metrics_df.double.flat_map_batch", "worker_index": "0"}
        before = m.sample("bytewax_item_inp_count_total", labels) or 0
        m.run_main(flow)
        return out, m.sample("bytewax_item_inp_count_total", labels) - before

    want, got = both(case)
    assert got == want == ([2, 4, 6], 3)


def test_dataflow_api_server(monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label]
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        captured = {}

        def poll():
            if "flow" not in captured:
                captured["flow"] = _fetch(port, "/dataflow")
                captured["metrics"] = _fetch(port, "/metrics", raw=True)

        flow = m.Dataflow("api_df")
        s = m.op.input("inp", flow, m.TestingSource([1]))
        m.op.output("out", s, _probe_sink(m, poll))
        m.run_main(flow)
        assert "bytewax_item_inp_count" in captured["metrics"]
        assert (d / "dataflow.json").exists()
        return captured["flow"], json.loads((d / "dataflow.json").read_text())

    want, got = both(case)
    assert got == want
    assert got[0]["flow_id"] == "api_df"


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
    clock = m.win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=timedelta(0))
    windower = m.win.TumblingWindower(align_to=align, length=timedelta(seconds=10))
    out = []
    flow = m.Dataflow("flight_df")
    s = m.op.input("in", flow, m.ArrayBatchSource(batches))
    wo = m.win.count_window("count", s, clock, windower, key=lambda x: x)
    m.op.output("out", wo.down, m.TestingSink(out))
    return flow, out


FAMILIES = (
    "bytewax_epoch_close_duration_seconds",
    "bytewax_barrier_wait_seconds",
    "bytewax_gsync_round_count",
    "bytewax_device_transfer_bytes",
    "bytewax_comm_frames",
)


def test_flight_recorder_metric_families(monkeypatch):
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(m):
        flow, out = _windowed_accel_flow(m)
        h2d = m.sample("bytewax_device_transfer_bytes_total", {"direction": "h2d"}) or 0
        d2h = m.sample("bytewax_device_transfer_bytes_total", {"direction": "d2h"}) or 0
        m.run_main(flow, epoch_interval=timedelta(0))
        text = m.exposition()
        for family in FAMILIES:
            assert family in text, f"{family} missing from {m}'s exposition"
        assert m.sample("bytewax_epoch_close_duration_seconds_count") >= 1
        assert m.sample("bytewax_device_transfer_bytes_total", {"direction": "h2d"}) > h2d
        assert m.sample("bytewax_device_transfer_bytes_total", {"direction": "d2h"}) > d2h
        rec = m.flight.RECORDER
        assert rec.counters.get("epoch_close_count", 0) >= 1
        assert rec.epoch_close_percentiles() is not None
        kinds = {e["kind"] for e in rec.tail()}
        assert {"epoch_close", "device_dispatch"} <= kinds
        return sorted(out)

    want, got = both(case)
    assert got == want and got
    assert "bytewax_xla_compile_count" in JAX.exposition()
    assert "bytewax_xla_compile" not in TORCH.exposition()
    assert all(f in TORCH.metrics.generate_python_metrics() for f in FAMILIES)


def test_status_endpoint(entry_point_name, monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label] + 2
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        captured = {}

        def poll():
            if "status" not in captured:
                captured["status"] = _fetch(port, "/status")

        flow = m.Dataflow("status_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        m.op.output("out", s, _probe_sink(m, poll))
        m.entry(entry_point_name)(flow)
        status = captured["status"]
        assert status["flow_id"] == "status_df"
        assert status["proc_id"] == 0
        assert isinstance(status["epoch"], int)
        assert "status_df.out" in status["queue_depths"]
        assert status["recorder"]["enabled"] is True
        assert isinstance(status["recorder"]["counters"], dict)
        assert isinstance(status["cluster"], dict)
        hint = status["rescale_hint"]
        assert hint["advice"] in ("grow", "shrink", "hold")
        assert isinstance(hint["reasons"], list)
        assert hint["signals"]["worker_count"] == status["worker_count"]
        ledger = status["ledger"]
        assert set(ledger) >= {"last", "recent", "phase_totals", "phase_fractions", "lag",
                               "collective_lane"}
        assert ledger["collective_lane"] is None
        wire = status["wire"]
        assert set(wire) >= {"mode", "pending_frames", "pending", "session"}
        assert wire["pending"] is None and wire["session"] is None
        return sorted(status), sorted(status["queue_depths"]), sorted(ledger), shape(wire)

    want, got = both(case)
    assert got == want


def test_collective_lane_status_unit_pin():
    def case(m):
        st = m.sharded_state.GlobalAggState.__new__(m.sharded_state.GlobalAggState)
        st._lane = None
        seen = [st.lane_status()]
        gate = threading.Event()
        lane = m.pipeline.DevicePipeline("gsync", depth=3, phase="collective_lane")
        st._lane = lane
        try:
            seen.append(st.lane_status())
            lane.push(lambda: gate.wait(10), lambda _res: None)
            seen.append(st.lane_status()["in_flight"])
            gate.set()
            lane.flush()
            seen.append(st.lane_status())
        finally:
            gate.set()
            lane.flush()
            lane.shutdown()
        return seen

    want, got = both(case)
    assert got == want == [None, {"in_flight": 0, "depth": 2}, 1, {"in_flight": 0, "depth": 2}]


def test_route_accumulator_pending_status_covers_both_kinds():
    def case(m):
        acc = m.wire.RouteAccumulator()
        seen = [acc.pending_status()]
        acc.add(1, "df.split", 0, [("k", 1)])
        acc.add(1, "df.split", 0, [("k", 2)])
        acc.add(2, "df.split", 0, [("k", 3)])
        acc.add_deliver(1, 4, "up", 0, [("k", 4)])
        st = acc.pending_status()
        assert st["route"]["frames"] + st["deliver"]["frames"] == acc.pending_frames()
        seen.append(st)
        while acc.peek() is not None:
            acc.pop()
        seen.append(acc.pending_status())
        return seen

    want, got = both(case)
    assert got == want
    empty = {"route": {"buckets": 0, "frames": 0}, "deliver": {"buckets": 0, "frames": 0}}
    assert got[0] == got[2] == empty
    assert got[1]["route"]["buckets"] == 2 and got[1]["deliver"]["buckets"] == 1


def test_wire_session_status_view():
    want, got = both(lambda m: m.wire.WireSession().status())
    assert set(got) == {"generation", "tx_streams", "rx_streams"}
    assert all(isinstance(v, int) for v in got.values())
    assert got["tx_streams"] == want["tx_streams"] == 0
    assert got["rx_streams"] == want["rx_streams"] == 0


def test_json_safe_round_trip():
    doc = {
        "i": np.int64(7),
        "f": np.float32(1.5),
        "ts": np.datetime64("2024-01-02T03:04:05", "us"),
        "arr": np.arange(3, dtype=np.int32),
        "nested": {np.int64(1): [np.float64(2.5), (np.int16(3),)]},
        "nan": float("nan"),
        "inf": np.float64("inf"),
        "b": b"bytes",
    }
    want, got = both(lambda m: json.loads(json.dumps(m.flight._json_safe(doc))))
    assert got == want
    assert got["i"] == 7 and got["f"] == 1.5
    assert got["ts"].startswith("2024-01-02T03:04:05")
    assert got["arr"] == [0, 1, 2]
    assert got["nested"]["1"] == [2.5, [3]]
    assert got["nan"] is None and got["inf"] is None
    assert got["b"] == "bytes"


def test_setup_tracing_local():
    for m in BOTH:
        guard = m.tracing.setup_tracing(None, "DEBUG")
        with m.tracing.span("test_span", step_id="x"):
            pass
        guard.shutdown()
        m.tracing.setup_tracing(None, "ERROR")


def test_map_dict_value():
    def case(m):
        out = []
        flow = m.Dataflow("helpers_df")
        s = m.op.input("inp", flow, m.TestingSource([{"name": "ada", "id": 1}]))
        s = m.op.map("norm", s, m.helpers.map_dict_value("name", str.upper))
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow)
        return out

    want, got = both(case)
    assert got == want == [{"name": "ADA", "id": 1}]


def test_duration_histograms_observed(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    align = datetime(2022, 1, 1, tzinfo=timezone.utc)
    inp = [align + timedelta(seconds=i) for i in range(50)]
    win_step = "hist_df.count.fold_window.window.stateful_batch"
    sites = [
        ("inp_part_next_batch", "hist_df.inp"),
        ("flat_map_batch", "hist_df.fmt.flat_map_batch"),
        ("stateful_batch_on_batch", win_step),
        ("stateful_batch_on_eof", win_step),
        ("snapshot", win_step),
        ("out_part_write_batch", "hist_df.out"),
    ]

    def case(m):
        def count_of(name, step):
            return m.sample(f"bytewax_{name}_duration_seconds_count",
                            {"step_id": step, "worker_index": "0"}) or 0

        before = [count_of(*s) for s in sites]
        clock = m.win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=timedelta(0))
        windower = m.win.TumblingWindower(length=timedelta(seconds=10), align_to=align)
        out = []
        flow = m.Dataflow("hist_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=10))
        s = m.op.map("fmt", s, lambda x: x)
        wo = m.win.count_window("count", s, clock, windower, key=lambda _x: "k")
        m.op.output("out", wo.down, m.TestingSink(out))
        m.run_main(flow, epoch_interval=timedelta(0))
        assert out
        counts = [count_of(*s) - b for s, b in zip(sites, before)]
        assert counts[0] >= 5 and counts[1] >= 5
        assert all(c >= 1 for c in counts[2:])
        return sorted(out), list(m.metrics.DURATION_BUCKETS)

    want, got = both(case)
    assert got == want
    assert got[1][0] == 0.0005 and got[1][-1] == 10.0


def test_per_operator_spans_at_debug(caplog):
    def case(m):
        guard = m.tracing.setup_tracing(None, "DEBUG")
        try:
            caplog.clear()
            with caplog.at_level(logging.DEBUG, logger=m.name):
                out = []
                flow = m.Dataflow("span_df")
                s = m.op.input("inp", flow, m.TestingSource([1, 2]))
                s = m.op.map("double", s, lambda x: x * 2)
                m.op.output("out", s, m.TestingSink(out))
                m.run_main(flow)
            spans = [r.getMessage() for r in caplog.records
                     if "span operator" in r.getMessage() and r.name.startswith(m.name)]
            assert spans, f"no operator spans emitted at DEBUG by {m}"
            joined = " ".join(spans)
            assert "span_df.double.flat_map_batch" in joined
            assert "span_df.out" in joined
            return out
        finally:
            guard.shutdown()
            m.tracing.setup_tracing(None, "ERROR")

    want, got = both(case)
    assert got == want


@pytest.mark.parametrize("render", ["to_json", "to_mermaid", "to_plan", "to_plantuml"])
def test_visualize_renders_like_the_reference(render, monkeypatch):
    """``visualize.py`` (``/dataflow`` serves its JSON): each renderer
    gives the JAX package's text for the same flow, a windowed and
    lowered one included."""
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(m):
        flow = m.Dataflow("viz_df")
        s = m.op.input("inp", flow, m.TestingSource([("k", 1.0)]))
        st = m.xla.stats_final("stats", s)
        b = m.op.branch("split", st, lambda kv: kv[1][3] > 1)
        m.op.output("out", m.op.merge("merge", b.trues, b.falses), m.TestingSink([]))
        return getattr(m.visualize, render)(flow)

    want, got = both(case)
    assert got == want and got
