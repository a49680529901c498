"""The flow map (``engine/flowmap.py``): live per-step and per-edge
telemetry, the annotated ``GET /graph`` topology, the bottleneck
attribution and its feed into the rescale hint, of the torch port held
against the JAX package (the single-process cases of
``tests/test_flowmap.py``; the two-process ``/graph`` merge is in
``tests/test_torch_flowmap_cluster.py``).

The port's one change to the module is the device footprint: a
sharded tier keeps one dict of field tensors a shard, and each block's
``.nbytes`` is summed, read off the tensors' metadata without a copy.
Its cases hold the footprint of the port's real device states to the
sum of their tensors' ``nbytes``.  Each package's API server gets a
port of its own.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    shape,
    unsharded,
)

API_PORT = {"jax": 13154, "torch": 13254}


def _reset_flowmap(m):
    fm = m.flowmap.FLOWMAP
    fm._rows.clear()
    fm._batches.clear()
    fm._edges.clear()
    fm._wire.clear()
    fm._device.clear()
    fm._lag.clear()
    fm.last = None
    fm._sealed.clear()
    fm._epoch_t0 = time.monotonic()


# -- derive_bottleneck: pure attribution -------------------------------

BOTTLENECK_CASES = {
    "queue_pressure_names_slowest_upstream": (
        {
            "df.inp": {"busy_s": 0.2},
            "df.work": {"busy_s": 3.0},
            "df.out": {"busy_s": 0.1, "queue_depth": 5},
        },
        [("df.inp", "df.work"), ("df.work", "df.out")],
    ),
    "lag_pressure_wins_over_smaller_queue": (
        {"df.a": {"busy_s": 1.0, "queue_depth": 2}, "df.b": {"busy_s": 0.5, "lag_s": 30.0}},
        [],
    ),
    "pressure_with_no_busy_upstream_names_site": (
        {"df.x": {"queue_depth": 4}, "df.up": {}},
        [("df.up", "df.x")],
    ),
    "dominant_share_without_pressure": (
        {"df.inp": {"busy_s": 0.1}, "df.slow": {"busy_s": 2.0}, "df.out": {"busy_s": 0.1}},
        None,
    ),
    "none_empty": ({}, None),
    "none_balanced": ({"df.a": {"busy_s": 1.0}, "df.b": {"busy_s": 1.0}}, None),
    "none_idle": ({"df.a": {}, "df.b": {}}, None),
}

BOTTLENECK_WANT = {
    "queue_pressure_names_slowest_upstream": (
        "df.work", ("queue depth 5 at df.out", "slowest upstream df.work")),
    "lag_pressure_wins_over_smaller_queue": ("df.b", ("lag 30.0s at df.b",)),
    "pressure_with_no_busy_upstream_names_site": ("df.x", ()),
    "dominant_share_without_pressure": ("df.slow", ("of attributed busy time",)),
    "none_empty": None,
    "none_balanced": None,
    "none_idle": None,
}


@pytest.mark.parametrize("name", sorted(BOTTLENECK_CASES))
def test_bottleneck_attribution(name):
    steps, edges = BOTTLENECK_CASES[name]

    def case(m):
        if edges is None:
            return m.flowmap.derive_bottleneck(steps)
        return m.flowmap.derive_bottleneck(steps, edges)

    want, got = both(case)
    assert got == want
    pinned = BOTTLENECK_WANT[name]
    if pinned is None:
        assert got is None
    else:
        assert got[0] == pinned[0]
        for part in pinned[1]:
            assert part in got[1]


def test_bottleneck_deterministic_tie_break():
    steps = {
        "df.b": {"queue_depth": 3, "busy_s": 1.0},
        "df.a": {"queue_depth": 3, "busy_s": 1.0},
    }

    def case(m):
        a = m.flowmap.derive_bottleneck(steps)
        b = m.flowmap.derive_bottleneck(dict(reversed(list(steps.items()))))
        assert a == b
        return a

    want, got = both(case)
    assert got == want


# -- the FlowMap accumulator -------------------------------------------


def test_flowmap_seal_record_shape_and_reset():
    def case(m):
        fm = m.flowmap.FlowMap()
        fm.add_rows("df.inp", "out", 100)
        fm.add_rows("df.work", "in", 100)
        fm.add_rows("df.work", "in", 60)
        fm.add_rows("df.work", "out", 160)
        fm.add_edge("df.inp.down", 100)
        fm.add_wire(1, "df.work.up", 50, 4096)
        fm.set_device("df.win", 7, 1 << 20)
        fm.set_lag("df.win", 2.5)
        rec = fm.seal(3, queue_depth={"df.win": 2})
        assert rec["epoch"] == 3 and rec["wall_s"] > 0
        assert rec["steps"]["df.work"]["rate_in_per_s"] > 0
        assert fm.summary() is rec
        assert fm.recent() == [rec]
        empty = fm.seal(4)
        assert empty["steps"] == {} and empty["edges"] == {}

        def exact(step):
            return {k: v for k, v in step.items() if "per_s" not in k}

        return ({s: exact(v) for s, v in rec["steps"].items()},
                {e: exact(v) for e, v in rec["edges"].items()}, rec["wire"], shape(rec))

    want, got = both(case)
    assert got == want
    steps, edges, wire, _shape = got
    work = steps["df.work"]
    assert work["rows_in"] == 160 and work["batches_in"] == 2
    assert work["batch_rows_in"] == 80.0
    assert work["rows_out"] == 160
    win = steps["df.win"]
    assert win["device_keys"] == 7 and win["device_bytes"] == 1 << 20
    assert win["watermark_lag_s"] == 2.5
    assert win["queue_depth_at_drain"] == 2
    assert edges["df.inp.down"]["rows"] == 100
    assert wire["1"]["df.work.up"] == {"frames": 1, "rows": 50, "bytes": 4096}


def test_flowmap_prometheus_mirror():
    def case(m):
        fm = m.flowmap.FlowMap()
        fm.add_rows("pm_df.step", "in", 40)
        fm.set_lag("pm_df.step", 1.25)
        fm.set_device("pm_df.step", 3, 2048)
        fm.seal(1)
        rows = m.sample("bytewax_step_rows_count_total",
                        {"step_id": "pm_df.step", "direction": "in"})
        assert rows >= 40
        return (m.sample("bytewax_step_watermark_lag_seconds", {"step_id": "pm_df.step"}),
                m.sample("bytewax_step_device_bytes", {"step_id": "pm_df.step"}))

    want, got = both(case)
    assert got == want == (1.25, 2048)


def _slots(fields):
    class _Slots:
        key_to_slot = {"a": 0, "b": 1}
        _fields = fields

    return _Slots()


def test_payload_size_and_device_footprint_units():
    def case(m):
        batch = m.ArrayBatch(
            {"key_id": np.zeros(10, dtype=np.int32), "v": np.ones(10, dtype=np.float64)},
            key_vocab=np.array(["k"]),
        )
        inner = _slots({"acc": np.zeros((4, 2), dtype=np.float32)})

        class _Wrap:
            def __init__(self):
                self._inner = inner
                self.key_to_slot = inner.key_to_slot
                self._fields = inner._fields

        return (m.flowmap.payload_size(batch), m.flowmap.payload_size([("k", 1), ("k", 2)]),
                m.flowmap.device_footprint(inner), m.flowmap.device_footprint(_Wrap()))

    want, got = both(case)
    assert got == want == ((10, 120), (2, 0), (2, 32), (2, 32))


def test_device_footprint_sums_tensor_blocks_without_copies():
    """The port's footprint reads ``.nbytes`` of torch tensors, one
    dict a shard on a sharded tier: the same bytes the JAX package
    counts for one dict of arrays of the same sizes, and each shard's
    block once."""
    shards = [
        {"count": torch.zeros(8, dtype=torch.int32), "sum": torch.zeros(8, dtype=torch.float32)}
        for _ in range(3)
    ]
    want = JAX.flowmap.device_footprint(
        _slots({"count": np.zeros(24, dtype=np.int32), "sum": np.zeros(24, dtype=np.float32)})
    )
    got = TORCH.flowmap.device_footprint(_slots(shards))
    assert got == want == (2, 3 * 8 * (4 + 4))
    one = TORCH.flowmap.device_footprint(_slots(shards[0]))
    assert one == (2, 64)


def _port_state_bytes(state):
    fields = state._fields
    blocks = fields if isinstance(fields, list) else [fields]
    return sum(t.nbytes for b in blocks for t in b.values())


@pytest.mark.parametrize("kind", ["count", "stats"])
def test_device_footprint_of_real_device_states(kind):
    """The footprint of a state the port's device tier builds is the
    sum of its field tensors' ``nbytes``, and its key count the JAX
    package's for the same fold."""
    keys = np.array([f"k{i % 37}" for i in range(500)])
    vals = np.arange(500, dtype=np.float64)
    got = []
    for m in BOTH:
        state = m.engine_xla.DeviceAggState(kind)
        state.update(keys, vals)
        got.append(m.flowmap.device_footprint(state))
        if m.is_port:
            assert got[-1][1] == _port_state_bytes(state) > 0
    assert got[1][0] == got[0][0] == 37


# -- topology over the lowered plan ------------------------------------


def test_topology_steps_edges_and_tiers(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(m):
        flow = m.Dataflow("topo_df")
        s = m.op.input("inp", flow, m.TestingSource([("k", 1.0)]))
        st = m.xla.stats_final("sum", s)
        fmt = m.op.map_value("fmt", st, str)
        m.op.output("out", fmt, m.TestingSink([]))
        return m.flowmap.topology(m.flatten.flatten(flow))

    want, got = both(case)
    assert got == want
    by_id = {n["step_id"]: n for n in got["steps"]}
    assert any("inp" in sid for sid in by_id)
    assert any(n["tier"] == "device" for n in got["steps"])
    for e in got["edges"]:
        assert e["dst"] in by_id
        assert e["src"] is None or e["src"] in by_id
        assert isinstance(e["port"], str)
    assert any("out" in e["dst"] for e in got["edges"])


# -- GET /graph (in-process) -------------------------------------------


def _probe_sink(m, poll):
    class _ProbePartition(m.outputs.StatelessSinkPartition):
        def __init__(self):
            self._seen = 0

        def write_batch(self, items):
            self._seen += 1
            poll(self._seen)

    class _ProbeSink(m.outputs.DynamicSink):
        def build(self, step_id, worker_index, worker_count):
            return _ProbePartition()

    return _ProbeSink()


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return json.loads(resp.read())


def test_graph_endpoint(entry_point_name, monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label]
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        _reset_flowmap(m)
        captured = {}

        def poll(seen):
            if seen >= 3 and "graph" not in captured:
                captured["graph"] = _fetch(port, "/graph")

        flow = m.Dataflow("graph_df")
        s = m.op.input("inp", flow, m.TestingSource(list(range(40)), batch_size=4))
        s = m.op.map("double", s, lambda x: x * 2)
        m.op.output("out", s, _probe_sink(m, poll))
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        graph = captured["graph"]
        assert graph["flow_id"] == "graph_df"
        assert graph["proc_id"] == 0 and graph["proc_count"] == 1
        by_id = {n["step_id"]: n for n in graph["steps"]}
        mapper = next(sid for sid in by_id if ".double." in sid)
        assert by_id[mapper]["tier"] == "host"
        tele = by_id[mapper]["telemetry"]
        assert tele["0"]["rows_in"] > 0 and tele["0"]["rows_out"] > 0
        assert tele["0"]["rate_in_per_s"] > 0
        assert any(e["telemetry"].get("0", {}).get("rows", 0) > 0 for e in graph["edges"])
        assert isinstance(graph["wire"], dict)
        assert "bottleneck" in graph
        return (sorted(by_id), [(n["step_id"], n["tier"]) for n in graph["steps"]],
                [(e["src"], e["dst"], e["port"]) for e in graph["edges"]], sorted(graph))

    want, got = both(case)
    assert got == want


def test_throttled_step_named_bottleneck(entry_point_name, monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")

    def case(m):
        port = API_PORT[m.label] + 1
        monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", str(port))
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        _reset_flowmap(m)
        m.flight.RECORDER.last_ledger = None
        captured = {}

        def poll(seen):
            if seen >= 4 and "status" not in captured:
                graph = _fetch(port, "/graph")
                if graph.get("bottleneck") is None:
                    return
                captured["graph"] = graph
                captured["status"] = _fetch(port, "/status")

        flow = m.Dataflow("bn_df")
        s = m.op.input("inp", flow, m.TestingSource(list(range(40)), batch_size=4))
        s = m.op.map("fast", s, lambda x: x)
        s = m.op.map("slow", s, lambda x: (time.sleep(0.004), x)[1])
        m.op.output("out", s, _probe_sink(m, poll))
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        assert "status" in captured, "bottleneck never derived in-run"
        bn = captured["graph"]["bottleneck"]
        assert ".slow." in bn["step"] and ".fast." not in bn["step"]
        assert "busy time" in bn["why"] or "at " in bn["why"]
        hint = captured["status"]["rescale_hint"]
        assert any("bottleneck step" in r and ".slow." in r for r in hint["reasons"])
        assert hint["signals"]["bottleneck"]["step"] == bn["step"]
        return bn["step"], sorted(bn)

    want, got = both(case)
    assert got == want
