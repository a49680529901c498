"""Streaming inference (``op.infer``) of the JAX package and of the
torch port, on the same seeded inputs.

The port's ``anomaly_infer_flow`` (a host ``stateful_map`` extracting
Welford features, then a torch forward pass on the device tier) must
give the JAX package's ``anomaly_infer_flow`` output and its own
``anomaly_flow``'s: values equal, z within 1e-4 of max(1, |z|), flags
equal.  Also here: ``op.infer`` with one and with several output
columns against the JAX package, ``update_params`` swapping at an agreed
epoch close, the ``host_apply`` path (forced by the knob, and after a
demotion from repeated device faults), resume of the params snapshot
in the port, and a params snapshot written by one package resumed by
the other, both ways.  The port runs on the CPU.
"""

import json
import os
import time
import urllib.error
import urllib.request
from datetime import timedelta

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu_torch.operators as port_op
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import driver as ref_driver
from bytewax_tpu.engine import faults as ref_faults
from bytewax_tpu.engine import infer as ref_infer
from bytewax_tpu.models import anomaly as ref_anomaly
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.engine import driver as port_driver
from bytewax_tpu_torch.engine import faults as port_faults
from bytewax_tpu_torch.engine import flight as port_flight
from bytewax_tpu_torch.engine import infer as port_infer
from bytewax_tpu_torch.models import anomaly as port_anomaly
from bytewax_tpu_torch.recovery import RecoveryConfig as PortRecoveryConfig
from bytewax_tpu_torch.recovery import init_db_dir as port_init_db_dir
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform
from tests.test_torch_both import BOTH, both, neutral
from tests.torch_entry_points import ENTRY_POINTS

ZERO_TD = timedelta(seconds=0)

REF = {
    "op": ref_op,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "anomaly": ref_anomaly,
    "driver": ref_driver,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
}
PORT = {
    "op": port_op,
    "Dataflow": PortDataflow,
    "Source": PortSource,
    "Sink": PortSink,
    "run_main": port_run_main,
    "anomaly": port_anomaly,
    "driver": port_driver,
    "RecoveryConfig": PortRecoveryConfig,
    "init_db_dir": port_init_db_dir,
}
PKGS = {"jax": REF, "torch": PORT}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.fixture(autouse=True)
def _fresh_engine_state(monkeypatch):
    """No pending params update or spent fault counter leaks between
    tests, in either package."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    for mod in (ref_faults, port_faults):
        mod.reset()
    for mod in (ref_driver, port_driver):
        mod.reset_params_update()
    yield
    for mod in (ref_faults, port_faults):
        mod.reset()
    for mod in (ref_driver, port_driver):
        mod.reset_params_update()


def _grid_items(n=180, keys="abc", seed=7):
    """Readings on a grid of halves (exact in float32), one outlier."""
    rng = np.random.RandomState(seed)
    items = [(keys[i % len(keys)], float(np.round(rng.randn() * 4.0) / 2.0)) for i in range(n)]
    items[100] = ("a", 40.0)
    return items


def _per_key(rows):
    by = {}
    for k, row in rows:
        by.setdefault(k, []).append(row)
    return by


def _assert_scored(got, want):
    g, w = _per_key(got), _per_key(want)
    assert g.keys() == w.keys()
    for k in w:
        assert len(g[k]) == len(w[k])
        for (gv, gz, ga), (wv, wz, wa) in zip(g[k], w[k]):
            assert gv == wv
            assert abs(gz - wz) <= 1e-4 * max(1.0, abs(wz)), (k, gz, wz)
            assert ga == wa, (k, wv, wz)


@pytest.mark.parametrize("against", ["jax_infer_flow", "torch_anomaly_flow"])
def test_anomaly_infer_flow_matches(against):
    items = _grid_items()
    got = []
    port_run_main(
        port_anomaly.anomaly_infer_flow(PortSource(list(items), batch_size=16), PortSink(got), threshold=2.5),
        epoch_interval=ZERO_TD,
    )
    want = []
    if against == "jax_infer_flow":
        ref_run_main(
            ref_anomaly.anomaly_infer_flow(RefSource(list(items), batch_size=16), RefSink(want), threshold=2.5),
            epoch_interval=ZERO_TD,
        )
    else:
        port_run_main(
            port_anomaly.anomaly_flow(PortSource(list(items), batch_size=16), PortSink(want), threshold=2.5)
        )
    _assert_scored(got, want)
    assert sum(a for _k, (_v, _z, a) in want) > 0


def _linear(params, x):
    # Runs unchanged on jax arrays, torch tensors and numpy arrays.
    return x[:, 0] * params["w"] + params["b"]


def _two_columns(params, x):
    base = x[:, 0] * params["w"][0] + x[:, 1] * params["w"][1]
    return base, base * 2.0


APPLIES = {
    "one_column": (_linear, {"w": np.float32(3.0), "b": np.float32(1.0)}, lambda i: float(i)),
    "two_columns": (
        _two_columns,
        {"w": [np.float32(2.0), np.float32(-1.5)]},
        lambda i: (float(i), float(i % 5)),
    ),
}


@pytest.mark.parametrize("apply", sorted(APPLIES))
def test_infer_matches_reference(apply):
    fn, params, feats = APPLIES[apply]
    inp = [(f"k{i % 3}", feats(i)) for i in range(40)]
    outs = {}
    for name, pkg in PKGS.items():
        outs[name] = []
        flow = pkg["Dataflow"]("infer_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=8))
        s = pkg["op"].infer("score", s, fn, params)
        pkg["op"].output("out", s, pkg["Sink"](outs[name]))
        pkg["run_main"](flow, epoch_interval=ZERO_TD)
    # Every product and sum here is exact in float32.
    assert outs["torch"] == outs["jax"]


def test_params_digest_matches_reference():
    params = {"w": [np.float32(2.0), np.arange(4, dtype=np.float32)], "b": np.float64(0.5)}
    assert port_infer.params_digest(port_infer.normalize_params(params)) == ref_infer.params_digest(
        ref_infer.normalize_params(params)
    )


def test_update_params_swaps_at_epoch_close(monkeypatch):
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    inp = [
        ("a", 1.0),
        ("a", 2.0),
        PortSource.PAUSE(timedelta(milliseconds=50)),
        ("a", 3.0),
        ("a", 4.0),
    ]
    out = []
    flow = PortDataflow("infer_swap_df")
    s = port_op.input("inp", flow, PortSource(inp, batch_size=2))
    s = port_op.infer("score", s, lambda p, x: x[:, 0] * p["w"], {"w": np.float32(10.0)})
    port_op.output("out", s, PortSink(out))
    swaps_before = port_flight.RECORDER.counters.get("params_swap_count", 0)
    digest = port_driver.update_params({"w": np.float32(100.0)})
    assert isinstance(digest, str) and len(digest) == 16
    port_run_main(flow, epoch_interval=ZERO_TD)
    # The PAUSE spans an epoch close: the first batch scores with the
    # old params, everything after the agreed close with the new.
    assert out == [("a", 10.0), ("a", 20.0), ("a", 300.0), ("a", 400.0)]
    assert port_flight.RECORDER.counters.get("params_swap_count", 0) == swaps_before + 1


def test_host_apply_knob_never_runs_the_device_apply(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_INFER_DEVICE", "0")

    def poisoned(params, x):  # pragma: no cover - must not run
        raise AssertionError("device apply ran with the knob off")

    def host_apply(params, x):
        return x[:, 0] * params["w"] + params["b"]

    inp = [(f"k{i % 3}", float(i)) for i in range(12)]
    out = []
    flow = PortDataflow("infer_host_df")
    s = port_op.input("inp", flow, PortSource(inp, batch_size=4))
    s = port_op.infer("score", s, poisoned, {"w": np.float32(5.0), "b": np.float32(2.0)}, host_apply=host_apply)
    port_op.output("out", s, PortSink(out))
    port_run_main(flow, epoch_interval=ZERO_TD)
    assert sorted(out) == sorted((k, v * 5.0 + 2.0) for k, v in inp)


def test_demotion_carries_swapped_params_to_host_apply(monkeypatch):
    # Epoch 1 scores on the device and the close swaps the params;
    # from epoch 2 every device dispatch faults, so the step demotes to
    # host_apply, which scores with the swapped generation.
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "device_dispatch:error:2+")
    monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", "2")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")

    def host_apply(params, x):
        return x[:, 0] * params["w"]

    inp = [("a", float(i)) for i in range(1, 13)]
    out = []
    flow = PortDataflow("infer_demote_df")
    s = port_op.input("inp", flow, PortSource(inp, batch_size=4))
    s = port_op.infer("score", s, lambda p, x: x[:, 0] * p["w"], {"w": np.float32(10.0)}, host_apply=host_apply)
    port_op.output("out", s, PortSink(out))
    port_driver.update_params({"w": np.float32(20.0)})
    port_run_main(flow, epoch_interval=ZERO_TD)
    events = [e for e in port_flight.RECORDER.tail() if e["kind"] == "demotion"]
    assert events and events[-1]["step"].startswith("infer_demote_df.score")
    assert out == [("a", float(i) * 10.0) for i in range(1, 5)] + [
        ("a", float(i) * 20.0) for i in range(5, 13)
    ]


def _count_feats(state, value):
    n = (state or 0) + 1
    return n, (float(value), float(n))


def _count_apply(params, x):
    return x[:, 0] * params["w"] + x[:, 1]


def _count_flow(pkg, out):
    inp = [("a", 1.0), ("a", 2.0), pkg["Source"].EOF(), ("a", 3.0)]
    flow = pkg["Dataflow"]("infer_resume_df")
    s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=1))
    s = pkg["op"].stateful_map("count", s, _count_feats)
    s = pkg["op"].infer("score", s, _count_apply, {"w": np.float32(10.0)})
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


@pytest.mark.parametrize(
    "first,second", [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]
)
def test_params_snapshot_resumes(tmp_path, first, second):
    """Run 1 swaps w 10 -> 20 at its first close and stops at EOF; run
    2 (the same package, or the other one) resumes and scores with the
    swapped generation and the upstream per-key count."""
    PKGS[first]["init_db_dir"](tmp_path, 1)
    PKGS[first]["driver"].update_params({"w": np.float32(20.0)})
    out = []
    PKGS[first]["run_main"](
        _count_flow(PKGS[first], out),
        epoch_interval=ZERO_TD,
        recovery_config=PKGS[first]["RecoveryConfig"](str(tmp_path)),
    )
    assert out == [("a", 1.0 * 10.0 + 1.0), ("a", 2.0 * 20.0 + 2.0)]
    out2 = []
    PKGS[second]["run_main"](
        _count_flow(PKGS[second], out2),
        epoch_interval=ZERO_TD,
        recovery_config=PKGS[second]["RecoveryConfig"](str(tmp_path)),
    )
    assert out2 == [("a", 3.0 * 20.0 + 3.0)]


# -- hot swap: targeting, rejection, exactly once, the control plane ---------
#
# Each case is written once over a package (``tests/test_torch_both.py``'s
# ``Pkg``: ``m.op``, ``m.driver``, ``m.flight``, ...) and run through the
# JAX package and the port on the same input, against the expectations of
# the same case in ``tests/test_infer.py``.


def _mul_w(p, x):
    return x[:, 0] * p["w"]


def _swap_target_case(m):
    inp = [("a", 1.0), m.TestingSource.PAUSE(timedelta(milliseconds=50)), ("a", 2.0)]
    out = []
    flow = m.Dataflow("infer_target_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=1))
    s = m.op.infer("score", s, _mul_w, {"w": np.float32(10.0)})
    s = m.op.infer("score2", s, _mul_w, {"w": np.float32(2.0)})
    m.op.output("out", s, m.TestingSink(out))
    m.driver.update_params({"w": np.float32(100.0)}, step_id="infer_target_df.score")
    m.run_main(flow, epoch_interval=ZERO_TD)
    return out


def test_infer_swap_targets_step_by_id(monkeypatch):
    """``update_params(step_id=...)`` swaps exactly that step: item 1
    scores 1*10*2, item 2 with only "score" swapped, 2*100*2."""
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    want, got = both(_swap_target_case)
    assert want == [("a", 20.0), ("a", 400.0)]
    assert got == want


def _swap_rejected_case(m):
    inp = [("a", 1.0), m.TestingSource.PAUSE(timedelta(milliseconds=50)), ("a", 2.0)]
    out = []
    flow = m.Dataflow("infer_reject_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=1))
    s = m.op.infer("score", s, _mul_w, {"w": np.float32(10.0)})
    m.op.output("out", s, m.TestingSink(out))
    digest = m.driver.update_params({"not_w": np.float32(999.0)})
    t0 = time.time() - 1e-3
    m.run_main(flow, epoch_interval=ZERO_TD)
    rejected = [
        e
        for e in m.flight.RECORDER.tail(1 << 16)
        if e["kind"] == "params_swap_rejected" and e["t"] >= t0
    ]
    return out, [(e["digest"], e["step"]) for e in rejected], digest


def test_infer_swap_structure_mismatch_rejected(monkeypatch):
    """A pending tree of another structure is rejected at the close:
    scores stay, and one ``params_swap_rejected`` event lands in each
    package's flight ring."""
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    (want, want_events, digest), (got, got_events, port_digest) = both(_swap_rejected_case)
    assert want == [("a", 10.0), ("a", 20.0)]
    assert got == want
    assert port_digest == digest
    assert want_events == [(digest, "")]
    assert got_events == want_events


def _swap_restart_case(m, entry_point, tmp_path):
    inp = [
        ("a", 1.0),
        ("a", 2.0),
        m.TestingSource.PAUSE(timedelta(milliseconds=100)),
        ("a", 3.0),
    ]
    root = tmp_path / m.label
    root.mkdir()
    out_path = root / "out.txt"
    flow = m.Dataflow("infer_chaos_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=1))
    s = m.op.infer("score", s, _mul_w, {"w": np.float32(10.0)})
    s = m.op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    m.op.output("out", s, m.files.FileSink(str(out_path)))
    restarts = m.counter("worker_restart_count")
    swaps = m.counter("params_swap_count")
    m.driver.update_params({"w": np.float32(20.0)})
    m.entry(entry_point)(flow, epoch_interval=ZERO_TD, recovery_config=m.rc(root / "db"))
    lines = out_path.read_text().split()
    gens = [float(line.split("=")[1]) / (i + 1.0) for i, line in enumerate(lines)]
    return m.counter("worker_restart_count") - restarts, m.counter("params_swap_count") - swaps, gens


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_infer_swap_exactly_once_across_supervised_restart(entry_point, tmp_path, monkeypatch):
    """A crash at the ``params_swap`` site (before any install and
    before the target is consumed) restarts the worker once under
    supervision, and the swap lands exactly once: every item scores
    once, item 1 before the swap, and no item with the old params after
    one scored with the new."""
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "params_swap:crash:1:x1")
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    for restarts, swaps, gens in both(_swap_restart_case, entry_point, tmp_path):
        assert restarts == 1
        assert swaps == 1
        assert len(gens) == 3
        assert gens[0] == 10.0
        assert all(w in (10.0, 20.0) for w in gens)
        assert gens == sorted(gens)


def _tiny_flow(m):
    flow = m.Dataflow("model_api_df")
    s = m.op.input("inp", flow, m.TestingSource([("a", 1.0)]))
    s = m.op.infer("score", s, _mul_w, {"w": np.float32(1.0)})
    m.op.output("out", s, m.TestingSink([]))
    return flow


def _http(req):
    """``(status, JSON body or None)`` of one request."""
    try:
        with urllib.request.urlopen(req, timeout=5) as rsp:
            return rsp.status, json.loads(rsp.read())
    except urllib.error.HTTPError as ex:
        return ex.code, None


def _post_model(port, body):
    return _http(urllib.request.Request(f"http://127.0.0.1:{port}/model", data=body, method="POST"))


def _model_endpoint_case(m):
    driver = m.driver
    srv = m.webserver.maybe_start_server(
        _tiny_flow(m),
        model_fn=lambda params, step_id=None: driver.update_params(params, step_id, source="http"),
    )
    assert srv is not None
    try:
        body = json.dumps({"params": {"w": 42.0}, "step_id": "model_api_df.score"}).encode()
        accepted = _post_model(srv.port, body)
        pending = driver._pending_params()
        empty = _post_model(srv.port, b"{}")
    finally:
        srv.shutdown()
    srv = m.webserver.maybe_start_server(_tiny_flow(m))
    assert srv is not None
    try:
        unarmed = _post_model(srv.port, b'{"params": {"w": 1.0}}')
    finally:
        srv.shutdown()
    return accepted, pending[:2], empty[0], unarmed[0]


def test_webserver_model_endpoint(tmp_path, monkeypatch):
    """``POST /model`` records the pending update through ``model_fn``
    and answers its 16-character digest; a body without params is a
    400; without ``model_fn`` the path is a 404."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")
    want, got = both(_model_endpoint_case)
    for (code, payload), pending, empty, unarmed in (want, got):
        assert code == 200
        assert payload["accepted"] is True
        assert isinstance(payload["digest"], str) and len(payload["digest"]) == 16
        assert pending == ("model_api_df.score", payload["digest"])
        assert empty == 400
        assert unarmed == 404
    assert got == want


def _model_remote_case(m):
    got = []
    srv = m.webserver.maybe_start_server(_tiny_flow(m), model_fn=lambda p, s=None: got.append(p) or "x")
    assert srv is not None
    try:
        code, _ = _post_model(srv.port, b'{"params": {"w": 1.0}}')
    finally:
        srv.shutdown()
    return code, got


def test_webserver_model_requires_loopback_opt_in(tmp_path, monkeypatch):
    """On a non-loopback bind ``POST /model`` is off (a 404) unless
    remote control is allowed, and records nothing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_HOST", "0.0.0.0")
    want, got = both(_model_remote_case)
    assert want == (404, [])
    assert got == want


def _status_graph_case(m, entry_point, monkeypatch):
    """The infer step's ``/status`` and ``/graph`` views, read by a
    probe sink downstream of it on the API server the run started on
    an ephemeral port, and the metric families."""
    servers = []
    start = m.webserver.maybe_start_server

    def recording(*args, **kwargs):
        servers.append(start(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(m.webserver, "maybe_start_server", recording)
    captured = {}

    class _ProbePartition(m.outputs.StatelessSinkPartition):
        def write_batch(self, items):
            if "status" not in captured:
                base = f"http://127.0.0.1:{servers[-1].port}"
                captured["status"] = _http(base + "/status")
                captured["graph"] = _http(base + "/graph")

    class _ProbeSink(m.outputs.DynamicSink):
        def build(self, step_id, worker_index, worker_count):
            return _ProbePartition()

    flow = m.Dataflow("infer_obs_df")
    s = m.op.input("inp", flow, m.TestingSource([("a", 1.0), ("b", 2.0)], batch_size=2))
    s = m.op.infer("score", s, _mul_w, {"w": np.float32(3.0)})
    m.op.output("out", s, _ProbeSink())
    m.entry(entry_point)(flow, epoch_interval=ZERO_TD)
    monkeypatch.setattr(m.webserver, "maybe_start_server", start)
    families = m.metrics.generate_python_metrics()
    return captured, [f for f in ("bytewax_infer_rows_count", "bytewax_infer_params_generation") if f in families]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_status_and_graph_carry_infer(entry_point, monkeypatch, tmp_path):
    """``/status`` carries the infer step's view (device tier,
    generation 0, a 16-character digest, no swap yet), ``/graph`` its
    tier, and the registry the infer families."""
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")
    monkeypatch.chdir(tmp_path)
    views = []
    for m in BOTH:
        captured, families = _status_graph_case(m, entry_point, monkeypatch)
        assert captured["status"][0] == 200 and captured["graph"][0] == 200
        infer = captured["status"][1]["infer"]
        assert len(infer) == 1
        (step_id,), (view,) = zip(*infer.items())
        assert step_id.startswith("infer_obs_df.score")
        assert view["tier"] == "device"
        assert view["generation"] == 0
        assert isinstance(view["digest"], str) and len(view["digest"]) == 16
        assert view["last_swap"] is None
        by_id = {n["step_id"]: n for n in captured["graph"][1]["steps"]}
        assert by_id[step_id]["tier"] == "device"
        assert families == ["bytewax_infer_rows_count", "bytewax_infer_params_generation"]
        views.append((neutral(step_id), view))
    assert views[1] == views[0]
