"""The cooperative drain-to-stop (``engine/driver.py`` ``request_stop``,
``errors.GracefulStop``) and the API plane's ``/stop``, ``/healthz``,
``/status`` and ``/reconfigure`` of the torch port, held against the
JAX package: every case of ``tests/test_graceful_stop.py``, plus a
store that one package stopped gracefully, resumed by the other with
zero epochs replayed, both ways.

Each package keeps its own stop flag; both are reset around every
test.  The API servers bind the loopback only: the remote-stop case
binds ``127.0.0.2``, a loopback address the guard does not list as
one, so the opt-in is exercised without leaving the host.
"""

import json
import urllib.error
import urllib.request

import pytest

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    status_shape,
    unsharded,
)


@pytest.fixture(autouse=True)
def _fresh_stop():
    for m in BOTH:
        m.driver.reset_stop()
    yield
    for m in BOTH:
        m.driver.reset_stop()


def _sum_flow(m, inp, out, stop_at=None):
    flow = m.Dataflow("graceful_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=4))

    def trig(kv, _stop_at=stop_at):
        if _stop_at is not None and kv[1] == _stop_at:
            m.driver.request_stop()
        return kv

    s = m.op.map("trig", s, trig)
    s = m.op.stateful_map("sum", s, lambda st, v: ((st or 0.0) + v,) * 2)
    m.op.output("out", s, m.TestingSink(out))
    return flow


def _oracle(rows):
    sums, want = {}, []
    for k, v in rows:
        sums[k] = sums.get(k, 0.0) + v
        want.append((k, sums[k]))
    return want


def _resume_epoch(m, rc):
    store = m.store.RecoveryStore(rc.db_dir)
    try:
        return store.resume_from().resume_epoch
    finally:
        store.close()


INP = [(f"k{i % 8}", float(i)) for i in range(600)]


def test_graceful_stop_commits_and_resumes_with_zero_replay(tmp_path, entry_point_name):
    def case(m):
        db = tmp_path / m.label
        db.mkdir()
        m.init_db_dir(db, 2)
        rc = m.RecoveryConfig(str(db))
        run = m.entry(entry_point_name)
        stops = m.counter("graceful_stop_count")
        out = []
        status = run(_sum_flow(m, INP, out, stop_at=300.0), epoch_interval=ZERO_TD,
                     recovery_config=rc)
        assert isinstance(status, m.errors.GracefulStop)
        assert m.counter("graceful_stop_count") == stops + 1
        n = len(out)
        assert 0 < n < len(INP)
        assert sorted(out) == sorted(_oracle(INP)[:n])
        assert _resume_epoch(m, rc) == status.epoch + 1
        out2 = []
        status2 = run(_sum_flow(m, INP, out2), epoch_interval=ZERO_TD, recovery_config=rc)
        assert status2 is None
        assert sorted(out + out2) == sorted(_oracle(INP))
        return status.epoch, sorted(out), sorted(out2)

    want, got = both(case)
    assert got == want


@pytest.mark.parametrize("first,second", [(JAX, TORCH), (TORCH, JAX)], ids=repr)
def test_stopped_store_resumes_in_the_other_package(tmp_path, first, second):
    """A store that one package stopped gracefully resumes in the
    other at the next epoch, zero epochs replayed, every row's running
    sum emitted exactly once."""
    db = tmp_path / "db"
    db.mkdir()
    first.init_db_dir(db, 2)
    out = []
    status = first.run_main(
        _sum_flow(first, INP, out, stop_at=300.0),
        epoch_interval=ZERO_TD,
        recovery_config=first.RecoveryConfig(str(db)),
    )
    assert type(status).__name__ == "GracefulStop"
    for m in BOTH:
        assert _resume_epoch(m, m.RecoveryConfig(str(db))) == status.epoch + 1
    out2 = []
    status2 = second.run_main(
        _sum_flow(second, INP, out2),
        epoch_interval=ZERO_TD,
        recovery_config=second.RecoveryConfig(str(db)),
    )
    assert status2 is None
    assert not set(out) & set(out2)
    assert sorted(out + out2) == sorted(_oracle(INP))


def test_stop_request_before_run_is_honored_then_consumed():
    inp = [(f"k{i % 2}", float(i)) for i in range(64)]

    def case(m):
        m.driver.request_stop()
        out = []
        status = m.driver.run_main(_sum_flow(m, inp, out), epoch_interval=ZERO_TD)
        assert isinstance(status, m.errors.GracefulStop)
        assert len(out) < len(inp)
        out2 = []
        status2 = m.driver.run_main(_sum_flow(m, inp, out2), epoch_interval=ZERO_TD)
        assert status2 is None
        assert sorted(out2) == sorted(_oracle(inp))
        return status.epoch, sorted(out)

    want, got = both(case)
    assert got == want


def test_health_and_status_report_draining():
    def case(m):
        d = m.driver._Driver(_sum_flow(m, [("a", 1.0)], []), worker_count=1,
                             epoch_interval=ZERO_TD, recovery_config=None)
        seen = [d._health()]
        d._ready = True
        seen.append(d._health())
        m.driver.request_stop()
        seen.append(d._health())
        st = d._status()
        assert seen[0]["state"] == "starting"
        assert not seen[0]["ready"] and not seen[0]["draining"]
        assert seen[1]["ready"] and seen[1]["state"] == "ready"
        assert seen[2]["state"] == "draining"
        assert seen[2]["draining"] and not seen[2]["ready"]
        assert st["stopping"] is True
        assert st["rescale_hint"]["history"] == []
        return seen, status_shape(st)

    want, got = both(case)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_rescale_hint_history_recorded_at_epoch_close():
    inp = [(f"k{i % 4}", float(i)) for i in range(64)]

    def case(m):
        d = m.driver._Driver(_sum_flow(m, inp, []), worker_count=1,
                             epoch_interval=ZERO_TD, recovery_config=None)
        assert d.run() is None
        history = d._rescale_hint()["history"]
        assert history
        for sample in history:
            assert sample["advice"] in ("grow", "shrink", "hold")
            assert sample["epoch"] >= 1
        assert len(history) == 1
        return [sorted(h) for h in history]

    want, got = both(case)
    assert got == want


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as rsp:
            return rsp.status, json.loads(rsp.read())
    except urllib.error.HTTPError as ex:
        body = ex.read()
        return ex.code, json.loads(body) if body.startswith(b"{") else None


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    return _get(req)


def test_webserver_stop_endpoint_and_draining(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")

    def case(m):
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        state = {"stop": False}

        def health():
            draining = state["stop"]
            return {"ready": not draining, "draining": draining,
                    "state": "draining" if draining else "ready"}

        srv = m.webserver.maybe_start_server(
            _sum_flow(m, [("a", 1.0)], []),
            status_fn=lambda: {"stopping": state["stop"]},
            health_fn=health,
            stop_fn=lambda: state.__setitem__("stop", True),
        )
        assert srv is not None
        base = f"http://127.0.0.1:{srv.port}"
        try:
            seen = [_get(base + "/healthz"), _post(base + "/stop"),
                    _get(base + "/healthz"), _get(base + "/status"),
                    _post(base + "/nope")]
        finally:
            srv.shutdown()
        assert seen[0][0] == 200 and seen[0][1]["ready"]
        assert seen[1] == (200, {"stopping": True})
        assert seen[2][0] == 503 and seen[2][1]["state"] == "draining"
        assert seen[2][1]["live"]
        assert seen[3] == (200, {"stopping": True})
        assert seen[4][0] == 404
        return seen

    want, got = both(case)
    assert got == want


def test_webserver_reconfigure_endpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")
    addrs = ["127.0.0.1:9001", "127.0.0.1:9002"]

    def case(m):
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        got = []
        srv = m.webserver.maybe_start_server(
            _sum_flow(m, [("a", 1.0)], []),
            reconfigure_fn=lambda a, wpp: got.append((a, wpp)),
        )
        base = f"http://127.0.0.1:{srv.port}"
        try:
            ok = _post(base + "/reconfigure",
                       json.dumps({"addresses": addrs, "workers_per_process": 2}).encode())
            bad = _post(base + "/reconfigure", json.dumps({"addresses": "nope"}).encode())
        finally:
            srv.shutdown()
        srv = m.webserver.maybe_start_server(_sum_flow(m, [("a", 1.0)], []))
        try:
            absent = _post(f"http://127.0.0.1:{srv.port}/reconfigure", b"{}")
        finally:
            srv.shutdown()
        assert ok[0] == 200 and ok[1]["reconfiguring"] is True
        assert bad[0] == 400 and absent[0] == 404
        assert got == [(addrs, 2)]
        return ok, bad[0], absent[0], got

    want, got = both(case)
    assert got == want


def test_health_reports_migrating_during_pending_rescale(tmp_path):
    inp = [(f"k{i % 4}", float(i)) for i in range(16)]

    def case(m):
        rc = m.rc(tmp_path / m.label)
        m.cluster_main(_sum_flow(m, inp, []), [], 0, worker_count_per_proc=2,
                       epoch_interval=ZERO_TD, recovery_config=rc)
        drv = m.driver._Driver(_sum_flow(m, inp, []), worker_count=3,
                               epoch_interval=ZERO_TD, recovery_config=rc,
                               force_rescale=True)
        try:
            health = drv._health()
            assert health["state"] == "migrating"
            assert health["ready"] is False
            return health, drv._migrating
        finally:
            drv.store.close()

    want, got = both(case)
    assert got == want
    assert got[1] is True


def test_webserver_remote_stop_requires_opt_in(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_ENABLED", "1")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_PORT", "0")
    monkeypatch.setenv("BYTEWAX_DATAFLOW_API_HOST", "127.0.0.2")

    def case(m):
        d = tmp_path / m.label
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.delenv("BYTEWAX_TPU_ALLOW_REMOTE_STOP", raising=False)
        state = {"stop": False}
        flow = _sum_flow(m, [("a", 1.0)], [])
        seen = []
        for opt_in in (None, "1"):
            if opt_in:
                monkeypatch.setenv("BYTEWAX_TPU_ALLOW_REMOTE_STOP", opt_in)
            srv = m.webserver.maybe_start_server(
                flow, stop_fn=lambda: state.__setitem__("stop", True)
            )
            try:
                seen.append((_post(f"http://127.0.0.2:{srv.port}/stop")[0], state["stop"]))
            finally:
                srv.shutdown()
        return seen

    want, got = both(case)
    assert got == want == [(404, False), (200, True)]
