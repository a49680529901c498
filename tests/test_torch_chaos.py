"""Fault injection, the restart supervisor and device-tier demotion of
the torch port (``engine/faults.py``, ``supervise.py``'s in-process
supervisor, ``engine/driver.py`` ``_dispatch_device``/``_demote``),
held against the JAX package: the single-process cases of
``tests/test_chaos.py`` (the cluster cases are in
``tests/test_torch_chaos_cluster.py`` and
``tests/test_torch_chaos_overlap.py``).

Faults are injected only through each package's own injector
(``BYTEWAX_TPU_FAULTS``); each case runs the same flow through both
packages, compares the outputs and the flight-recorder counters
(``fault_injected_count``, ``demotion_count``,
``worker_restart_count``), and keeps the reference test's oracle.  The
demotion cases read the port's slot tables back through
``demotion_snapshots()`` into host logics, as on the card.
Tolerances: sums and counts exact (integer-valued floats); the EMA
scan's rows against a host run to 3 decimals, as the reference test
rounds them, and the two packages' demoted scans to 1e-4.
"""

import threading
import time
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


def _supervision_env(monkeypatch, spec, restarts=2, backoff="0.05"):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", spec)
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", str(restarts))
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", backoff)


def _file_flow(m, inp, out_path):
    flow = m.Dataflow("chaos_df")
    s = m.op.input("inp", flow, m.TestingSource(inp))
    s = m.op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
    s = m.op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    m.op.output("out", s, m.files.FileSink(out_path))
    return flow


def _sum_oracle(inp):
    sums, want = {}, []
    for k, v in inp:
        sums[k] = sums.get(k, 0) + v
        want.append(f"{k}={sums[k]}")
    return sorted(want)


INP12 = [(f"k{i % 3}", i) for i in range(12)]


def test_supervised_restart_snapshot_crash_exactly_once(entry_point_name, tmp_path, monkeypatch):
    _supervision_env(monkeypatch, "snapshot.commit:crash:3:x1")

    def case(m):
        out_path = tmp_path / m.label / "out.txt"
        rc = m.rc(tmp_path / m.label / "db")
        restarts = m.counter("worker_restart_count")
        m.entry(entry_point_name)(_file_flow(m, INP12, str(out_path)),
                                  epoch_interval=ZERO_TD, recovery_config=rc)
        lines = sorted(out_path.read_text().split())
        assert lines == _sum_oracle(INP12)
        return lines, m.counter("worker_restart_count") - restarts

    want, got = both(case)
    assert got == want
    assert got[1] == 1


def test_unsupervised_injected_crash_propagates(tmp_path, monkeypatch):
    def case(m):
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "snapshot.write:crash:1:x1")
        monkeypatch.delenv("BYTEWAX_TPU_MAX_RESTARTS", raising=False)
        m.faults.reset()
        rc = m.rc(tmp_path / m.label)
        out = []
        flow = m.Dataflow("chaos_df")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        m.op.output("out", s, m.TestingSink(out))
        with pytest.raises(m.faults.InjectedCrash) as info:
            m.run_main(flow, epoch_interval=ZERO_TD, recovery_config=rc)
        out.clear()
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "")
        m.faults.reset()
        m.run_main(flow, epoch_interval=ZERO_TD, recovery_config=rc)
        return str(info.value), out

    want, got = both(case)
    assert got == want
    assert got[1] == [1, 2, 3]


# -- device-tier demotion ----------------------------------------------


def _demotion_events(m, t0):
    return [e for e in m.flight.RECORDER.tail() if e["kind"] == "demotion" and e["t"] >= t0]


def _demotion_env(monkeypatch, spec, after):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", spec)
    monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", str(after))
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")


def _counted(m, run):
    """``run()``'s result with the fault, demotion and restart counts
    it added, and its demotion events' steps and migrated keys."""
    keys = ("fault_injected_count", "demotion_count", "worker_restart_count")
    before = [m.counter(k) for k in keys]
    t0 = time.time()
    result = run()
    events = _demotion_events(m, t0)
    deltas = [m.counter(k) - b for k, b in zip(keys, before)]
    return result, deltas, [(e["step"], e["keys"]) for e in events]


def test_device_demotion_after_k_faults(monkeypatch):
    _demotion_env(monkeypatch, "device_dispatch:error:2+", 3)
    n = 40
    inp = [(f"k{i % 4}", 1.0) for i in range(n)]

    def case(m):
        out = []
        flow = m.Dataflow("demote_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=4))
        r = m.op.reduce_final("sum", s, m.xla.SUM)
        m.op.output("out", r, m.TestingSink(out))
        result = _counted(m, lambda: m.run_main(flow, epoch_interval=ZERO_TD) or dict(out))
        assert "bytewax_step_demotion_count" in m.exposition()
        return result

    want, got = both(case)
    assert got == want
    out, (faults, demotions, restarts), events = got
    assert out == {f"k{i}": n / 4 for i in range(4)}
    assert faults == 3 and demotions == 1 and restarts == 0
    assert events[-1][0].startswith("demote_df.sum") and events[-1][1] == 4
    assert TORCH.sample("bytewax_step_demotion_count_total",
                        {"step_id": events[-1][0]}) >= 1


def test_device_demotion_windowed_state_continuity(monkeypatch):
    _demotion_env(monkeypatch, "device_dispatch:error:2+", 2)
    align = datetime(2022, 1, 1, tzinfo=timezone.utc)
    n = 240
    inp = [(align + timedelta(seconds=i), f"key{i % 2}") for i in range(n)]

    def case(m):
        out = []
        flow = m.Dataflow("demote_win_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=16))
        clock = m.win.EventClock(ts_getter=lambda item: item[0],
                                 wait_for_system_duration=timedelta(seconds=5))
        windower = m.win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
        wo = m.win.count_window("count", s, clock, windower, key=lambda item: item[1])
        m.op.output("out", wo.down, m.TestingSink(out))
        result = _counted(m, lambda: m.run_main(flow, epoch_interval=ZERO_TD) or sorted(out))
        seen = set()
        for key, (wid, _count) in result[0]:
            assert (key, wid) not in seen, "duplicate (key, window) close"
            seen.add((key, wid))
        assert sum(c for _k, (_w, c) in result[0]) == n
        return result

    want, got = both(case)
    assert got == want
    assert got[2][-1][0].startswith("demote_win_df.count")
    assert got[1][1] == 1


def _ema_flow(m, out):
    inp = [(f"k{i % 3}", float(i % 7)) for i in range(60)]
    flow = m.Dataflow("demote_scan_df")
    s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=8))
    scored = m.op.stateful_map("ema", s, m.xla.ema(0.3))
    m.op.output("out", scored, m.TestingSink(out))
    return flow


def _canon(rows, places=3):
    return sorted((k, tuple(round(float(x), places) for x in v)) for k, v in rows)


def test_device_demotion_scan_state_continuity(monkeypatch):
    def case(m):
        _demotion_env(monkeypatch, "device_dispatch:error:2+", 2)
        monkeypatch.delenv("BYTEWAX_TPU_ACCEL", raising=False)
        m.faults.reset()
        demoted = []
        result = _counted(m, lambda: m.run_main(_ema_flow(m, demoted), epoch_interval=ZERO_TD))
        assert result[2] and result[2][-1][0].startswith("demote_scan_df.ema")
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "")
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
        m.faults.reset()
        host = []
        m.run_main(_ema_flow(m, host), epoch_interval=ZERO_TD)
        monkeypatch.delenv("BYTEWAX_TPU_ACCEL")
        assert _canon(demoted) == _canon(host)
        return demoted, result[1:]

    want, got = both(case)
    assert got[1] == want[1]
    for (gk, gv), (wk, wv) in zip(sorted(got[0]), sorted(want[0])):
        assert gk == wk
        np.testing.assert_allclose(np.array(gv, dtype=float), np.array(wv, dtype=float),
                                   rtol=0, atol=1e-4)


def test_transient_device_fault_retries_without_demotion(monkeypatch):
    _demotion_env(monkeypatch, "device_dispatch:error:*:x1", 3)
    monkeypatch.delenv("BYTEWAX_TPU_INGEST_TARGET_ROWS")
    inp = [(f"k{i % 2}", 1.0) for i in range(10)]

    def case(m):
        out = []
        flow = m.Dataflow("transient_df")
        s = m.op.input("inp", flow, m.TestingSource(inp, batch_size=5))
        r = m.op.reduce_final("sum", s, m.xla.SUM)
        m.op.output("out", r, m.TestingSink(out))
        return _counted(m, lambda: m.run_main(flow, epoch_interval=ZERO_TD) or dict(out))

    want, got = both(case)
    assert got == want
    assert got[0] == {"k0": 5.0, "k1": 5.0}
    assert got[1] == [1, 0, 0] and got[2] == []


def test_global_exchange_device_fault_is_not_demoted(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "device_dispatch:error:*")
    monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", "2")

    def case(m):
        class _FakeGlobalAgg:
            global_exchange = True

        class _FakeDriver:
            demote_after = 2
            trace_ops = False

        class _Op:
            step_id = "gx.step"

        rt = m.driver._StatefulBatchRt.__new__(m.driver._StatefulBatchRt)
        rt.driver = _FakeDriver()
        rt.agg = _FakeGlobalAgg()
        rt.wagg = rt.sagg = rt.iagg = None
        rt._pipe = rt._res = None
        rt._dev_faults = 0
        rt.demoted = None
        rt.op = _Op()
        m.faults.configure(0)
        m.faults.set_epoch(1)
        with pytest.raises(m.errors.DeviceFault) as info:
            rt._dispatch_device([(0, [("k", 1.0)])])
        assert rt.demoted is None and rt.agg is not None
        return str(info.value), rt._dev_faults

    want, got = both(case)
    assert got == want


def test_epoch_stalled_error_carries_context():
    def case(m):
        err = m.errors.EpochStalled("stalled", epoch=7, stalled_s=12.5)
        return err.epoch, err.stalled_s, str(err)

    want, got = both(case)
    assert got == want == (7, 12.5, "stalled")


# -- columnar wire: the comm fault sites cover accumulated frames ------


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_ship_flush_fault_fires_before_pending_drop(monkeypatch):
    def case(m):
        addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
        comms = {}
        threads = [
            threading.Thread(target=lambda p: comms.__setitem__(p, m.comm.Comm(addrs, p)),
                             args=(p,))
            for p in (0, 1)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()

        class _Probe(m.driver._Driver):
            def __init__(self, comm):
                self.comm = comm
                self.wpp = 1
                self.local_lo = 0
                self.local_hi = 1
                self._ship_acc = m.wire.RouteAccumulator()
                self.sent = [0, 0]

        d = _Probe(comms[0])
        try:
            batch = m.ArrayBatch({"key": np.array(["a", "b"]), "value": np.array([1.0, 2.0])})
            d.ship_route("s", (1, batch))
            assert d._ship_acc.pending()
            monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "comm.send:error:*:x1")
            monkeypatch.setenv("BYTEWAX_TPU_FAULTS_MIN_GAP_S", "0")
            m.faults.reset()
            m.faults.configure(0)
            m.faults.set_epoch(1)
            with pytest.raises(m.faults.InjectedFault):
                d.ship_flush()
            assert d._ship_acc.pending(), "accumulated run was dropped before the send fault"
            d.ship_flush()
            assert not d._ship_acc.pending()
            got = []
            deadline = time.monotonic() + 30
            while not got and time.monotonic() < deadline:
                got = comms[1].recv_ready(0.01)
            assert len(got) == 1
            kind, sid, (w, items) = got[0][1]
            return (kind, sid, w), items.cols["value"].tolist(), type(items).__module__
        finally:
            for c in comms.values():
                c.close()

    want, got = both(case)
    assert got[:2] == want[:2] == (("route", "s", 1), [1.0, 2.0])
    assert got[2].startswith("bytewax_tpu_torch.") and want[2].startswith("bytewax_tpu.")


def test_overlap_knobs_do_not_break_entrypoint_recovery(entry_point_name, tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_OVERLAP", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_DEPTH", "3")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int8")
    _supervision_env(monkeypatch, "snapshot.commit:crash:3:x1")

    def case(m):
        m.wire.reconfigure()
        try:
            out_path = tmp_path / m.label / "out.txt"
            rc = m.rc(tmp_path / m.label / "db")
            m.entry(entry_point_name)(_file_flow(m, INP12, str(out_path)),
                                      epoch_interval=ZERO_TD, recovery_config=rc)
            lines = sorted(out_path.read_text().split())
            assert lines == _sum_oracle(INP12)
            return lines
        finally:
            monkeypatch.delenv("BYTEWAX_TPU_GSYNC_QUANT")
            m.wire.reconfigure()
            monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int8")

    want, got = both(case)
    assert got == want
