"""The epoch ledger of a two-process cluster of the torch port held
against the JAX package: the cluster cases of ``tests/test_ledger.py``.

Under ``BYTEWAX_TPU_GSYNC_OVERLAP=1`` the sealed exchange's spans land
on the Perfetto dump's own collective-lane track (tid 3), apart from
the driver's; and any process's ``/status`` shows both processes'
per-epoch phase breakdowns, each close-window sum within 10% of the
measured close.  Each package runs its own cluster on the CPU (the
port's collectives over gloo) with the same flow text.
"""

import json
import subprocess

from tests.test_ledger import _OVERLAP_TRACE_FLOW
from tests.test_torch_both import (  # noqa: F401
    BOTH,
    for_pkg,
    fresh_faults,
    port_on_cpu,
    unsharded,
)
from tests.test_torch_observability_cluster import (
    SUM_STEP,
    poll_until,
    reap,
    spawn_pair,
    tick_flow,
)


def _phase_sum(phases):
    return sum(s for steps in phases.values() for s in steps.values())


def _main_phases_only(phases):
    return {p: v for p, v in phases.items() if p != "device"}


def _dump(m, tmp_path):
    d = tmp_path / m.label
    d.mkdir()
    trace_dir = d / "traces"
    flow_py = d / "trace_ovl_flow.py"
    flow_py.write_text(for_pkg(_OVERLAP_TRACE_FLOW, m).format(out_path=str(d / "out.txt")))
    env = m.child_env(
        BYTEWAX_TPU_ACCEL="1",
        BYTEWAX_TPU_DISTRIBUTED="1",
        BYTEWAX_TPU_GLOBAL_EXCHANGE="1",
        BYTEWAX_TPU_GSYNC_OVERLAP="1",
        BYTEWAX_TPU_TRACE_DIR=str(trace_dir),
        BYTEWAX_TPU_INGEST_TARGET_ROWS="0",
    )
    res = subprocess.run(m.module_cmd("testing", f"{flow_py}:flow", "-p", "2", "-s", "0.2"),
                         env=env, cwd=d, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, (m, res.stderr[-3000:])
    return trace_dir


def test_perfetto_overlap_collective_lane_own_tid(tmp_path):
    seen = []
    for m in BOTH:
        trace_dir = _dump(m, tmp_path)
        lane_spans, other_tids, counter_ts = [], set(), {}
        for proc in (0, 1):
            files = sorted(trace_dir.glob(f"epoch-p{proc:02d}-*.json"))
            assert files, (m, list(trace_dir.iterdir() if trace_dir.exists() else []))
            for path in files:
                doc = json.loads(path.read_text())
                lane_named = [
                    ev for ev in doc["traceEvents"]
                    if ev["ph"] == "M" and ev["name"] == "thread_name"
                    and ev["args"]["name"] == "collective lane"
                ]
                assert lane_named and all(ev["tid"] == 3 for ev in lane_named), path
                for ev in doc["traceEvents"]:
                    if ev["ph"] == "X":
                        if ev["name"] == "collective_lane":
                            lane_spans.append(ev)
                        else:
                            other_tids.add(ev["tid"])
                    elif ev["ph"] == "C":
                        counter_ts.setdefault((str(path), ev["name"]), []).append(ev["ts"])
        assert lane_spans, f"no collective_lane spans in any dump of {m}"
        assert {ev["tid"] for ev in lane_spans} == {3}
        assert 3 not in other_tids and 1 in other_tids, other_tids
        assert counter_ts
        for (path, name), stamps in counter_ts.items():
            assert len(stamps) >= 2, (path, name, stamps)
            assert stamps == sorted(stamps), (path, name, stamps)
        seen.append((sorted(other_tids), sorted({n for _p, n in counter_ts})))
    assert seen[1] == seen[0]


def test_ledger_cluster_status_piggyback_2proc(tmp_path):
    def ready(got):
        cluster = got.get("cluster", {})
        return len(cluster) == 2 and all(
            isinstance(s.get("ledger"), dict) and s["ledger"].get("close")
            for s in cluster.values()
        )

    views = []
    for m in BOTH:
        port = {"jax": 13151, "torch": 13251}[m.label]
        db = tmp_path / f"db-{m.label}"
        m.rc(db)
        procs = spawn_pair(
            m, tmp_path, tick_flow("ledger_cluster_df", '[("k", 1)]', SUM_STEP),
            {"BYTEWAX_DATAFLOW_API_ENABLED": "1", "BYTEWAX_DATAFLOW_API_PORT": str(port)},
            ["-s", "0.3", "-b", "30", "-r", str(db)],
        )
        try:
            status = poll_until(port, "/status", ready)
        finally:
            reap(m, procs)
        assert status is not None, f"cluster ledgers never reached proc 0 of {m}"
        assert set(status["cluster"]) == {"0", "1"}
        for pid in ("0", "1"):
            record = status["cluster"][pid]["ledger"]
            assert isinstance(record["epoch"], int)
            assert record["phases"], record
            close_sum = sum(record["close"].values())
            close_s = record["close_s"]
            assert abs(close_sum - close_s) <= max(0.10 * close_s, 0.004), record
            main_sum = _phase_sum(_main_phases_only(record["phases"]))
            assert main_sum <= record["wall_s"] * 1.10 + 0.005, record
        assert "phase_totals" in status["ledger"]
        views.append((sorted(status["ledger"]), sorted(status["cluster"]["0"]["ledger"])))
    assert views[1] == views[0]
