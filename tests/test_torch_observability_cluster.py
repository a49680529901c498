"""The live endpoints of a two-process cluster of the torch port held
against the JAX package: the cluster cases of
``tests/test_observability.py`` (``/status`` with both processes'
telemetry summaries, which ride a gsync round at each epoch close,
and a cluster whose processes disagree on the API setting) and of
``tests/test_flowmap.py`` (``/graph`` merging both processes' flow
maps).

Each package's cluster runs the same flow text with its own imports,
under ``python -m <package>.run`` a process, and serves its endpoints
on a loopback port of its own.  The documents' shapes are compared
across packages; their counts are held to the reference test's bounds.
Every wait has a deadline and every child a time limit.
"""

import json
import socket
import subprocess
import time
import urllib.request

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    for_pkg,
    fresh_faults,
    port_on_cpu,
    shape,
    unsharded,
)

TICK_FLOW = """
import time
import bytewax_tpu.operators as op
from bytewax_tpu.dataflow import Dataflow
from bytewax_tpu.inputs import DynamicSource, StatelessSourcePartition
from bytewax_tpu.outputs import DynamicSink, StatelessSinkPartition


class _Tick(StatelessSourcePartition):
    def __init__(self, worker_index):
        self._i = 0
        self._w = worker_index

    def next_batch(self):
        if self._i >= 40:
            raise StopIteration()
        self._i += 1
        time.sleep(0.1)
        return ROWS


class TickSource(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Tick(worker_index)


class _Null(StatelessSinkPartition):
    def write_batch(self, items):
        pass


class NullSink(DynamicSink):
    def build(self, step_id, worker_index, worker_count):
        return _Null()


flow = Dataflow(FLOW_ID)
s = op.input("inp", flow, TickSource())
STEPS
op.output("out", s, NullSink())
"""

SUM_STEP = 's = op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))'


def tick_flow(flow_id, rows, steps=""):
    return (TICK_FLOW.replace("ROWS", rows).replace("FLOW_ID", repr(flow_id))
            .replace("STEPS", steps))


def _free_ports(n=2):
    ports = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    return ports


def spawn_pair(m, tmp_path, flow_text, env_extra, args, per_proc=None):
    """Starts a two-process cluster of ``m``'s running ``flow_text``
    (``python -m <package>.run`` a process)."""
    d = tmp_path / m.label
    d.mkdir(exist_ok=True)
    flow_py = d / "flow.py"
    flow_py.write_text(for_pkg(flow_text, m))
    env = m.child_env(BYTEWAX_TPU_ACCEL="0", BYTEWAX_TPU_DIAL_TIMEOUT_S="120",
                      BYTEWAX_ADDRESSES=";".join(f"127.0.0.1:{p}" for p in _free_ports()),
                      **env_extra)
    procs = []
    for proc_id in range(2):
        penv = dict(env, BYTEWAX_PROCESS_ID=str(proc_id))
        penv.update((per_proc or {}).get(proc_id, {}))
        procs.append(subprocess.Popen(m.module_cmd("run", f"{flow_py}:flow", *args), env=penv,
                                      cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def reap(m, procs, timeout=120):
    errs = []
    for proc in procs:
        try:
            _out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            _out, err = proc.communicate()
        errs.append(err)
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, (m, err[-2000:].decode(errors="replace"))


def poll_until(port, path, ready, deadline_s=150):
    """The first document at ``path`` that ``ready`` accepts, or
    None at the deadline."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=2) as r:
                got = json.loads(r.read())
        except OSError:
            time.sleep(0.2)
            continue
        if ready(got):
            return got
        time.sleep(0.2)
    return None


API_PORT = {"jax": 13145, "torch": 13245}


def test_status_cluster_gsync_piggyback(tmp_path):
    def ready(got):
        cluster = got.get("cluster", {})
        return len(cluster) == 2 and all(
            s["counters"].get("gsync_round_count", 0) >= 1 for s in cluster.values()
        )

    shapes = []
    for m in BOTH:
        port = API_PORT[m.label]
        procs = spawn_pair(m, tmp_path, tick_flow("status_cluster_df", '[("k", 1)]'),
                           {"BYTEWAX_DATAFLOW_API_ENABLED": "1",
                            "BYTEWAX_DATAFLOW_API_PORT": str(port)}, ["-s", "0.3"])
        try:
            status = poll_until(port, "/status", ready)
        finally:
            reap(m, procs)
        assert status is not None, f"cluster summary never reached proc 0 of {m}"
        assert set(status["cluster"]) == {"0", "1"}
        for pid in ("0", "1"):
            summary = status["cluster"][pid]
            assert isinstance(summary["epoch"], int)
            assert summary["counters"]["gsync_round_count"] >= 1
        assert status["recorder"]["counters"]["comm_frames_tx"] >= 1
        assert status["recorder"]["counters"]["comm_frames_rx"] >= 1
        wire = status["wire"]
        assert set(wire["pending"]) == {"route", "deliver"}
        for kind in ("route", "deliver"):
            assert set(wire["pending"][kind]) == {"buckets", "frames"}
            assert wire["pending"][kind]["buckets"] >= 0
        assert isinstance(wire["session"]["generation"], int)
        shapes.append((sorted(status), shape(wire), sorted(status["cluster"]["1"])))
    assert shapes[1] == shapes[0]


def test_status_cluster_divergent_env_does_not_hang(tmp_path):
    flow = """
import bytewax_tpu.operators as op
from bytewax_tpu.dataflow import Dataflow
from bytewax_tpu.testing import TestingSink, TestingSource

flow = Dataflow("div_df")
s = op.input("inp", flow, TestingSource(list(range(20))))
op.output("out", s, TestingSink([]))
"""
    for m in BOTH:
        port = API_PORT[m.label] + 2
        procs = spawn_pair(
            m, tmp_path, flow, {}, ["-s", "0.2"],
            per_proc={0: {"BYTEWAX_DATAFLOW_API_ENABLED": "1",
                          "BYTEWAX_DATAFLOW_API_PORT": str(port)},
                      1: {"BYTEWAX_DATAFLOW_API_ENABLED": "0"}},
        )
        reap(m, procs, timeout=150)


def test_graph_cluster_merges_both_processes(tmp_path):
    def merged(got):
        return [n for n in got.get("steps", []) if {"0", "1"} <= set(n.get("telemetry", {}))]

    views = []
    for m in BOTH:
        port = API_PORT[m.label] + 4
        procs = spawn_pair(
            m, tmp_path,
            tick_flow("graph_cluster_df", '[(f"k{self._w}", 1), (f"k{self._i % 3}", 1)]',
                      SUM_STEP),
            {"BYTEWAX_DATAFLOW_API_ENABLED": "1", "BYTEWAX_DATAFLOW_API_PORT": str(port)},
            ["-s", "0.3"],
        )
        try:
            graph = poll_until(port, "/graph", lambda g: bool(merged(g)))
        finally:
            reap(m, procs)
        assert graph is not None, f"peer flow-map never reached proc 0 of {m}"
        assert graph["flow_id"] == "graph_cluster_df"
        assert graph["proc_count"] == 2
        step_ids = [n["step_id"] for n in graph["steps"]]
        assert len(step_ids) == len(set(step_ids))
        for node in merged(graph):
            for pid in ("0", "1"):
                tele = node["telemetry"][pid]
                assert tele.get("rows_in", 0) >= 0
                assert "rate_in_per_s" in tele or "rate_out_per_s" in tele
        wire = graph["wire"]
        assert any(streams for per_proc in wire.values() for streams in per_proc.values()), wire
        views.append((step_ids, [(n["step_id"], n["tier"]) for n in graph["steps"]],
                      [(e["src"], e["dst"], e["port"]) for e in graph["edges"]]))
    assert views[1] == views[0]
