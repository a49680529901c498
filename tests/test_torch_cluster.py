"""Multi-process cluster execution through the torch port: the cases
of ``tests/test_cluster.py`` that need no distributed device runtime,
each asserting what the reference case asserts (real subprocesses
forming a localhost TCP mesh, as upstream bytewax's
``pytests/test_execution.py`` does).

Children run ``python -m bytewax_tpu_torch.testing`` /
``bytewax_tpu_torch.run`` with ``BYTEWAX_TPU_PLATFORM=cpu`` (the port's
device tier otherwise needs a CUDA card) and ``BYTEWAX_TPU_ACCEL=0``
for a light start, except where the device tier is the point.  The
cases that need the distributed runtime (``BYTEWAX_TPU_DISTRIBUTED=1``:
the distributed init, the global-mesh exchange and the five gsync
cases) are in ``tests/test_torch_global_exchange.py`` and
``tests/test_torch_gsync_quant.py``.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bytewax_tpu_torch.utils import force_platform

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _cluster_main1x1(*args, **kwargs):
    from bytewax_tpu_torch.testing import cluster_main

    return cluster_main(*args, [], 0, **kwargs)


def _cluster_main1x2(*args, **kwargs):
    from bytewax_tpu_torch.testing import cluster_main

    return cluster_main(*args, [], 0, worker_count_per_proc=2, **kwargs)


@pytest.fixture(params=["run_main", "cluster_main-1thread", "cluster_main-2thread"])
def entry_point(request):
    """Each in-process entry point, as ``tests/conftest.py`` gives the
    reference's tests."""
    from bytewax_tpu_torch.testing import run_main

    return {
        "run_main": run_main,
        "cluster_main-1thread": _cluster_main1x1,
        "cluster_main-2thread": _cluster_main1x2,
    }[request.param]


_FLOW_TEMPLATE = '''
import os
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        self._items = [
            (f"key-{{i}}", 1) for i in range(worker_index * 8, worker_index * 8 + 8)
        ] * 3
        self._done = False

    def next_batch(self):
        if self._done:
            raise StopIteration()
        self._done = True
        return self._items


class PerWorkerSource(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


flow = Dataflow("cluster_df")
s = op.input("inp", flow, PerWorkerSource())
summed = op.reduce_final("sum", s, lambda a, b: a + b)
fmt = op.map_value("fmt", summed, str)
op.output("out", fmt, FileSink({out_path!r}))
'''


def _write_flow(tmp_path: Path) -> Path:
    out_path = str(tmp_path / "out.txt")
    flow_py = tmp_path / "cluster_flow.py"
    flow_py.write_text(_FLOW_TEMPLATE.format(out_path=out_path))
    return flow_py


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    env["BYTEWAX_TPU_ACCEL"] = "0"  # keep subprocess startup light
    return env


@pytest.mark.parametrize("procs,wpp", [(2, 1), (2, 2)])
def test_cluster_keyed_exchange(tmp_path, procs, wpp):
    flow_py = _write_flow(tmp_path)
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "bytewax_tpu_torch.testing",
            f"{flow_py}:flow",
            "-p",
            str(procs),
            "-w",
            str(wpp),
        ],
        env=_env(),
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    out = (tmp_path / "out.txt").read_text().splitlines()
    # Each worker lane emits 8 unique keys 3 times; every key must be
    # summed exactly once (to "3"), wherever its home lane lives.
    assert sorted(out) == ["3"] * 8 * procs * wpp


def test_cluster_sigint_clean_shutdown(tmp_path):
    # An infinite source; SIGINT must terminate all processes.
    flow_py = tmp_path / "infinite_flow.py"
    flow_py.write_text(
        """
import time
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.stdio import StdOutSink
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition


class _Tick(StatelessSourcePartition):
    def next_batch(self):
        time.sleep(0.01)
        return ["tick"]


class TickSource(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Tick()


flow = Dataflow("inf_df")
s = op.input("inp", flow, TickSource())
s = op.filter("drop", s, lambda _x: False)
op.output("out", s, StdOutSink())
"""
    )
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "bytewax_tpu_torch.testing",
            f"{flow_py}:flow",
            "-p",
            "2",
            "-w",
            "1",
        ],
        env=_env(),
        cwd=tmp_path,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,
    )
    time.sleep(8)  # let the cluster form and run
    assert proc.poll() is None, "cluster exited prematurely"
    os.killpg(proc.pid, signal.SIGINT)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise AssertionError("cluster did not shut down on SIGINT")


def test_cluster_recovery_continuation(tmp_path):
    # Two executions of a 2-proc cluster with a shared recovery store:
    # the second resumes after the EOF sentinel.
    flow_py = tmp_path / "rec_flow.py"
    out_path = str(tmp_path / "out.txt")
    flow_py.write_text(
        f'''
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.testing import TestingSource

inp = ["a", "b", TestingSource.EOF(), "c", "d"]
flow = Dataflow("rec_df")
s = op.input("inp", flow, TestingSource(inp))
s = op.key_on("key", s, lambda x: x)
op.output("out", s, FileSink({out_path!r}))
'''
    )
    db = tmp_path / "db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
        env=_env(),
        check=True,
        timeout=60,
    )

    def run_cluster():
        return subprocess.run(
            [
                sys.executable,
                "-m",
                "bytewax_tpu_torch.testing",
                f"{flow_py}:flow",
                "-p",
                "2",
                "-r",
                str(db),
                "-s",
                "0",
                "-b",
                "0",
            ],
            env=_env(),
            cwd=tmp_path,
            capture_output=True,
            text=True,
            timeout=120,
        )

    res = run_cluster()
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(Path(out_path).read_text().split()) == ["a", "b"]

    res = run_cluster()
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(Path(out_path).read_text().split()) == ["a", "b", "c", "d"]


@pytest.mark.parametrize("accel", ["0", "1"])
def test_cluster_columnar_windowed_sum(tmp_path, accel):
    # A {'key','ts','value'} columnar source in a 2-proc cluster: the
    # keyed exchange degrades batches to (key, TsValue) items and
    # ships them to their home lane; window sums must cover every row
    # on both tiers.
    flow_py = tmp_path / "colwin_flow.py"
    out_path = str(tmp_path / "out.txt")
    flow_py.write_text(
        f'''
from datetime import datetime, timedelta, timezone

import numpy as np

import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as w
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
from bytewax_tpu_torch.operators.windowing import EventClock, TumblingWindower

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        self._batches = []
        if worker_index == 0:
            n = 400
            rng = np.random.RandomState(0)
            secs = np.sort(rng.randint(0, 180, size=n))
            keys = np.array([f"key{{k}}" for k in rng.randint(0, 8, size=n)])
            vals = np.ones(n)
            ts = (
                np.datetime64("2022-01-01", "us")
                + secs.astype("timedelta64[s]")
            )
            self._batches = [
                ArrayBatch(
                    {{
                        "key": keys[i : i + 128],
                        "ts": ts[i : i + 128],
                        "value": vals[i : i + 128],
                    }}
                )
                for i in range(0, n, 128)
            ]

    def next_batch(self):
        if not self._batches:
            raise StopIteration()
        return self._batches.pop(0)


class BatchSource(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


clock = EventClock(
    ts_getter=xla.column_ts,
    wait_for_system_duration=timedelta(seconds=5),
)
windower = TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
flow = Dataflow("colwin_df")
s = op.input("inp", flow, BatchSource())
wo = w.reduce_window("sum", s, clock, windower, xla.SUM)
fmt = op.map(
    "fmt", wo.down, lambda kv: (kv[0], f"{{kv[0]}} {{kv[1][0]}} {{kv[1][1]}}")
)
op.output("out", fmt, FileSink({out_path!r}))
'''
    )
    env = _env()
    env["BYTEWAX_TPU_ACCEL"] = accel
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "bytewax_tpu_torch.testing",
            f"{flow_py}:flow",
            "-p",
            "2",
        ],
        env=env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=180,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    total = 0.0
    seen = set()
    for line in Path(out_path).read_text().splitlines():
        key, wid, val = line.split()
        assert (key, wid) not in seen, "duplicate (key, window) emission"
        seen.add((key, wid))
        total += float(val)
    assert total == 400.0


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_comm_rx_buffer_bounded(monkeypatch):
    # Two peers bulk-sending >100 MB to each other in one epoch with
    # an 4 MiB rx cap: no deadlock, nothing lost, and neither side's
    # raw rx buffer materially exceeds the cap.
    import threading

    from bytewax_tpu_torch.engine.comm import Comm

    cap = 4 * 1024 * 1024
    monkeypatch.setenv("BYTEWAX_TPU_RX_BUFFER_CAP", str(cap))
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    n_msgs, msg_len = 60, 1_000_000  # ~60 MB each direction
    payload = b"x" * msg_len
    results = {}
    errors = []
    finished = threading.Barrier(2, timeout=120)

    def run(pid):
        try:
            comm = Comm(addrs, pid)
            got = []
            # Ship everything, then drain until the peer's full set
            # arrives (send() itself drains while blocked).
            for i in range(n_msgs):
                comm.send(1 - pid, (i, payload))
            comm.send(1 - pid, "done")
            done = False
            while not done or len(got) < n_msgs:
                for _peer, msg in comm.recv_ready(0.01):
                    if msg == "done":
                        done = True
                    else:
                        got.append(msg)
            results[pid] = (got, comm.rx_peak)
            finished.wait()  # both sides drained before either closes
            comm.close()
        except BaseException as ex:  # noqa: BLE001
            errors.append((pid, ex))

    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "comm exchange deadlocked"
    assert not errors, errors
    for pid in (0, 1):
        got, peak = results[pid]
        assert sorted(i for i, _p in got) == list(range(n_msgs))
        assert all(p == payload for _i, p in got)
        # Raw buffer bounded: cap plus one read chunk of slack.
        assert peak <= cap + (1 << 20), f"peer {pid} rx peaked at {peak}"


def test_comm_single_frame_larger_than_cap(monkeypatch):
    # A single frame bigger than the cap must still be receivable
    # (effective bound = max(cap, largest frame)), not stall forever.
    import threading

    from bytewax_tpu_torch.engine.comm import Comm

    monkeypatch.setenv("BYTEWAX_TPU_RX_BUFFER_CAP", str(1 << 20))
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    big = b"y" * (5 << 20)
    results = {}
    errors = []

    def run(pid):
        try:
            comm = Comm(addrs, pid)
            if pid == 0:
                comm.send(1, ("big", big))
                got = []
                while not got:
                    got = comm.recv_ready(0.01)
                results[0] = got
            else:
                got = []
                while not got:
                    got = comm.recv_ready(0.01)
                results[1] = got
                comm.send(0, "ack")
            comm.close()
        except BaseException as ex:  # noqa: BLE001
            errors.append((pid, ex))

    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "oversized-frame exchange stalled"
    assert not errors, errors
    assert results[1] == [(0, ("big", big))]
    assert results[0] == [(1, "ack")]


def test_cluster_peer_kill9_tears_down_and_resumes(tmp_path):
    # Chaos: kill -9 one worker process mid-stream; the surviving
    # process must detect the dead peer and exit instead of hanging,
    # and a restarted cluster must resume from the last snapshot.
    flow_py = tmp_path / "chaos_flow.py"
    out_path = str(tmp_path / "out.txt")
    flow_py.write_text(
        f'''
import itertools
import os
import time

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition


class _Part(StatefulSourcePartition):
    """Emits key-i sequentially, forever unless capped."""

    def __init__(self, resume):
        self._i = resume or 0

    def next_batch(self):
        cap = int(os.environ.get("CHAOS_CAP", "0"))
        if cap and self._i >= cap:
            raise StopIteration()
        self._i += 1
        time.sleep(0.01)
        return [(f"key-{{self._i % 4}}", self._i)]

    def snapshot(self):
        return self._i


class SeqSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(resume)


flow = Dataflow("chaos_df")
s = op.input("inp", flow, SeqSource())
s = op.map_value("fmt", s, str)
op.output("out", s, FileSink({out_path!r}))
'''
    )
    db = tmp_path / "db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
        env=_env(),
        check=True,
        timeout=60,
    )
    args = [
        sys.executable,
        "-m",
        "bytewax_tpu_torch.testing",
        f"{flow_py}:flow",
        "-p",
        "2",
        "-r",
        str(db),
        "-s",
        "0",
        "-b",
        "0",
    ]
    proc = subprocess.Popen(
        args,
        env=_env(),
        cwd=tmp_path,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,
    )
    # Wait for REAL progress, not wall clock: the replay-bound
    # assertion below needs every partition's snapshot past the
    # restart cap (40), so let the cluster write well beyond 2 x 44
    # rows before killing — a fixed sleep flakes when startup is slow
    # under suite load.
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        assert proc.poll() is None, "cluster exited prematurely"
        try:
            if len(Path(out_path).read_text().split()) >= 120:
                break
        except OSError:
            pass
        time.sleep(0.5)
    else:
        os.killpg(proc.pid, signal.SIGKILL)
        raise AssertionError("cluster made no progress before the kill")
    # SIGKILL one WORKER (a child of the spawner), not the spawner.
    children = subprocess.run(
        ["pgrep", "-P", str(proc.pid)], capture_output=True, text=True
    ).stdout.split()
    assert children, "no worker children found"
    os.kill(int(children[0]), signal.SIGKILL)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise AssertionError(
            "cluster hung after a worker was SIGKILLed mid-epoch"
        )
    assert rc != 0  # a crash is not a clean exit

    before = Path(out_path).read_text().split()
    assert before, "nothing was written before the kill"

    # Restart with a cap: the resume math must accept the crashed
    # execution's partial progress and run to a clean EOF.
    env = _env()
    env["CHAOS_CAP"] = "40"
    res = subprocess.run(
        args,
        env=env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    after = Path(out_path).read_text().split()
    # Sources resumed from their snapshots (already past the cap), so
    # at most the last uncommitted micro-batch per partition replays —
    # a from-scratch run would instead append 2 x 40 fresh rows.
    assert len(after) - len(before) <= 4, (len(before), len(after))


def test_cluster_3proc_recovery_rescale(tmp_path):
    # 3-proc cluster writes snapshots; a 2-proc cluster resumes the
    # same store (elastic rescale across executions).  Rescale is an
    # explicit opt-in since the rescale PR — the resumed run passes
    # --rescale so the startup pass re-routes the keyed rows to the
    # 2-worker modulus (tests/test_rescale.py covers the refusal and
    # crash-retry paths).
    flow_py = tmp_path / "rescale_flow.py"
    out_path = str(tmp_path / "out.txt")
    flow_py.write_text(
        f'''
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.testing import TestingSource

inp = [(f"k{{i % 5}}", 1) for i in range(20)] + [TestingSource.EOF()] + [
    (f"k{{i % 5}}", 1) for i in range(20, 30)
]
flow = Dataflow("rescale_df")
s = op.input("inp", flow, TestingSource(inp))
summed = op.stateful_map(
    "sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v)
)
fmt = op.map_value("fmt", summed, str)
op.output("out", fmt, FileSink({out_path!r}))
'''
    )
    db = tmp_path / "db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "3"],
        env=_env(),
        check=True,
        timeout=60,
    )

    def run_cluster(procs, rescale=False):
        return subprocess.run(
            [
                sys.executable,
                "-m",
                "bytewax_tpu_torch.testing",
                f"{flow_py}:flow",
                "-p",
                str(procs),
                "-r",
                str(db),
                "-s",
                "0",
                "-b",
                "0",
            ]
            + (["--rescale"] if rescale else []),
            env=_env(),
            cwd=tmp_path,
            capture_output=True,
            text=True,
            timeout=180,
        )

    res = run_cluster(3)
    assert res.returncode == 0, res.stderr[-2000:]
    first = Path(out_path).read_text().split()
    assert len(first) == 20

    res = run_cluster(2, rescale=True)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = Path(out_path).read_text().split()
    # The running sums continue from the snapshotted state: the final
    # counts per key must cover all 30 items exactly once.
    assert len(lines) == 30
    assert max(int(x) for x in lines) == 6  # 30 items / 5 keys


def test_comm_heartbeat_detects_frozen_peer(monkeypatch):
    # A frozen peer (socket open, nothing sent — no TCP close ever
    # arrives) must be declared dead within the heartbeat bound
    # (~2.5 intervals), with a clear coordinator-naming error.
    import threading
    import time as _time

    from bytewax_tpu_torch.engine.comm import Comm

    hb = 0.2
    monkeypatch.setenv("BYTEWAX_TPU_HEARTBEAT_S", str(hb))
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    errors = {}
    frozen = threading.Event()

    def run_live():
        comm = Comm(addrs, 1)
        t0 = _time.monotonic()
        try:
            while True:
                comm.recv_ready(0.02)
                if _time.monotonic() - t0 > 20:
                    errors[1] = ("timeout", None)
                    return
        except ConnectionError as ex:
            errors[1] = (str(ex), _time.monotonic() - t0)
        finally:
            comm.close()

    def run_frozen():
        comm = Comm(addrs, 0)
        # Handshake done; now freeze (no pumping, no close).
        frozen.wait(timeout=20)
        comm.close()

    threads = [
        threading.Thread(target=run_frozen),
        threading.Thread(target=run_live),
    ]
    for t in threads:
        t.start()
    threads[1].join(timeout=25)
    frozen.set()
    threads[0].join(timeout=5)
    msg, elapsed = errors[1]
    assert "coordinator (process 0)" in msg, msg
    assert "heartbeat" in msg
    # Detection within the documented bound (plus scheduling slack).
    assert elapsed is not None and elapsed < hb * 2.5 + 1.0, elapsed
    assert elapsed > hb * 2.0  # not trigger-happy either


def test_comm_heartbeats_keep_idle_cluster_alive(monkeypatch):
    # Two idle-but-pumping peers exchange heartbeats and survive far
    # past the detection limit; heartbeat frames are never delivered.
    import threading
    import time as _time

    from bytewax_tpu_torch.engine.comm import Comm

    hb = 0.1
    monkeypatch.setenv("BYTEWAX_TPU_HEARTBEAT_S", str(hb))
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    got = {0: [], 1: []}
    errors = []
    done = threading.Barrier(2, timeout=25)

    def run(pid):
        try:
            comm = Comm(addrs, pid)
            deadline = _time.monotonic() + hb * 12
            while _time.monotonic() < deadline:
                got[pid].extend(comm.recv_ready(0.02))
            comm.send(1 - pid, ("real", pid))
            want = (1 - pid, ("real", 1 - pid))
            while want not in got[pid]:
                got[pid].extend(comm.recv_ready(0.02))
            done.wait()  # both drained before either closes
            comm.close()
        except BaseException as ex:  # noqa: BLE001
            errors.append((pid, ex))

    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    # Only the real messages arrived; heartbeats were swallowed.
    assert got[0] == [(1, ("real", 1))]
    assert got[1] == [(0, ("real", 0))]


def test_comm_heartbeat_no_false_positive_on_partial_traffic(monkeypatch):
    # 3 peers; peer 1 sends real data only to peer 0.  Peer 2 must
    # keep seeing peer 1's heartbeats (per-peer tx tracking) and
    # never declare it dead.
    import threading
    import time as _time

    from bytewax_tpu_torch.engine.comm import Comm

    hb = 0.15
    monkeypatch.setenv("BYTEWAX_TPU_HEARTBEAT_S", str(hb))
    addrs = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    errors = []
    done = threading.Barrier(3, timeout=30)

    def run(pid):
        try:
            comm = Comm(addrs, pid)
            deadline = _time.monotonic() + hb * 15
            while _time.monotonic() < deadline:
                if pid == 1:
                    comm.send(0, ("chatter", pid))
                comm.recv_ready(0.02)
                _time.sleep(0.02)
            done.wait()
            comm.close()
        except BaseException as ex:  # noqa: BLE001
            errors.append((pid, ex))

    threads = [threading.Thread(target=run, args=(p,)) for p in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=40)
    assert not errors, errors


def test_cluster_wire_frame_accounting(monkeypatch):
    """Columnar exchange on a real 2-proc TCP mesh (both drivers in
    this process, one thread each): a columnar redistribute ships
    exactly ONE merged columnar frame per direction — per-slice
    frames coalesce in the route accumulator and zero-row slices
    never hit the wire — and the merged outputs cover every row
    exactly once (docs/performance.md "Columnar exchange")."""
    import threading

    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine import flight
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.engine.driver import cluster_main
    from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
    from bytewax_tpu_torch.testing import TestingSink

    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    n = 64  # per worker

    class _Part(StatelessSourcePartition):
        def __init__(self, worker_index):
            lo = worker_index * n
            self._batches = [
                ArrayBatch(
                    {
                        "key": np.array(
                            [f"w{worker_index}k{i}" for i in range(n)]
                        ),
                        "value": np.arange(lo, lo + n, dtype=np.float64),
                    }
                )
            ]

        def next_batch(self):
            if not self._batches:
                raise StopIteration()
            return self._batches.pop(0)

    class Src(DynamicSource):
        def build(self, step_id, worker_index, worker_count):
            return _Part(worker_index)

    outs = [[], []]
    errors = []

    def flow_for(pid):
        flow = Dataflow("wire_frames_df")
        s = op.input("inp", flow, Src())
        s = op.redistribute("redist", s)
        op.output("out", s, TestingSink(outs[pid]))
        return flow

    def run(pid):
        try:
            cluster_main(flow_for(pid), addrs, pid)
        except BaseException as ex:  # noqa: BLE001
            errors.append((pid, ex))

    before = dict(flight.RECORDER.counters)
    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "wire exchange deadlocked"
    assert not errors, errors

    # Every row exactly once across both processes' sinks.
    got = sorted(
        kv for out in outs for kv in out
    )
    want = sorted(
        (f"w{wrk}k{i}", float(wrk * n + i))
        for wrk in (0, 1)
        for i in range(n)
    )
    assert got == want

    # The frame-count pin: each direction's 32 remote-lane rows ship
    # as ONE merged columnar frame (2 total in the whole cluster);
    # nothing else — no per-slice frames, no zero-row frames — put a
    # columnar frame on the wire.  (Both drivers share this
    # process's recorder, so the counters are cluster totals.)
    after = flight.RECORDER.counters

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("wire_encode_frames_columnar") == 2
    assert delta("wire_decode_frames_columnar") == 2
    # And the columnar payloads really dominated the shipped bytes of
    # the data plane: each frame carries a 32-row key/value batch.
    assert delta("wire_encode_bytes_columnar") > 2 * 32 * 8


_COLUMNAR_SEQ_FLOW = '''
import os
import time

import numpy as np

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition

ROWS = 4  # rows per batch


class _Part(StatefulSourcePartition):
    """Columnar batches with exact resume: snapshot() is the batch
    index, so a supervised restart replays from the last committed
    epoch with byte-identical batches."""

    def __init__(self, name, resume):
        self._name = name
        self._i = resume or 0

    def next_batch(self):
        if self._i >= int(os.environ["CHAOS_CAP"]):
            raise StopIteration()
        self._i += 1
        i = self._i
        pace = float(os.environ.get("CHAOS_PACE_S", "0"))
        if pace:
            time.sleep(pace)
        return ArrayBatch(
            {{
                "key": np.array(
                    [f"{{self._name}}-{{(i + j) % 4}}" for j in range(ROWS)]
                ),
                "value": np.full(ROWS, i, dtype=np.int64),
            }}
        )

    def snapshot(self):
        return self._i


class SeqSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(name, resume)


flow = Dataflow("wire_chaos_df")
s = op.input("inp", flow, SeqSource())
s = op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
s = op.map("fmt", s, lambda kv: (kv[0], f"{{kv[0]}}={{kv[1]}}"))
op.output("out", s, FileSink({out_path!r}))
'''


def _columnar_seq_oracle(cap):
    rows = 4
    want = []
    for part in ("p0", "p1"):
        sums = {}
        for i in range(1, cap + 1):
            for j in range(rows):
                key = f"{part}-{(i + j) % 4}"
                sums[key] = sums.get(key, 0) + i
                want.append(f"{key}={sums[key]}")
    return sorted(want)


@pytest.mark.slow
@pytest.mark.parametrize("wire_mode", ["columnar", "pickle"])
def test_cluster_wire_crash_replay_exactly_once(tmp_path, wire_mode):
    """2-proc columnar keyed exchange with an injected worker crash
    mid-send (routed frames in flight at the crash): the supervisor
    restarts both processes, the restarted generation fences the dead
    generation's frames, and the final output equals the host oracle
    exactly-once.  Parametrized over both wire codecs so the crash
    semantics are proven identical (the pickle run is the PR's
    behavioral baseline)."""
    flow_py = tmp_path / f"wire_chaos_{wire_mode}.py"
    out_path = str(tmp_path / f"wire_chaos_{wire_mode}_out.txt")
    flow_py.write_text(_COLUMNAR_SEQ_FLOW.format(out_path=out_path))
    db = tmp_path / f"wire_chaos_{wire_mode}_db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
        env=_env(),
        check=True,
        timeout=60,
    )
    cap = 30
    env = _env()
    env.update(
        {
            "CHAOS_CAP": str(cap),
            "BYTEWAX_TPU_WIRE": wire_mode,
            # Crash worker 1 inside a comm send at epoch 4 — after
            # routed slices of that epoch accumulated and (some)
            # shipped, before the epoch commits.
            "BYTEWAX_TPU_FAULTS": "comm.send:crash:4:1:x1",
            "BYTEWAX_TPU_MAX_RESTARTS": "3",
            "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
        }
    )
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "bytewax_tpu_torch.testing",
            f"{flow_py}:flow",
            "-p",
            "2",
            "-r",
            str(db),
            "-s",
            "0",
            "-b",
            "0",
        ],
        env=env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=180,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "supervised restart" in res.stderr, res.stderr[-3000:]
    assert sorted(
        Path(out_path).read_text().split()
    ) == _columnar_seq_oracle(cap)


def test_gsync_overlap_knob_inert_without_global_mesh(
    entry_point, tmp_path, monkeypatch
):
    """Overlap/quant only renegotiate the cluster-spanning collective
    tier: under all three in-process entry points (no global mesh)
    the knobs are inert and a keyed aggregation equals the host
    oracle bit for bit."""
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla as bxla
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.testing import TestingSink, TestingSource
    from datetime import timedelta

    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_OVERLAP", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int8")
    from bytewax_tpu_torch.engine import wire as _wire

    _wire.reconfigure()
    items = [(f"k{i % 5}", float(i)) for i in range(200)]
    out = []
    flow = Dataflow("gsync_inert_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=16))
    summed = op.reduce_final("sum", s, bxla.SUM)
    op.output("out", summed, TestingSink(out))
    entry_point(flow, epoch_interval=timedelta(seconds=0))
    _wire.reconfigure()
    oracle = {}
    for k, v in items:
        oracle[k] = oracle.get(k, 0.0) + v
    assert dict(out) == oracle


# -- what crosses the mesh ---------------------------------------------------


def test_wire_refuses_a_tensor_on_a_device():
    """A routed batch whose column is a tensor off the host is refused
    by name, under both codecs, instead of being pickled through."""
    import numpy as np
    import torch

    from bytewax_tpu_torch.engine import wire
    from bytewax_tpu_torch.engine.arrays import ArrayBatch

    on_device = ArrayBatch(
        {"key": np.array(["a", "b"]), "value": torch.empty(2, device="meta")}
    )
    for msg in (("deliver", 3, "up", (0, on_device)), ("route", "s", (0, on_device))):
        with pytest.raises(TypeError, match="'value' is a tensor on meta"):
            wire.encode(msg)
    # Host columns, a CPU tensor among them, still encode.
    host = ArrayBatch({"key": np.array(["a", "b"]), "value": torch.ones(2)})
    assert wire.encode(("deliver", 3, "up", (0, host)))


def test_peer_vocabularies_fold_through_their_own_maps():
    """Two processes numbered the same stations in different orders:
    a batch that arrived from a peer (its vocabulary tagged with the
    sender) folds through that peer's map, never through this
    process's, and the same station lands in one slot whichever
    vocabulary named it."""
    import numpy as np

    from bytewax_tpu_torch.engine.arrays import ArrayBatch, peer_vocab
    from bytewax_tpu_torch.engine.xla import DeviceAggState

    state = DeviceAggState("stats")
    mine = np.array(["s0", "s1", "s2"])
    theirs = np.array(["s2", "s0"])
    state.update_batch(ArrayBatch({"key_id": np.array([0, 1, 2]), "value": np.array([1.0, 2.0, 3.0])}, key_vocab=mine))
    tagged = peer_vocab(theirs, 1)
    state.update_batch(ArrayBatch({"key_id": np.array([0, 1, 1]), "value": np.array([10.0, 20.0, 30.0])}, key_vocab=tagged))
    # The peer's vocabulary grows append-only, and this process's too.
    state.update_batch(
        ArrayBatch({"key_id": np.array([2, 0]), "value": np.array([5.0, 7.0])}, key_vocab=peer_vocab(np.array(["s2", "s0", "s3"]), 1))
    )
    state.update_batch(
        ArrayBatch({"key_id": np.array([3]), "value": np.array([4.0])}, key_vocab=np.array(["s0", "s1", "s2", "s4"]))
    )
    # Another lineage from the same peer starts its map over.
    state.update_batch(ArrayBatch({"key_id": np.array([0]), "value": np.array([6.0])}, key_vocab=peer_vocab(np.array(["s1"]), 1)))
    got = dict(state.finalize())
    want = {"s0": [1.0, 20.0, 30.0], "s1": [2.0, 6.0], "s2": [3.0, 10.0, 7.0], "s3": [5.0], "s4": [4.0]}
    assert got.keys() == want.keys()
    for key, vals in want.items():
        mn, mean, mx, count = got[key]
        assert (mn, mx, count) == (min(vals), max(vals), len(vals))
        assert mean == pytest.approx(sum(vals) / len(vals), rel=1e-6)
