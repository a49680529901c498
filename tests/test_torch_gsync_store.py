"""The cluster-wide exchange tier's store-composable overlap through the
torch port (``BYTEWAX_TPU_DISTRIBUTED=1``, a recovery store and
``BYTEWAX_TPU_GSYNC_OVERLAP=1``): the tier stashes each data-bearing
round, and every ``BYTEWAX_TPU_GSYNC_BASELINE_EVERY`` rounds a
full-aggregate baseline, in recovery ``snaps`` rows, and a resumed run
installs the baseline and replays the rounds after it.

- ``tests/test_chaos.py``'s crash case: a 2-process cluster
  (``python -m bytewax_tpu_torch.testing -p 2``, gloo on the CPU) loses
  process 1 inside a send at epoch 4, the supervisors restart both
  processes, and the output equals ``tests/test_cluster.py``
  ``_gx_paced_oracle`` exactly once; a third case resumes through a
  baseline;
- a store that a crashed JAX cluster wrote resumes in a port cluster,
  and a port-written store in a JAX cluster, exact and ``int8``, with
  baselines of both formats crossing (2 shards in both clusters);
- the refusals the JAX package makes (a baseline of another process
  count, a store of user-key rows), and the one it does not make (a
  baseline of another shard count);
- a fault unwind runs the lane's sealed rounds out instead of dropping
  them (a peer may be inside the same round's all-to-all);
- the salted row keys route back to the process that wrote them;
- the gsync knobs with a store under the three in-process entry points.

Each crash run's source sends one batch an epoch close and holds EOF
until its process has closed ``GX_HOLD_CLOSES`` epochs, so the
epoch-pinned crash lands after committed rounds whatever the load.
"""

import os
import subprocess
import sys
import zlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

from bytewax_tpu_torch.utils import force_platform

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    # One device a process in both packages: the same 2 shards.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["BYTEWAX_TPU_SHARD"] = "0"
    for knob in (
        "BYTEWAX_TPU_FAULTS",
        "BYTEWAX_TPU_MAX_RESTARTS",
        "BYTEWAX_TPU_RESCALE",
        "BYTEWAX_TPU_GSYNC_QUANT",
        "BYTEWAX_TPU_GSYNC_DEPTH",
        "BYTEWAX_TPU_GSYNC_BASELINE_EVERY",
        "BYTEWAX_TPU_WIRE",
        "BYTEWAX_TPU_VIRTUAL_DEVICES",
    ):
        env.pop(knob, None)
    env.update(
        {
            "BYTEWAX_TPU_ACCEL": "1",
            "BYTEWAX_TPU_DISTRIBUTED": "1",
            "BYTEWAX_TPU_GLOBAL_EXCHANGE": "1",
            "BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG": "1",
            "BYTEWAX_TPU_GSYNC_OVERLAP": "1",
            "BYTEWAX_TPU_INGEST_TARGET_ROWS": "0",
            "GX_BATCHES": "5",
            "GX_HOLD_CLOSES": "6",
        }
    )
    env.update(extra or {})
    return env


GX_STORE_FLOW = '''
import os
import time
from datetime import datetime, timedelta, timezone

import PKG.operators as op
from PKG import xla
from PKG.connectors.files import FileSink
from PKG.dataflow import Dataflow
from PKG.engine.flight import RECORDER
from PKG.inputs import FixedPartitionedSource, StatefulSourcePartition


class _Part(StatefulSourcePartition):
    """Batches with exact resume (the snapshot is the batch index), one
    an epoch close of this process: a batch leaves only once an epoch
    closed since the one before, and EOF waits for GX_HOLD_CLOSES
    closes (polled through next_awake; a stalled run still ends after
    60 s)."""

    def __init__(self, name, resume):
        self._base = 1000 if name == "p1" else 0
        self._i = resume or 0
        self._cap = int(os.environ["GX_BATCHES"])
        self._hold = int(os.environ["GX_HOLD_CLOSES"])
        self._deadline = time.monotonic() + 60
        self._seen = None
        self._awake = None

    def next_awake(self):
        return self._awake

    def next_batch(self):
        closes = RECORDER.counters.get("epoch_close_count", 0)
        if time.monotonic() < self._deadline and (
            (self._seen is not None and closes <= self._seen)
            or (self._i >= self._cap and closes < self._hold)
        ):
            self._awake = datetime.now(timezone.utc) + timedelta(milliseconds=10)
            return []
        if self._i >= self._cap:
            raise StopIteration()
        self._awake, self._seen = None, closes
        b = self._i
        self._i += 1
        ints = os.environ.get("GX_INTS", "0") == "1"
        return [
            (f"k{i % 7}", (self._base + b * 100 + i) if ints else float(self._base + b * 100 + i))
            for i in range(100)
        ]

    def snapshot(self):
        return self._i


class Src(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(name, resume)


flow = Dataflow("gx_store_df")
s = op.input("inp", flow, Src())
st = xla.stats_final("stats", s)
fmt = op.map("fmt", st, lambda kv: (kv[0], f"{kv[0]};{kv[1][0]};{kv[1][1]:.6f};{kv[1][2]};{kv[1][3]}"))
op.output("out", fmt, FileSink(OUT))
'''

CRASH = {
    # Process 1 crashes inside a send at epoch 4: earlier epochs have
    # committed, and their sealed rounds ride the collective lane.
    "BYTEWAX_TPU_FAULTS": "comm.send:crash:4:1:x1",
}
SUPERVISED = {
    "BYTEWAX_TPU_MAX_RESTARTS": "3",
    "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
    "BYTEWAX_TPU_EPOCH_STALL_S": "15",
}
INT8 = {
    "BYTEWAX_TPU_GSYNC_DEPTH": "2",
    "BYTEWAX_TPU_GSYNC_QUANT": "int8",
    # All-integer values: every column rides the exact path (int32
    # merge tables), so the oracle holds bit for bit under int8.
    "GX_INTS": "1",
}


def _init_db(pkg, path):
    path.mkdir()
    subprocess.run(
        [sys.executable, "-m", f"{pkg}.recovery", str(path), "2"],
        env=_env(),
        check=True,
        timeout=60,
    )


def _run(pkg, tmp_path, name, db, out, extra):
    flow_py = tmp_path / f"{name}_{pkg}.py"
    flow_py.write_text(GX_STORE_FLOW.replace("PKG", pkg).replace("OUT", repr(str(out))))
    cmd = [sys.executable, "-m", f"{pkg}.testing", f"{flow_py}:flow", "-p", "2"]
    cmd += ["-r", str(db), "-s", "0.1", "-b", "0"]
    return subprocess.run(
        cmd, env=_env(extra), cwd=tmp_path, capture_output=True, text=True, timeout=TIMEOUT_S
    )


def _check_oracle(out):
    """The output against the host oracle: each key once, count, min and
    max exact, the mean as ``tests/test_chaos.py`` bounds it."""
    from tests.test_cluster import _gx_paced_oracle

    got = {}
    for line in Path(out).read_text().split():
        key, mn, mean, mx, count = line.split(";")
        assert key not in got, f"key {key} emitted twice"
        got[key] = (float(mn), float(mean), float(mx), int(count))
    oracle = _gx_paced_oracle(batches=5)
    assert set(got) == set(oracle)
    for k, (mn, mean, mx, count) in oracle.items():
        assert got[k][3] == count, (k, got[k])
        assert got[k][0] == mn and got[k][2] == mx, (k, got[k])
        assert abs(got[k][1] - mean) < 0.05 * max(abs(mean), 1.0)


def _resumed(stderr, proc):
    """The port's resume line of one process: ``(baseline round or
    None, replayed rounds)``."""
    mark = f"global-exchange: proc {proc} resumed baseline round "
    lines = [ln for ln in stderr.splitlines() if mark in ln]
    assert len(lines) == 1, stderr[-3000:]
    base, rest = lines[0].split(mark, 1)[1].split(", replayed rounds ", 1)
    rounds = rest.split("]", 1)[0].strip("[")
    return (None if base == "None" else int(base)), [int(r) for r in rounds.split(",") if r.strip()]


def _live_gsync_rows(db):
    return list(_live_gsync_payloads(db))


def _live_gsync_payloads(db):
    """``{key: payload}`` of the store's live gsync rows."""
    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore, loads

    store = RecoveryStore(db)
    try:
        return {
            key: loads(ser) for _step, key, ser in store.iter_snaps(1 << 40) if key.startswith("\x00gsync-")
        }
    finally:
        store.close()


@pytest.mark.parametrize(
    "extra",
    [{}, INT8, {**INT8, "BYTEWAX_TPU_GSYNC_BASELINE_EVERY": "2"}],
    ids=["depth1", "depth2-int8", "depth2-int8-baseline2"],
)
def test_cluster_overlap_store_crash_resume_exactly_once(tmp_path, extra):
    """A store-composable-overlap cluster crashes at the real
    ``comm.send`` site while sealed rounds ride the lane; the
    supervisors restart both processes, the sources resume from their
    committed offsets, the tier replays its durable rows (through a
    baseline where ``BYTEWAX_TPU_GSYNC_BASELINE_EVERY=2``), and the
    output equals the oracle exactly once.  The clean end leaves no live
    gsync row in the store."""
    db, out = tmp_path / "db", tmp_path / "out.txt"
    _init_db("bytewax_tpu_torch", db)
    res = _run("bytewax_tpu_torch", tmp_path, "crash", db, out, {**CRASH, **SUPERVISED, **extra})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "supervised restart" in res.stderr, res.stderr[-3000:]
    assert res.stderr.count("global-exchange:") >= 2, res.stderr[-2000:]
    _check_oracle(out)
    for proc in (0, 1):
        base, rounds = _resumed(res.stderr, proc)
        if "BYTEWAX_TPU_GSYNC_BASELINE_EVERY" in extra:
            assert base is not None and base % 2 == 0, (base, rounds)
            assert all(r > base for r in rounds), (base, rounds)
        else:
            assert base is None and rounds == list(range(1, len(rounds) + 1)) and rounds, rounds
    assert _live_gsync_rows(db) == []


@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize(
    "writer,reader",
    [("bytewax_tpu", "bytewax_tpu_torch"), ("bytewax_tpu_torch", "bytewax_tpu")],
    ids=["jax-to-torch", "torch-to-jax"],
)
def test_crashed_cluster_store_resumes_across_packages(tmp_path, writer, reader, mode):
    """A 2-process cluster of one package crashes at epoch 4 with no
    supervisor and leaves its store; a 2-process cluster of the other
    package resumes it to the end, exactly once.  Baselines every two
    rounds, so the resume installs a baseline written by the other
    package (the exact tier's per-shard blocks, or the quantized tier's
    merge tables) and replays its round rows."""
    extra = {"BYTEWAX_TPU_GSYNC_BASELINE_EVERY": "2", **(INT8 if mode == "int8" else {})}
    db, out = tmp_path / "db", tmp_path / "out.txt"
    _init_db(writer, db)
    res = _run(writer, tmp_path, "write", db, out, {**CRASH, **extra})
    assert res.returncode != 0, "the writing cluster was meant to crash"
    assert "injected fault at 'comm.send'" in res.stderr, res.stderr[-3000:]
    if writer == "bytewax_tpu_torch" and mode == "exact":
        # The JAX package reads the port's exact round rows, which carry
        # a layout field it does not know.
        rounds = [p for k, p in _live_gsync_payloads(db).items() if k.startswith("\x00gsync-round")]
        assert rounds and all("layout" in p for p in rounds), rounds
    res = _run(reader, tmp_path, "read", db, out, extra)
    assert res.returncode == 0, res.stderr[-3000:]
    _check_oracle(out)
    if reader == "bytewax_tpu_torch":
        for proc in (0, 1):
            base, _rounds = _resumed(res.stderr, proc)
            assert base is not None and base % 2 == 0, res.stderr[-2000:]
    assert _live_gsync_rows(db) == []


class _Driver:
    """What the tier reads of a driver when it installs rows."""

    def __init__(self, proc_count=2, proc_id=0, wpp=1):
        self.proc_count = proc_count
        self.proc_id = proc_id
        self.worker_count = proc_count * wpp
        self.local_lo, self.local_hi = proc_id * wpp, (proc_id + 1) * wpp

    def is_local(self, w):
        return self.local_lo <= w < self.local_hi


def _bare(cls, local_devs=1, proc_count=2, proc_id=0):
    """A cluster-wide tier object of either package with the layout of
    ``proc_count`` processes of ``local_devs`` shards and no runtime."""
    state = object.__new__(cls)
    state.driver = _Driver(proc_count, proc_id)
    state.kind_name = "stats"
    state.local_devs = local_devs
    state.n_shards = local_devs * proc_count
    state.cap_per_shard = cls.CAP_PER_SHARD
    state._proc_shards = {p: list(range(p * local_devs, (p + 1) * local_devs)) for p in range(proc_count)}
    state._resume_rows = []
    state._merge_demoted = False
    state._quant_int = True
    return state


def _quant_baseline(shards, procs=2):
    size = shards * 4096
    return {
        "round": 2,
        "key_to_kid": {"k0": 0},
        "shard_fill": [1] + [0] * (shards - 1),
        "procs": procs,
        "fmt": "quant",
        "fields": {n: np.zeros(size) for n in ("min", "sum", "max", "count")},
        "quant_int": True,
    }


def test_refusals_match_the_reference():
    """A baseline of another process count, and a store of user-key rows
    from a per-process tier, raise the JAX package's errors, word for
    word; neither falls back to another tier."""
    from bytewax_tpu.engine.sharded_state import GlobalAggState as Ref
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState as Port

    errors = {}
    for cls in (Ref, Port):
        state = _bare(cls)
        with pytest.raises(RuntimeError) as procs:
            state._install_baseline(_quant_baseline(3, procs=3))
        with pytest.raises(RuntimeError) as user_keys:
            state.load_many([("k0", (1.0, 1.0, 1.0, 1))])
        errors[cls] = (str(procs.value), str(user_keys.value))
        assert state._resume_rows == []
    assert errors[Ref] == errors[Port]
    assert "cannot rescale on resume" in errors[Port][0]
    assert "user-key state written by another tier" in errors[Port][1]


def test_port_refuses_a_baseline_of_another_shard_count():
    """With the process count the same, a baseline laid out for 2 shards
    a process does not install into 1 shard a process: the port raises
    naming both layouts.  The JAX package installs the quantized tables
    of the other layout as they are (ROADMAP C)."""
    from bytewax_tpu.engine.sharded_state import GlobalAggState as Ref
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState as Port

    base = _quant_baseline(4)
    port = _bare(Port)
    with pytest.raises(RuntimeError, match=r"laid out for 4 shard\(s\) of 4096 slots .* 2 shard\(s\) of 4096"):
        port._install_baseline(base)
    assert getattr(port, "_dev_fields", None) is None
    ref = _bare(Ref)
    ref._install_baseline(base)
    assert ref._dev_fields["count"].shape == (4 * 4096,) != (ref.n_shards * ref.cap_per_shard,)


def _exact_round(layout, round_no=3):
    row = {
        "fmt": "exact",
        "round": round_no,
        "kids": np.zeros(1, dtype=np.int32),
        "vals": np.ones(1, dtype=np.float32),
        "new": ["k1"],
        "chunk_pd": 16,
        "capacity": 16,
        "n_steps": 1,
        "dtype": "float32",
    }
    if layout is not None:
        row["layout"] = layout
    return row


def test_port_refuses_an_exact_round_of_another_layout():
    """An exact round row sealed by a cluster of 2 devices a process
    does not replay on 1 device a process: the port raises naming both
    layouts before it installs anything, the baseline resumed with it
    included.  Rows of this layout, and rows with no layout as the JAX
    package writes them, pass the check."""
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState as Port

    port = _bare(Port)
    two_a_proc = _bare(Port, local_devs=2)._layout_fields()
    assert two_a_proc == {"procs": 2, "shards": 4, "cap": Port.CAP_PER_SHARD, "local_devs": 2}
    port._resume_rows = [
        (port._base_key(), _quant_baseline(2)),
        (port._round_key(3), _exact_round(two_a_proc)),
    ]
    port._base_written = False
    with pytest.raises(
        RuntimeError,
        match=r"round 3: it was laid out for 4 shard\(s\) of 4096 slots, 2 a process, over 2 .* "
        r"2 shard\(s\) of 4096 slots, 1 a process over 2",
    ):
        port._maybe_replay_resume()
    assert getattr(port, "key_to_kid", None) is None
    assert getattr(port, "_dev_fields", None) is None
    assert port._base_written is False
    for layout in (port._layout_fields(), None):
        port._check_round_layout(_exact_round(layout))


def test_fault_unwind_runs_sealed_rounds_out():
    """A fault unwind runs the lane's pending sealed rounds to their end
    (passing over one that fails) instead of dropping them: a peer may
    be inside the same round's all-to-all, which a dropped round would
    leave waiting, or pair with this process's next collective."""
    import threading

    from bytewax_tpu_torch.engine.pipeline import DevicePipeline
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState

    ran = []
    gate = threading.Event()
    lane = DevicePipeline("gsync", depth=8, phase="collective_lane")
    state = _bare(GlobalAggState)
    state._lane = state.driver._gsync_lane = lane

    def fails():
        raise RuntimeError("a round that fails")

    lane.push(lambda: (gate.wait(10), ran.append(1)), lambda _r: None)
    lane.push(lambda: ran.append(2), lambda _r: None)
    lane.push(fails, lambda _r: None)
    lane.push(lambda: ran.append(4), lambda _r: None)
    threading.Timer(0.05, gate.set).start()
    state.lane_shutdown()
    assert ran == [1, 2, 4]
    assert state._lane is None and state.driver._gsync_lane is None
    assert not lane.pending()


@pytest.mark.parametrize("procs,wpp", [(2, 1), (2, 2), (3, 2)])
def test_salted_row_keys_route_back_to_their_writer(procs, wpp):
    """A baseline or round row key is salted until its lane is one of
    the writing process's: the store's route stamp, the driver's
    routing hash and the JAX package's salting agree, so a resume read
    brings each process its own rows, in either package."""
    from bytewax_tpu.engine.sharded_state import GlobalAggState as Ref
    from bytewax_tpu_torch.engine.driver import _route_hash
    from bytewax_tpu_torch.engine.recovery_store import route_of
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState as Port

    seen = set()
    for proc in range(procs):
        port, ref = _bare(Port, proc_count=procs, proc_id=proc), _bare(Ref, proc_count=procs, proc_id=proc)
        port.driver = ref.driver = _Driver(procs, proc, wpp)
        wc = procs * wpp
        for key in (port._base_key(), port._round_key(7), port._round_key(12345)):
            assert key.startswith("\x00gsync-")
            lane = route_of(key, wc)
            assert lane == _route_hash(key) % wc == zlib.adler32(key.encode()) % wc
            assert port.driver.is_local(lane)
            seen.add(key)
        assert port._base_key() == ref._base_key()
        assert port._round_key(7) == ref._round_key(7)
    assert len(seen) == 3 * procs


def _supervision_env(monkeypatch, spec):
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", spec)
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")


def _cluster_main1x1(*args, **kwargs):
    from bytewax_tpu_torch.testing import cluster_main

    return cluster_main(*args, [], 0, **kwargs)


def _cluster_main1x2(*args, **kwargs):
    from bytewax_tpu_torch.testing import cluster_main

    return cluster_main(*args, [], 0, worker_count_per_proc=2, **kwargs)


@pytest.fixture(params=["run_main", "cluster_main-1thread", "cluster_main-2thread"])
def entry_point(request):
    from bytewax_tpu_torch.testing import run_main

    return {
        "run_main": run_main,
        "cluster_main-1thread": _cluster_main1x1,
        "cluster_main-2thread": _cluster_main1x2,
    }[request.param]


def test_overlap_knobs_do_not_break_entrypoint_recovery(entry_point, tmp_path, monkeypatch):
    """Under the three in-process entry points (no cluster-wide tier:
    the knobs are inert) a flow with ``BYTEWAX_TPU_GSYNC_OVERLAP=1``,
    a depth, ``int8`` and a recovery store recovers exactly once from an
    injected snapshot-commit crash, as ``tests/test_chaos.py`` holds the
    JAX package."""
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.connectors.files import FileSink
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine import faults
    from bytewax_tpu_torch.engine import wire as _wire
    from bytewax_tpu_torch.recovery import RecoveryConfig, init_db_dir
    from bytewax_tpu_torch.testing import TestingSource

    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_OVERLAP", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_DEPTH", "3")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int8")
    _wire.reconfigure()
    faults.reset()
    try:
        inp = [(f"k{i % 3}", i) for i in range(12)]
        out_path = tmp_path / "out.txt"
        db = tmp_path / "db"
        db.mkdir()
        init_db_dir(db, 1)
        _supervision_env(monkeypatch, "snapshot.commit:crash:3:x1")
        flow = Dataflow("chaos_df")
        s = op.input("inp", flow, TestingSource(inp))
        s = op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
        s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
        op.output("out", s, FileSink(str(out_path)))
        entry_point(flow, epoch_interval=timedelta(seconds=0), recovery_config=RecoveryConfig(str(db)))
        sums, want = {}, []
        for k, v in inp:
            sums[k] = sums.get(k, 0) + v
            want.append(f"{k}={sums[k]}")
        assert sorted(out_path.read_text().split()) == sorted(want)
    finally:
        monkeypatch.delenv("BYTEWAX_TPU_GSYNC_OVERLAP")
        monkeypatch.delenv("BYTEWAX_TPU_GSYNC_DEPTH")
        monkeypatch.delenv("BYTEWAX_TPU_GSYNC_QUANT")
        _wire.reconfigure()
        faults.reset()
