"""Multi-process clusters of the JAX package and of the torch port, on
the same flow text: ``PKG`` names the package, and each run is a real
localhost cluster spawned by ``python -m PKG.testing -p 2``.

- ``reduce_final`` keyed exchange at 2 processes of 1 and of 2 lanes;
- a columnar windowed sum on the device tier (``BYTEWAX_TPU_ACCEL=1``,
  each child's device tier on the CPU);
- a recovery store that a 2-process JAX cluster wrote and left behind
  when one of its processes crashed, resumed by a 2-process port
  cluster: host-tier running sums and a device-tier ``stats_final``,
  each equal to the uninterrupted run with every row once;
- 1BRC text read by ``BrcFileSource`` in two partitions, one a
  process: each process's parser numbers stations in its own order.
  The port folds every routed batch through its sender's vocabulary;
  the JAX package takes a peer's ids as its own and refuses the run
  (ROADMAP C).

The JAX package's children run its single-device tier
(``BYTEWAX_TPU_SHARD=0``); every child runs on the CPU.
"""

import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("bytewax_tpu", "bytewax_tpu_torch")


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    env["BYTEWAX_TPU_SHARD"] = "0"
    env["BYTEWAX_TPU_ACCEL"] = "0"  # keep subprocess startup light
    for k in ("BYTEWAX_TPU_FAULTS", "BYTEWAX_TPU_MAX_RESTARTS", "BYTEWAX_TPU_RESCALE"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def _cluster(pkg, tmp_path, name, flow_text, procs=2, wpp=1, args=(), extra_env=None, out=None):
    """Write ``flow_text`` for ``pkg`` and run it on a ``procs``-process
    cluster; returns the finished process and the output file."""
    out = out or tmp_path / f"{name}_{pkg}_out.txt"
    flow_py = tmp_path / f"{name}_{pkg}.py"
    flow_py.write_text(flow_text.replace("PKG", pkg).replace("OUT", repr(str(out))))
    cmd = [sys.executable, "-m", f"{pkg}.testing", f"{flow_py}:flow", "-p", str(procs)]
    cmd += ["-w", str(wpp), *args]
    res = subprocess.run(
        cmd, env=_env(extra_env), cwd=tmp_path, capture_output=True, text=True, timeout=240
    )
    return res, out


def _init_db(pkg, path, parts):
    path.mkdir()
    subprocess.run(
        [sys.executable, "-m", f"{pkg}.recovery", str(path), str(parts)],
        env=_env(),
        check=True,
        timeout=60,
    )


KEYED_FLOW = """
import PKG.operators as op
from PKG.dataflow import Dataflow
from PKG.connectors.files import FileSink
from PKG.inputs import DynamicSource, StatelessSourcePartition


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        self._items = [
            (f"key-{i % 11}", worker_index * 100 + i) for i in range(worker_index * 8, worker_index * 8 + 24)
        ]
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
fmt = op.map("fmt", summed, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
op.output("out", fmt, FileSink(OUT))
"""


@pytest.mark.parametrize("procs,wpp", [(2, 1), (2, 2)])
def test_keyed_exchange_matches_reference(tmp_path, procs, wpp):
    outs = {}
    for pkg in PKGS:
        res, out = _cluster(pkg, tmp_path, "keyed", KEYED_FLOW, procs, wpp)
        assert res.returncode == 0, res.stderr[-2000:]
        outs[pkg] = sorted(out.read_text().split())
    want = defaultdict(int)
    for w in range(procs * wpp):
        for i in range(w * 8, w * 8 + 24):
            want[f"key-{i % 11}"] += w * 100 + i
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"] == sorted(f"{k}={v}" for k, v in want.items())


WINDOW_FLOW = """
from datetime import datetime, timedelta, timezone

import numpy as np

import PKG.operators as op
import PKG.operators.windowing as w
from PKG import xla
from PKG.connectors.files import FileSink
from PKG.dataflow import Dataflow
from PKG.engine.arrays import ArrayBatch
from PKG.inputs import DynamicSource, StatelessSourcePartition
from PKG.operators.windowing import EventClock, TumblingWindower

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        n = 400
        rng = np.random.RandomState(worker_index)
        secs = np.sort(rng.randint(0, 180, size=n))
        keys = np.array([f"key{k}" for k in rng.randint(0, 8, size=n)])
        vals = rng.randint(0, 8, size=n).astype(np.float64) * 0.5
        ts = np.datetime64("2022-01-01", "us") + secs.astype("timedelta64[s]")
        self._batches = [
            ArrayBatch({"key": keys[i : i + 128], "ts": ts[i : i + 128], "value": vals[i : i + 128]})
            for i in range(0, n, 128)
        ]

    def next_batch(self):
        if not self._batches:
            raise StopIteration()
        return self._batches.pop(0)


class BatchSource(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


clock = EventClock(ts_getter=xla.column_ts, wait_for_system_duration=timedelta(hours=1))
windower = TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
flow = Dataflow("colwin_df")
s = op.input("inp", flow, BatchSource())
wo = w.reduce_window("sum", s, clock, windower, xla.SUM)
fmt = op.map("fmt", wo.down, lambda kv: (kv[0], f"{kv[0]};{kv[1][0]};{kv[1][1]}"))
op.output("out", fmt, FileSink(OUT))
"""


def test_columnar_windowed_sum_matches_reference(tmp_path):
    """Both processes feed rows of every key, so each window's sum needs
    the keyed exchange; values on a grid of halves keep float32 sums
    exact, so the two packages' lines must be equal."""
    outs = {}
    for pkg in PKGS:
        res, out = _cluster(pkg, tmp_path, "colwin", WINDOW_FLOW, extra_env={"BYTEWAX_TPU_ACCEL": "1"})
        assert res.returncode == 0, res.stderr[-3000:]
        outs[pkg] = sorted(out.read_text().splitlines())
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"]
    seen = [tuple(line.split(";")[:2]) for line in outs["bytewax_tpu_torch"]]
    assert len(seen) == len(set(seen)), "a (key, window) closed twice"
    total = 0.0
    for w in (0, 1):
        rng = np.random.RandomState(w)
        rng.randint(0, 180, size=400)
        rng.randint(0, 8, size=400)
        total += rng.randint(0, 8, size=400).sum() * 0.5
    assert sum(float(line.split(";")[2]) for line in outs["bytewax_tpu_torch"]) == total


SEQ_FLOW = """
import os
import time
from datetime import datetime, timedelta, timezone

import PKG.operators as op
from PKG import xla
from PKG.dataflow import Dataflow
from PKG.connectors.files import FileSink
from PKG.engine.flight import RECORDER
from PKG.inputs import FixedPartitionedSource, StatefulSourcePartition


class _Part(StatefulSourcePartition):
    # One batch an epoch close of this process, and EOF held until it
    # closed XSTORE_HOLD_CLOSES epochs (polled through next_awake; a
    # stalled run still ends after 60 s): an epoch-pinned crash always
    # lands before EOF, whatever the load.
    def __init__(self, name, resume):
        self._name = name
        self._i = resume or 0
        self._hold = int(os.environ.get("XSTORE_HOLD_CLOSES", "0"))
        self._deadline = time.monotonic() + 60
        self._seen = None
        self._awake = None

    def next_awake(self):
        return self._awake

    def next_batch(self):
        closes = RECORDER.counters.get("epoch_close_count", 0)
        if time.monotonic() < self._deadline and (
            (self._seen is not None and closes <= self._seen) or (self._i >= 16 and closes < self._hold)
        ):
            self._awake = datetime.now(timezone.utc) + timedelta(milliseconds=5)
            return []
        if self._i >= 16:
            raise StopIteration()
        self._awake, self._seen = None, closes
        self._i += 1
        return [(f"{self._name}-{(self._i + j) % 4}", float(self._i + j)) for j in range(3)]

    def snapshot(self):
        return self._i


class SeqSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(name, resume)


flow = Dataflow("xstore_df")
s = op.input("inp", flow, SeqSource())
if os.environ["XSTORE_TIER"] == "host":
    s = op.stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
    s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
else:
    s = xla.stats_final("stats", s)
    s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1][0]};{kv[1][1]};{kv[1][2]};{kv[1][3]}"))
op.output("out", s, FileSink(OUT))
"""


def _seq_oracle(tier):
    rows = [(f"{p}-{(i + j) % 4}", float(i + j)) for p in ("p0", "p1") for i in range(1, 17) for j in range(3)]
    if tier == "host":
        sums, want = defaultdict(float), []
        for k, v in rows:
            sums[k] += v
            want.append(f"{k}={sums[k]}")
        return sorted(want)
    groups = defaultdict(list)
    for k, v in rows:
        groups[k].append(v)
    return sorted(f"{k}={min(g)};{sum(g) / len(g)};{max(g)};{len(g)}" for k, g in groups.items())


@pytest.mark.parametrize("tier", ["host", "device"])
def test_store_of_a_crashed_reference_cluster_resumes_in_the_port(tmp_path, tier):
    """A 2-process JAX cluster with a store (one batch an epoch close,
    EOF held past epoch 6) loses process 1 to an injected crash inside a
    send at epoch 4; a
    2-process port cluster resumes the store to the end.  The output
    (``FileSink`` cuts back to its snapshot) equals the uninterrupted
    run's, every row once."""
    env = {
        "XSTORE_TIER": tier,
        "BYTEWAX_TPU_ACCEL": "1" if tier == "device" else "0",
        # One epoch a batch: coalescing would swallow the source in one
        # poll, and the epoch-numbered crash would never fire.
        "BYTEWAX_TPU_INGEST_TARGET_ROWS": "0",
        # Wait for real progress: EOF only after 6 closes, past the
        # crash at epoch 4.
        "XSTORE_HOLD_CLOSES": "6",
    }
    # Epochs close every 50 ms whether or not a poll brought rows (at
    # an interval of 0 an empty poll closes none, and the source waits
    # for closes).
    args = ("-s", "0.05", "-b", "0")
    db = tmp_path / "db"
    _init_db("bytewax_tpu", db, 2)
    out = tmp_path / "xstore_out.txt"  # one sink file: its snapshot is an offset in it
    res, _out = _cluster(
        "bytewax_tpu",
        tmp_path,
        "xstore",
        SEQ_FLOW,
        args=("-r", str(db), *args),
        extra_env={**env, "BYTEWAX_TPU_FAULTS": "comm.send:crash:4:1:x1"},
        out=out,
    )
    assert res.returncode != 0, "the reference cluster was meant to crash"
    res, _out = _cluster(
        "bytewax_tpu_torch", tmp_path, "xstore", SEQ_FLOW, args=("-r", str(db), *args), extra_env=env, out=out
    )
    assert res.returncode == 0, res.stderr[-3000:]
    resumed = sorted(out.read_text().split())

    fresh = tmp_path / "fresh_db"
    _init_db("bytewax_tpu_torch", fresh, 2)
    res, whole = _cluster(
        "bytewax_tpu_torch", tmp_path, "whole", SEQ_FLOW, args=("-r", str(fresh), *args), extra_env=env
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert resumed == sorted(whole.read_text().split()) == _seq_oracle(tier)


def _brc_file(path, n, n_stations, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_stations, size=n)
    deci = rng.randint(-999, 1000, size=n)
    path.write_text("".join(f"st{i:03d};{d / 10:.1f}\n" for i, d in zip(ids, deci)))
    return ids, deci


BRC_FLOW = """
import PKG.operators as op
from PKG import xla
from PKG.dataflow import Dataflow
from PKG.connectors.files import FileSink
from PKG.models.brc import BrcFileSource

flow = Dataflow("brc")
s = op.input("inp", flow, BrcFileSource(MEASUREMENTS, part_count=2, chunk_bytes=4096))
s = xla.stats_final("stats", s)
s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]};{kv[1][0]:.1f};{kv[1][1]:.4f};{kv[1][2]:.1f};{kv[1][3]}"))
op.output("out", s, FileSink(OUT))
"""


def test_brc_file_partitions_route_with_their_own_vocabulary(tmp_path):
    path = tmp_path / "measurements.txt"
    ids, deci = _brc_file(path, 20_000, 60, seed=3)
    flow = BRC_FLOW.replace("MEASUREMENTS", repr(str(path)))
    env = {"BYTEWAX_TPU_ACCEL": "1"}
    res, out = _cluster("bytewax_tpu_torch", tmp_path, "brc", flow, extra_env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = {}
    for line in out.read_text().splitlines():
        station, mn, mean, mx, count = line.split(";")
        assert station not in got, f"{station} emitted twice"
        got[station] = (float(mn), float(mean), float(mx), int(count))
    want = {}
    for s in np.unique(ids):
        vals = deci[ids == s] / 10.0
        want[f"st{s:03d}"] = (round(vals.min(), 1), vals.mean(), round(vals.max(), 1), len(vals))
    assert got.keys() == want.keys()
    for station, (mn, mean, mx, count) in want.items():
        gmn, gmean, gmx, gcount = got[station]
        assert (gmn, gmx, gcount) == (mn, mx, count)
        assert abs(gmean - mean) <= 1e-3

    # The JAX package folds a peer's station ids into its own
    # vocabulary's table and refuses the run.
    res, _out = _cluster("bytewax_tpu", tmp_path, "brc", flow, extra_env=env)
    assert res.returncode != 0
    assert "key_vocab must be an append-only extension" in res.stderr
