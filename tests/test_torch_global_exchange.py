"""The cluster-wide exchange tier (``BYTEWAX_TPU_DISTRIBUTED=1``)
through the torch port: the multi-process cases of
``tests/test_cluster.py`` that need a distributed runtime, each through
``python -m bytewax_tpu_torch.testing -p 2`` (real subprocesses, gloo
on the CPU: ``BYTEWAX_TPU_PLATFORM=cpu``), each asserting what the
reference case asserts; the global-mesh flow is also held against the
JAX package's own global tier on the same flow text.  Then the cheap
pins the JAX package keeps on its tier: it never evicts, never enters
the dispatch pipeline, is never demoted per process, and the gsync
knobs are inert without a cluster.

The paced lock-step run is shared by the overlap and depth cases
through a module fixture.
"""

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest

from bytewax_tpu_torch.utils import force_platform

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    env["BYTEWAX_TPU_ACCEL"] = "0"  # keep subprocess startup light
    for knob in ("BYTEWAX_TPU_GSYNC_QUANT", "BYTEWAX_TPU_GSYNC_OVERLAP", "BYTEWAX_TPU_GSYNC_DEPTH", "BYTEWAX_TPU_WIRE"):
        env.pop(knob, None)
    env.update(extra)
    return env


def _spawn(flow_py: Path, env: dict, cwd: Path, package="bytewax_tpu_torch", extra=()):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.testing", f"{flow_py}:flow", "-p", "2", *extra],
        env=env,
        cwd=cwd,
        capture_output=True,
        text=True,
        timeout=TIMEOUT_S,
    )


def test_cluster_jax_distributed_init(tmp_path):
    # BYTEWAX_TPU_DISTRIBUTED=1: each cluster process joins one
    # torch.distributed world of both processes while the dataflow's
    # keyed exchange still routes over the host mesh (the device tier
    # is off here).
    flow_py = tmp_path / "dist_flow.py"
    out_path = str(tmp_path / "out.txt")
    flow_py.write_text(
        f'''
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        self._items = [(f"key-{{i}}", 1) for i in range(8)]
        self._done = worker_index != 0

    def next_batch(self):
        if self._done:
            raise StopIteration()
        self._done = True
        import torch.distributed as dist

        # Inside a worker: the distributed runtime is live and spans
        # both processes.
        assert dist.is_initialized()
        assert dist.get_world_size() == 2, dist.get_world_size()
        return self._items


class Src(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


flow = Dataflow("dist_df")
s = op.input("inp", flow, Src())
summed = op.reduce_final("sum", s, lambda a, b: a + b)
fmt = op.map_value("fmt", summed, str)
op.output("out", fmt, FileSink({out_path!r}))
'''
    )
    res = _spawn(flow_py, _env(BYTEWAX_TPU_DISTRIBUTED="1"), tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(Path(out_path).read_text().split()) == ["1"] * 8


_GX_FLOW = '''
import {pkg}.operators as op
from {pkg} import xla
from {pkg}.dataflow import Dataflow
from {pkg}.connectors.files import FileSink
from {pkg}.inputs import DynamicSource, StatelessSourcePartition


class _Part(StatelessSourcePartition):
    def __init__(self, worker_index):
        base = worker_index * 1000
        self._batches = [
            [(f"k{{i % 7}}", float(base + i)) for i in range(200)],
            [(f"k{{i % 7}}", float(base + 200 + i)) for i in range(200)],
        ]

    def next_batch(self):
        if not self._batches:
            raise StopIteration()
        return self._batches.pop(0)


class Src(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


flow = Dataflow("gx_df")
s = op.input("inp", flow, Src())
st = xla.stats_final("stats", s)
fmt = op.map(
    "fmt",
    st,
    lambda kv: (
        kv[0],
        f"{{kv[0]}};{{kv[1][0]}};{{kv[1][1]:.6f}};{{kv[1][2]}};{{kv[1][3]}}",
    ),
)
vals = op.map_value("val", fmt, lambda v: v)
op.output("out", vals, FileSink({out_path!r}))
'''


def test_cluster_global_mesh_exchange(tmp_path):
    """BYTEWAX_TPU_DISTRIBUTED=1 + accel, no recovery store: keyed rows
    ride one all-to-all over every process's shards at epoch close
    (GlobalAggState); both workers produce rows for every key, so a
    correct answer needs the cross-process exchange.  The debug line
    shows the collective ran on both processes over gloo, and the
    output equals the same flow over the pickled-TCP tier and the JAX
    package's global tier on the same flow text."""

    def run(name, global_exchange, pkg="bytewax_tpu_torch"):
        flow_py = tmp_path / f"{name}.py"
        out_path = str(tmp_path / f"{name}_out.txt")
        flow_py.write_text(_GX_FLOW.format(pkg=pkg, out_path=out_path))
        env = _env(
            BYTEWAX_TPU_ACCEL="1",
            BYTEWAX_TPU_DISTRIBUTED="1",
            BYTEWAX_TPU_GLOBAL_EXCHANGE="1" if global_exchange else "0",
            BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG="1",
        )
        res = _spawn(flow_py, env, tmp_path, package=pkg)
        assert res.returncode == 0, res.stderr[-3000:]
        return sorted(Path(out_path).read_text().split()), res.stderr

    glob, stderr = run("gx_global", True)
    for proc in (0, 1):
        line = next(ln for ln in stderr.splitlines() if f"global-exchange: proc {proc} flushed" in ln)
        assert "transport gloo (the shards lie on the CPU)" in line
    tcp, tcp_err = run("gx_tcp", False)
    assert "global-exchange" not in tcp_err
    assert glob == tcp
    assert len(glob) == 7
    jax_out, _ = run("gx_jax", True, pkg="bytewax_tpu")
    assert glob == jax_out


_GX_PACED_FLOW = '''
import os

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition


class _Part(StatelessSourcePartition):
    """Paced batches so the run spans several epochs (several
    collective flush rounds), not one EOF burst."""

    def __init__(self, worker_index):
        import time

        base = worker_index * 1000
        self._sleep = float(os.environ.get("GX_PACE_S", "0"))
        self._time = time
        # GX_INTS=1: plain ints, so every aggregate column stays on the
        # exact (integer) path.
        ints = os.environ.get("GX_INTS", "0") == "1"
        self._batches = [
            [
                (
                    f"k{{i % 7}}",
                    (base + b * 100 + i)
                    if ints
                    else float(base + b * 100 + i),
                )
                for i in range(100)
            ]
            for b in range(int(os.environ.get("GX_BATCHES", "4")))
        ]

    def next_batch(self):
        if not self._batches:
            raise StopIteration()
        if self._sleep:
            self._time.sleep(self._sleep)
        return self._batches.pop(0)


class Src(DynamicSource):
    def build(self, step_id, worker_index, worker_count):
        return _Part(worker_index)


flow = Dataflow("gx_paced_df")
s = op.input("inp", flow, Src())
st = xla.stats_final("stats", s)
fmt = op.map(
    "fmt",
    st,
    lambda kv: (
        kv[0],
        f"{{kv[0]}};{{kv[1][0]}};{{kv[1][1]:.6f}};{{kv[1][2]}};{{kv[1][3]}}",
    ),
)
vals = op.map_value("val", fmt, lambda v: v)
op.output("out", vals, FileSink({out_path!r}))
'''


def gx_paced_oracle(batches=4):
    rows = {}
    for base in (0, 1000):
        for b in range(batches):
            for i in range(100):
                rows.setdefault(f"k{i % 7}", []).append(float(base + b * 100 + i))
    return {k: (min(g), sum(g) / len(g), max(g), len(g)) for k, g in rows.items()}


def run_gx_paced(tmp_path, name, extra_env):
    """The paced flow on two processes of the port's global tier;
    returns ``({key: (min, mean, max, count)}, stderr)``."""
    flow_py = tmp_path / f"{name}.py"
    out_path = str(tmp_path / f"{name}_out.txt")
    flow_py.write_text(_GX_PACED_FLOW.format(out_path=out_path))
    env = _env(
        BYTEWAX_TPU_ACCEL="1",
        BYTEWAX_TPU_DISTRIBUTED="1",
        BYTEWAX_TPU_GLOBAL_EXCHANGE="1",
        BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG="1",
        # Batch-granular ingest: these runs need several epoch closes.
        BYTEWAX_TPU_INGEST_TARGET_ROWS="0",
        **extra_env,
    )
    res = _spawn(flow_py, env, tmp_path, extra=("-s", "0.2"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = {}
    for line in Path(out_path).read_text().split():
        key, mn, mean, mx, count = line.split(";")
        assert key not in got, f"key {key} emitted twice"
        got[key] = (float(mn), float(mean), float(mx), int(count))
    return got, res.stderr


_PACE = {"GX_PACE_S": "0.12", "GX_BATCHES": "4"}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """The paced flow on the lock-step tier (no overlap)."""
    got, _ = run_gx_paced(
        tmp_path_factory.mktemp("gx"), "gx_lockstep", dict(_PACE, BYTEWAX_TPU_GSYNC_OVERLAP="0")
    )
    return got


def _check_exact(got, oracle):
    assert set(got) == set(oracle)
    for k, (mn, mean, mx, count) in oracle.items():
        assert got[k][0] == mn and got[k][2] == mx
        assert got[k][3] == count
        assert abs(got[k][1] - mean) < 1e-6


def test_cluster_gsync_overlap_matches_lockstep_and_oracle(tmp_path, lockstep):
    """BYTEWAX_TPU_GSYNC_OVERLAP=1: the sealed exchange runs on the
    collective lane one epoch behind the compute frontier, and the
    output is byte-identical to the lock-step tier and the host
    oracle."""
    overlap, stderr = run_gx_paced(tmp_path, "gx_overlap", dict(_PACE, BYTEWAX_TPU_GSYNC_OVERLAP="1"))
    assert stderr.count("global-exchange: proc 0 flushed") >= 1
    assert stderr.count("global-exchange: proc 1 flushed") >= 1
    assert overlap == lockstep
    _check_exact(overlap, gx_paced_oracle())


@pytest.mark.parametrize("depth", [2, 4])
def test_cluster_gsync_depth_ladder_matches_lockstep_and_oracle(tmp_path, lockstep, depth):
    """BYTEWAX_TPU_GSYNC_DEPTH=D: up to D sealed rounds ride the
    collective lane, retired in order, and the output is byte-identical
    to the lock-step tier and the host oracle."""
    laddered, stderr = run_gx_paced(
        tmp_path,
        f"gx_d{depth}",
        dict(_PACE, BYTEWAX_TPU_GSYNC_OVERLAP="1", BYTEWAX_TPU_GSYNC_DEPTH=str(depth)),
    )
    assert stderr.count("global-exchange: proc 0 flushed") >= 1
    assert stderr.count("global-exchange: proc 1 flushed") >= 1
    assert laddered == lockstep
    _check_exact(laddered, gx_paced_oracle())


def test_cluster_gsync_quant_divergence_fails_typed(tmp_path):
    """Processes that disagree on the quant mode fail at the first
    flush (the mode rides the round payload); they never desynchronize
    the round sequence."""
    flow_py = tmp_path / "gx_div.py"
    flow_py.write_text(_GX_PACED_FLOW.format(out_path=str(tmp_path / "gx_div_out.txt")))
    spawn_py = tmp_path / "spawn_div.py"
    spawn_py.write_text(
        f'''
import os, subprocess, sys, socket

def free_port():
    s = socket.socket(); s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]; s.close(); return p

addrs = ";".join(f"127.0.0.1:{{free_port()}}" for _ in range(2))
procs = []
for pid, quant in ((0, "int8"), (1, "off")):
    env = dict(os.environ)
    env["BYTEWAX_TPU_GSYNC_QUANT"] = quant
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "bytewax_tpu_torch.run",
         sys.argv[1] + ":flow", "-a", addrs, "-i", str(pid),
         "-s", "0.2"],
        env=env, stderr=subprocess.PIPE, text=True,
    ))
errs = [p.communicate(timeout={TIMEOUT_S - 30})[1] for p in procs]
codes = [p.returncode for p in procs]
sys.stderr.write("\\n".join(errs))
sys.exit(0 if any(c != 0 for c in codes) else 3)
'''
    )
    env = _env(BYTEWAX_TPU_ACCEL="1", BYTEWAX_TPU_DISTRIBUTED="1", GX_BATCHES="2")
    res = subprocess.run(
        [sys.executable, str(spawn_py), str(flow_py)],
        env=env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=TIMEOUT_S,
    )
    assert res.returncode == 0, (res.returncode, res.stderr[-3000:])
    assert "disagree on BYTEWAX_TPU_GSYNC_QUANT" in res.stderr


# -- cheap pins --------------------------------------------------------------


def test_global_exchange_tier_never_evicts(monkeypatch):
    """The global tier is excluded from residency exactly like
    demotion: maybe_wrap refuses global_exchange states even with a
    budget armed, and GlobalAggState has no residency surface."""
    monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "2")
    from bytewax_tpu_torch.engine.residency import maybe_wrap
    from bytewax_tpu_torch.engine.sharded_state import GlobalAggState

    class _FakeGlobal:
        global_exchange = True

    fake = _FakeGlobal()
    assert maybe_wrap("step", fake) is fake
    assert not hasattr(GlobalAggState, "extract_keys")
    assert not hasattr(GlobalAggState, "inject_keys")


def test_global_exchange_tier_never_enters_dispatch_pipeline(monkeypatch):
    """The global tier never enters the per-delivery dispatch pipeline
    (its flush is a cluster collective, legal only at globally ordered
    points), and with overlap off it builds no lane at all."""
    import inspect

    from bytewax_tpu_torch.engine import driver as drv
    from bytewax_tpu_torch.engine import sharded_state as ss
    from bytewax_tpu_torch.engine.pipeline import DevicePipeline as DP

    assert DP.__init__.__defaults__ == (None, "device")
    src = inspect.getsource(drv._StatefulBatchRt.__init__)
    assert "global_exchange" in src and "DevicePipeline" in src
    monkeypatch.delenv("BYTEWAX_TPU_GSYNC_OVERLAP", raising=False)
    assert ss._gsync_overlap() is False
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_OVERLAP", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_DEPTH", "3")
    assert ss._gsync_overlap() is True and ss._gsync_depth() == 3
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_DEPTH", "x")
    with pytest.raises(ValueError, match="GSYNC_DEPTH"):
        ss._gsync_depth()


def test_global_exchange_device_fault_is_not_demoted(monkeypatch):
    # The collective tier must never demote per process (peers would
    # block in the exchange forever): the fault propagates as a
    # step-qualified DeviceFault instead.
    from bytewax_tpu_torch.engine import faults
    from bytewax_tpu_torch.engine.driver import _StatefulBatchRt
    from bytewax_tpu_torch.errors import DeviceFault

    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "device_dispatch:error:*")
    monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", "2")

    class _FakeGlobalAgg:
        global_exchange = True

    class _FakeDriver:
        demote_after = 2
        trace_ops = False

    rt = _StatefulBatchRt.__new__(_StatefulBatchRt)
    rt.driver = _FakeDriver()
    rt.agg = _FakeGlobalAgg()
    rt.wagg = rt.sagg = None
    rt._dev_faults = 0
    rt.demoted = None

    class _Op:
        step_id = "gx.step"

    rt.op = _Op()
    faults.configure(0)
    faults.set_epoch(1)
    try:
        with pytest.raises(DeviceFault):
            rt._dispatch_device([(0, [("k", 1.0)])])
    finally:
        monkeypatch.delenv("BYTEWAX_TPU_FAULTS")
        faults.configure(0)
    assert rt.demoted is None
    assert rt.agg is not None


@pytest.mark.parametrize("entry", ["run_main", "cluster_main-1thread", "cluster_main-2thread"])
def test_gsync_knobs_inert_without_global_mesh_under_distributed(entry, monkeypatch):
    """Overlap, quant and BYTEWAX_TPU_DISTRIBUTED=1 itself only
    renegotiate the cluster-spanning tier: one process under each
    in-process entry point (no cluster mesh) runs the ordinary device
    tier, and a keyed aggregation equals the host oracle."""
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch import xla
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine import wire
    from bytewax_tpu_torch.testing import TestingSink, TestingSource, cluster_main, run_main

    monkeypatch.setenv("BYTEWAX_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_OVERLAP", "1")
    monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int8")
    wire.reconfigure()
    items = [(f"k{i % 5}", float(i)) for i in range(200)]
    out = []
    flow = Dataflow("gsync_inert_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=16))
    summed = op.reduce_final("sum", s, xla.SUM)
    op.output("out", summed, TestingSink(out))
    try:
        if entry == "run_main":
            run_main(flow, epoch_interval=timedelta(0))
        else:
            wpp = 2 if entry.endswith("2thread") else 1
            cluster_main(flow, [], 0, worker_count_per_proc=wpp, epoch_interval=timedelta(0))
    finally:
        monkeypatch.delenv("BYTEWAX_TPU_GSYNC_QUANT")
        wire.reconfigure()
    oracle = {}
    for k, v in items:
        oracle[k] = oracle.get(k, 0.0) + v
    assert dict(out) == oracle


# -- the peer-major bucket layout --------------------------------------------


def _procs_rows(procs, local, seed, n=300):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    keys = torch.from_numpy(rng.randint(0, 5000, size=(local, n)).astype(np.int32))
    vals = torch.from_numpy(rng.randint(-(2**31), 2**31, size=(local, n), dtype=np.int64).astype(np.int32))
    ok = torch.from_numpy(rng.rand(local, n) < 0.9)
    return [keys, vals], ok


@pytest.mark.parametrize(
    "procs,local,flags", [(2, 1, 1), (2, 2, 3), (4, 2, 0), (3, 3, 1)], ids=["p2l1", "p2l2_pos", "p4l2_raw", "p3l3"]
)
def test_peer_major_bucket_layout_equals_the_old_transpose(procs, local, flags, monkeypatch):
    """The bucketing writes ``[peer, lane, dst of the peer, src, cap]``
    itself, which the cluster-wide exchange used to make with one more
    copy of the whole output (a view and ``transpose(0, 1).contiguous()``);
    ``exchange_procs`` hands that buffer to the all-to-all as it is."""
    import torch

    from bytewax_tpu_torch.parallel import exchange
    from bytewax_tpu_torch.parallel.mesh import World, make_mesh

    lanes, ok = _procs_rows(procs, local, seed=procs * 10 + local)
    n_shards = procs * local
    _o, raw, _d = exchange.bucket_blocks_plain(lanes[:1], n_shards, 300, valid=ok)
    capacity = int(raw.max())
    flat = exchange.bucket_blocks_plain(lanes, n_shards, capacity, valid=ok, flags=flags, pad0=-9)[0]
    n_out = flat.shape[0]
    old = flat.view(n_out, procs, local, local, capacity).transpose(0, 1).contiguous()
    direct = exchange.bucket_blocks_plain(lanes, n_shards, capacity, valid=ok, flags=flags, pad0=-9, peers=procs)[0]
    assert direct.shape == old.shape and direct.is_contiguous()
    assert torch.equal(direct, old)

    sent = []

    def all_to_all(world, send):
        sent.append(send)
        return send

    monkeypatch.setattr(exchange, "all_to_all_procs", all_to_all)
    mesh = make_mesh(devices=[torch.device("cpu")] * local)
    world = World(0, procs, mesh.devices, None, "gloo", False, "one process standing for the cluster", None)
    got = exchange.exchange_procs(
        mesh, world, capacity, [[lane[s] for s in range(local)] for lane in lanes],
        [ok[s] for s in range(local)], flags=flags, pad0=-9,
    )
    assert len(sent) == 1 and torch.equal(sent[0], old)
    assert [tuple(g.shape) for g in got] == [(n_out, n_shards, capacity)] * local
