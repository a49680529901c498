"""The per-process mesh-sharded tier of the JAX package and of the torch
port, on the same seeded inputs, at 8 shards on both sides.

The JAX package runs on the 8 virtual CPU devices ``tests/conftest.py``
gives it; the port on an 8-entry mesh of the CPU
(``force_cpu_mesh(8)``), through each kernel's plain version.  Every
case of ``tests/test_sharded.py`` runs here against the JAX package's
output, with ``tests/test_xla.py``'s two ``keyed_all_to_all`` cases,
direct cases of ``bucket_by_shard``, the residency manager and
demotion over the sharded states, a window store the JAX package wrote
resumed on the port's sharded tier, the exchange's path for a mesh of
distinct devices, and a 2-process cluster whose processes number the
same stations in different orders (each process's sharded state maps
a peer's dictionary ids through that peer's own map).

Tolerances: float32 sums ``rtol=atol=1e-5`` (they fold in another
order on each side); counts, extrema, buckets and integer sums
exactly; scan outputs as ``tests/test_sharded.py`` holds them.
"""

import collections
import os
import socket
import threading
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu_torch.operators as port_op
import bytewax_tpu_torch.operators.windowing as port_win
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import scan_accel as ref_sa
from bytewax_tpu.engine import sharded_state as ref_ss
from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
from bytewax_tpu.ops import scan as ref_scan
from bytewax_tpu.parallel import exchange as ref_exchange
from bytewax_tpu.parallel.mesh import make_mesh as ref_make_mesh
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.engine import scan_accel as port_sa
from bytewax_tpu_torch.engine import sharded_state as port_ss
from bytewax_tpu_torch.engine.arrays import ArrayBatch as PortBatch
from bytewax_tpu_torch.engine.xla import DeviceAggState as PortDeviceAgg
from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
from bytewax_tpu_torch.models.brc import ArrayBatchSource as PortArraySource
from bytewax_tpu_torch.ops import scan as port_scan
from bytewax_tpu_torch.ops.segment import AGG_KINDS as PORT_KINDS
from bytewax_tpu_torch.ops.sharded import init_sharded_fields, make_sharded_step
from bytewax_tpu_torch.parallel import exchange as port_exchange
from bytewax_tpu_torch.parallel.mesh import make_mesh as port_make_mesh
from bytewax_tpu_torch.recovery import RecoveryConfig as PortRecoveryConfig
from bytewax_tpu_torch.recovery import init_db_dir as port_init_db_dir
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import cluster_main as port_cluster_main
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import VIRTUAL_DEVICES_ENV, force_cpu_mesh
from tests.test_sharded import _run_step as ref_run_step
from tests.test_xla import ArraySource as RefArraySource

N_SHARDS = 8
SUM_TOL = dict(rtol=1e-5, atol=1e-5)

REF = {
    "op": ref_op,
    "win": ref_win,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "ArraySource": RefArraySource,
    "Batch": RefBatch,
    "run_main": ref_run_main,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
    "ss": ref_ss,
    "sa": ref_sa,
    "scan": ref_scan,
}
PORT = {
    "op": port_op,
    "win": port_win,
    "xla": port_xla,
    "Dataflow": PortDataflow,
    "Source": PortSource,
    "Sink": PortSink,
    "ArraySource": PortArraySource,
    "Batch": PortBatch,
    "run_main": port_run_main,
    "RecoveryConfig": PortRecoveryConfig,
    "init_db_dir": port_init_db_dir,
    "ss": port_ss,
    "sa": port_sa,
    "scan": port_scan,
}
BOTH = {"ref": REF, "port": PORT}


@pytest.fixture(autouse=True, scope="module")
def _port_on_a_cpu_mesh():
    names = ("BYTEWAX_TPU_PLATFORM", VIRTUAL_DEVICES_ENV)
    saved = {name: os.environ.get(name) for name in names}
    force_cpu_mesh(N_SHARDS)
    yield
    for name, value in saved.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


@pytest.fixture
def ref_mesh():
    if len(jax.devices()) < N_SHARDS:
        pytest.skip(f"needs {N_SHARDS} virtual devices")
    return ref_make_mesh(N_SHARDS)


@pytest.fixture
def port_mesh():
    return port_make_mesh(N_SHARDS)


def _same_results(got, want, exact=False):
    """Two ``(key, value)`` lists: the same keys in the same order,
    values equal (``exact``) or within the float32 sum tolerance."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_k, w) in zip(got, want):
        if exact:
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **SUM_TOL)


# -- the step directly ---------------------------------------------------------


def _port_step(mesh, kind, key_ids, values, cap_per_shard=64, capacity=None, dtype=torch.float32):
    """``tests/test_sharded.py``'s ``_run_step`` on the port: the same
    true per-(source, destination) capacity, rows cut into 8 source
    blocks; returns each field over every block (``[8 * cap]``)."""
    n = len(key_ids)
    rows = n // N_SHARDS
    if capacity is None:
        block_of = np.arange(n) // rows
        dest = key_ids % N_SHARDS
        capacity = int(np.bincount(block_of * N_SHARDS + dest, minlength=N_SHARDS**2).max())
    fields = init_sharded_fields(PORT_KINDS[kind], mesh, cap_per_shard, dtype=dtype)
    step = make_sharded_step(mesh, kind, cap_per_shard, capacity, dtype=dtype)

    def blocks(arr):
        return list(torch.from_numpy(np.ascontiguousarray(arr)).view(N_SHARDS, rows).unbind(0))

    out = step(fields, blocks(key_ids), blocks(values), blocks(np.ones(n, dtype=bool)))
    return {name: torch.cat([b[name] for b in out]).numpy() for name in out[0]}


def _same_tables(port, ref, exact_sums=False):
    assert port.keys() == ref.keys()
    for name, p in port.items():
        r = np.asarray(ref[name])
        if name == "sum" and not exact_sums:
            np.testing.assert_allclose(p, r, err_msg=name, **SUM_TOL)
        else:
            np.testing.assert_array_equal(p, r, err_msg=name)


def test_sharded_step_matches_oracle_random(ref_mesh, port_mesh):
    rng = np.random.RandomState(1)
    n, n_keys, cap = 512, 100, 64
    key_ids = rng.randint(0, n_keys, size=n).astype(np.int32)
    values = rng.randn(n).astype(np.float32)
    port = _port_step(port_mesh, "stats", key_ids, values, cap_per_shard=cap)
    _same_tables(port, ref_run_step(ref_mesh, "stats", key_ids, values, cap_per_shard=cap))
    assert port["count"].sum() == n  # row conservation


def test_sharded_step_nonuniform_distribution(ref_mesh, port_mesh):
    n, cap = 256, 64
    key_ids = np.where(np.arange(n) % 2 == 0, 0, 1).astype(np.int32)
    values = np.ones(n, dtype=np.float32)
    port = _port_step(port_mesh, "sum", key_ids, values, cap_per_shard=cap)
    _same_tables(port, ref_run_step(ref_mesh, "sum", key_ids, values, cap_per_shard=cap), exact_sums=True)
    assert port["sum"].sum() == n


def test_sharded_step_float_bitcast_roundtrip(ref_mesh, port_mesh):
    specials = np.array([-0.0, 1.5, -2.25, 1.2e-38, -1e38, 3.14159], dtype=np.float32)
    n = 64
    key_ids = (np.arange(n) % len(specials)).astype(np.int32)
    values = specials[key_ids]
    port = _port_step(port_mesh, "max", key_ids, values, cap_per_shard=16)
    ref = ref_run_step(ref_mesh, "max", key_ids, values, cap_per_shard=16)
    assert port["max"].tobytes() == np.asarray(ref["max"]).tobytes()


def test_sharded_step_int32_exact(ref_mesh, port_mesh):
    n = 64
    key_ids = np.zeros(n, dtype=np.int32)
    values = np.full(n, 2**24 + 1, dtype=np.int32)
    port = _port_step(port_mesh, "sum", key_ids, values, cap_per_shard=16, dtype=torch.int32)
    ref = ref_run_step(ref_mesh, "sum", key_ids, values, cap_per_shard=16, dtype=jnp.int32)
    _same_tables(port, ref, exact_sums=True)
    assert port["sum"][0] == n * (2**24 + 1)


def test_sharded_step_capacity_boundary(ref_mesh, port_mesh):
    n = 64
    key_ids = np.zeros(n, dtype=np.int32)
    values = np.ones(n, dtype=np.float32)
    kw = dict(cap_per_shard=16, capacity=8)
    port = _port_step(port_mesh, "sum", key_ids, values, **kw)
    _same_tables(port, ref_run_step(ref_mesh, "sum", key_ids, values, **kw), exact_sums=True)
    assert port["sum"][0] == n


# -- the aggregation state -------------------------------------------------------


def _both_states(ref_mesh, port_mesh, kind, **kw):
    return (
        ref_ss.ShardedAggState(kind, ref_mesh, **kw),
        port_ss.ShardedAggState(kind, port_mesh, **kw),
    )


def test_sharded_state_matches_single_device(ref_mesh, port_mesh):
    rng = np.random.RandomState(2)
    n = 3000
    keys = np.array([f"k{i:03d}" for i in rng.randint(0, 413, size=n)])
    vals = (rng.randn(n) * 10).round(1).astype(np.float64)
    ref, port = _both_states(ref_mesh, port_mesh, "stats")
    single = PortDeviceAgg("stats")
    for i in range(0, n, 700):  # uneven batches
        for st in (ref, port, single):
            st.update(keys[i : i + 700], vals[i : i + 700])
    got = port.finalize()
    _same_results(got, ref.finalize())
    _same_results(got, single.finalize())


def test_sharded_state_skewed_hot_key(ref_mesh, port_mesh):
    keys = np.array(["hot"] * 9000 + [f"cold{i}" for i in range(100)])
    outs = []
    for st in _both_states(ref_mesh, port_mesh, "count"):
        st.update(keys, np.zeros(len(keys)))
        outs.append(st.finalize())
    _same_results(outs[1], outs[0], exact=True)
    assert dict(outs[1])["hot"] == 9000


def test_sharded_state_dict_encoded_batches(ref_mesh, port_mesh):
    vocab = np.array([f"station{i}" for i in range(50)])
    rng = np.random.RandomState(3)
    ref, port = _both_states(ref_mesh, port_mesh, "stats")
    for _ in range(4):
        ids = rng.randint(0, 50, size=500).astype(np.int32)
        temps = rng.randint(-400, 400, size=500).astype(np.int16)
        for st, batch in ((ref, RefBatch), (port, PortBatch)):
            st.update_batch(batch({"key_id": ids, "value": temps}, key_vocab=vocab, value_scale=0.1))
    _same_results(port.finalize(), ref.finalize())


def test_sharded_state_growth_keeps_state(ref_mesh, port_mesh):
    many = np.array([f"key{i:05d}" for i in range(1000)])
    outs = []
    for st in _both_states(ref_mesh, port_mesh, "sum", cap_per_shard=8):
        st.update(np.array(["early"]), np.array([5.0]))
        st.update(many, np.ones(1000))
        st.update(np.array(["early"]), np.array([7.0]))
        outs.append(st.finalize())
    _same_results(outs[1], outs[0], exact=True)
    assert dict(outs[1])["early"] == 12.0


# -- engine integration ----------------------------------------------------------


def _brc_batches(pkg, n=4000, n_keys=200, seed=4):
    rng = np.random.RandomState(seed)
    batches = []
    for i in range(0, n, 512):
        m = min(512, n - i)
        keys = np.array([f"s{k:03d}" for k in rng.randint(0, n_keys, size=m)])
        batches.append(pkg["Batch"]({"key": keys, "value": (rng.randn(m) * 10).round(1)}))
    return batches


def _brc_run(pkg):
    out = []
    flow = pkg["Dataflow"]("sharded_df")
    s = pkg["op"].input("inp", flow, pkg["ArraySource"](_brc_batches(pkg)))
    pkg["op"].output("out", pkg["xla"].stats_final("stats", s), pkg["Sink"](out))
    pkg["run_main"](flow)
    return out


def _states_built(monkeypatch):
    """Record the aggregation states the port's runs build."""
    built = []
    make = port_ss.make_agg_state

    def recording(kind, driver=None):
        built.append(make(kind, driver=driver))
        return built[-1]

    monkeypatch.setattr(port_ss, "make_agg_state", recording)
    return built


def test_dataflow_sharded_matches_host_tier(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "8")
    built = _states_built(monkeypatch)
    ref = _brc_run(REF)
    sharded = _brc_run(PORT)
    assert [type(s).__name__ for s in built] == ["ShardedAggState"]
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    host = _brc_run(PORT)
    _same_results(sharded, ref)
    assert [k for k, _ in sharded] == [k for k, _ in host]
    for (k, vs), (_k, vh) in zip(sharded, host):
        np.testing.assert_allclose(vs, vh, rtol=1e-4, err_msg=k)


def test_dataflow_sharded_reduce_sum_exact(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "8")
    inp = [(f"k{i % 40}", i) for i in range(2000)]

    def run(pkg):
        out = []
        flow = pkg["Dataflow"]("sum_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=128))
        pkg["op"].output("out", pkg["op"].reduce_final("sum", s, pkg["xla"].SUM), pkg["Sink"](out))
        pkg["run_main"](flow)
        return out

    sharded = run(PORT)
    assert sharded == run(REF)
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    assert sharded == run(PORT)


def test_sharded_cross_tier_recovery(tmp_path, monkeypatch):
    # Crash on the host tier, resume on the mesh; crash on the mesh,
    # resume on the host tier; each in both packages.  The mesh runs
    # resume the other package's store as well.
    def build(pkg, inp, out):
        flow = pkg["Dataflow"]("rec_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp))
        pkg["op"].output("out", pkg["op"].reduce_final("sum", s, pkg["xla"].SUM), pkg["Sink"](out))
        return flow

    def crash_then_resume(first, second, first_accel, second_accel, name):
        db = tmp_path / name
        db.mkdir()
        first["init_db_dir"](db, 1)
        outs = []
        for resume, (pkg, accel) in enumerate(((first, first_accel), (second, second_accel))):
            monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
            inp = [("k", 1.0), ("k", 2.0), pkg["Source"].ABORT(), ("k", 4.0)]
            inp[2]._triggered = bool(resume)  # spent by the first run
            out = []
            pkg["run_main"](
                build(pkg, inp, out),
                epoch_interval=timedelta(0),
                recovery_config=pkg["RecoveryConfig"](str(db)),
            )
            outs.append(out)
        return outs

    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "8")
    for first, second in ((PORT, PORT), (REF, PORT), (PORT, REF)):
        tag = f"{first is PORT}{second is PORT}"
        assert crash_then_resume(first, second, "0", "1", f"host_mesh_{tag}") == [[], [("k", 7.0)]]
        assert crash_then_resume(first, second, "1", "0", f"mesh_host_{tag}") == [[], [("k", 7.0)]]


def test_make_agg_state_selection(monkeypatch):
    for name, pkg in BOTH.items():
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
        assert type(pkg["ss"].make_agg_state("sum")).__name__ == "DeviceAggState", name
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "auto")
        st = pkg["ss"].make_agg_state("sum")
        assert isinstance(st, pkg["ss"].ShardedAggState) and st.n_shards == 8, name
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "4")
        st4 = pkg["ss"].make_agg_state("sum")
        assert isinstance(st4, pkg["ss"].ShardedAggState) and st4.n_shards == 4, name


def test_windowed_fold_sharded_matches_single_device(monkeypatch):
    align = datetime(2022, 1, 1, tzinfo=timezone.utc)
    n = 4000
    rng = np.random.RandomState(12)
    secs = np.sort(rng.randint(0, 300, size=n))
    keys = np.array([f"key{k}" for k in rng.randint(0, 6, size=n)])
    vals = (rng.randn(n) * 3).round(2)
    ts = np.datetime64(align.replace(tzinfo=None), "us") + secs.astype("timedelta64[s]")

    def run(pkg, accel, shard):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", shard)
        batches = [
            pkg["Batch"]({"key": keys[i : i + 512], "ts": ts[i : i + 512], "value": vals[i : i + 512]})
            for i in range(0, n, 512)
        ]
        win = pkg["win"]
        clock = win.EventClock(ts_getter=pkg["xla"].column_ts, wait_for_system_duration=timedelta(seconds=30))
        windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
        out = []
        flow = pkg["Dataflow"]("swin_df")
        s = pkg["op"].input("inp", flow, pkg["ArraySource"](batches))
        wo = win.reduce_window("sum", s, clock, windower, pkg["xla"].SUM)
        pkg["op"].output("out", wo.down, pkg["Sink"](out))
        pkg["run_main"](flow)
        return sorted(out)

    built = _states_built(monkeypatch)
    sharded = run(PORT, "1", "8")
    assert [type(s).__name__ for s in built] == ["ShardedAggState"]
    ref = run(REF, "1", "8")
    single = run(PORT, "1", "0")
    host = run(PORT, "0", "0")
    for other, tol in ((ref, SUM_TOL), (single, SUM_TOL), (host, dict(rtol=1e-4))):
        assert [kv[0] for kv in sharded] == [kv[0] for kv in other]
        for (k, (wd, vs)), (_k, (wo, vo)) in zip(sharded, other):
            assert wd == wo, k
            np.testing.assert_allclose(vs, vo, err_msg=k, **tol)


@pytest.mark.parametrize("path", ["residency", "demotion"])
def test_sharded_states_evict_restore_and_demote_like_the_jax_package(path, tmp_path, monkeypatch):
    # Both tiers of the sharded mesh under the residency manager (a
    # budget of 3 device keys over 20, so most keys spill and come
    # back) or demoted to the host tier after repeated dispatch
    # faults: the port's output equals the JAX package's.
    from bytewax_tpu_torch.engine import flight as port_flight

    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "8")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    if path == "residency":
        monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "3")
        monkeypatch.setenv("BYTEWAX_TPU_HOST_STATE_BUDGET", "5")
        monkeypatch.setenv("BYTEWAX_TPU_SPILL_DIR", str(tmp_path / "spill"))
    else:
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "device_dispatch:error:3+")
        monkeypatch.setenv("BYTEWAX_TPU_DEMOTE_AFTER", "2")
        monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    inp = [(f"u{i % 20:02d}", float(i % 11)) for i in range(400)]

    def run(pkg):
        totals, scores = [], []
        flow = pkg["Dataflow"]("evict_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=20))
        pkg["op"].output("totals", pkg["xla"].stats_final("stats", s), pkg["Sink"](totals))
        z = pkg["op"].stateful_map("z", s, pkg["xla"].zscore(2.0))
        pkg["op"].output("scores", z, pkg["Sink"](scores))
        pkg["run_main"](flow, epoch_interval=timedelta(0))
        return sorted(totals), sorted(scores)

    built = _states_built(monkeypatch)
    spilled = port_flight.RECORDER.counters.get("state_spill_bytes", 0)
    port = run(PORT)
    assert [type(s).__name__ for s in built] == ["ShardedAggState"]
    if path == "residency":
        assert port_flight.RECORDER.counters.get("state_spill_bytes", 0) > spilled
    else:
        assert any(e["kind"] == "demotion" for e in port_flight.RECORDER.tail())
    ref = run(REF)
    assert port[0] == ref[0]
    assert [(k, v, a) for k, (v, _z, a) in port[1]] == [(k, v, a) for k, (v, _z, a) in ref[1]]
    np.testing.assert_allclose([z for _k, (_v, z, _a) in port[1]], [z for _k, (_v, z, _a) in ref[1]], atol=1e-4)


def test_sharded_window_resume_from_the_jax_package(tmp_path, monkeypatch):
    # A tumbling stats_window aborted on the JAX package's sharded tier
    # resumes on the port's (paged window install into a sharded fold
    # table), and the output equals an uninterrupted run of each.
    align = datetime(2022, 1, 1, tzinfo=timezone.utc)
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "8")

    def build(pkg, out, abort):
        xla = pkg["xla"]
        rows = [
            (f"s{i % 4}", xla.TsValue(float(i % 7), align + timedelta(seconds=5 * i)))
            for i in range(120)
        ]
        if abort is not None:
            rows = rows[:60] + [abort] + rows[60:]
        win = pkg["win"]
        clock = win.EventClock(ts_getter=xla.column_ts, wait_for_system_duration=timedelta(seconds=5))
        windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
        flow = pkg["Dataflow"]("win")
        s = pkg["op"].input("inp", flow, pkg["Source"](rows, batch_size=10))
        pkg["op"].output("out", win.stats_window("w", s, clock, windower).down, pkg["Sink"](out))
        return flow

    db = tmp_path / "db"
    db.mkdir()
    ref_init_db_dir(db, 1)
    abort = RefSource.ABORT()
    first, resumed = [], []
    ref_run_main(build(REF, first, abort), epoch_interval=timedelta(0), recovery_config=RefRecoveryConfig(str(db)))
    spent = PortSource.ABORT()
    spent._triggered = True
    built = _states_built(monkeypatch)
    port_run_main(build(PORT, resumed, spent), epoch_interval=timedelta(0), recovery_config=PortRecoveryConfig(str(db)))
    assert [type(s).__name__ for s in built] == ["ShardedAggState"]
    whole_ref, whole_port = [], []
    ref_run_main(build(REF, whole_ref, None))
    port_run_main(build(PORT, whole_port, None))
    assert sorted(first + resumed) == sorted(whole_ref) == sorted(whole_port)


# -- the scan state --------------------------------------------------------------


def _scan_states(pkg, kind_of, **kw):
    """``(sharded, single-device)`` scan states of one package."""
    if pkg is REF:
        return (
            ref_ss.ShardedScanState(kind_of(ref_scan), ref_make_mesh(N_SHARDS), **kw),
            ref_sa.DeviceScanState(kind_of(ref_scan)),
        )
    return (
        port_ss.ShardedScanState(kind_of(port_scan), port_make_mesh(N_SHARDS), **kw),
        port_sa.DeviceScanState(kind_of(port_scan)),
    )


def _zscore(scan):
    return scan.WelfordZScore(2.0)


def test_sharded_scan_matches_single_device(ref_mesh):
    rng = np.random.RandomState(17)
    n = 500
    keys = np.array([f"k{j}" for j in rng.randint(0, 13, size=n)])
    vals = rng.randn(n).round(3)
    all_keys = sorted(set(keys.tolist()))
    port_sh, port_sd = _scan_states(PORT, _zscore)
    ref_sh, _ref_sd = _scan_states(REF, _zscore)
    emits = {}
    for name, st in (("port", port_sh), ("single", port_sd), ("ref", ref_sh)):
        touched, emit = st.update(keys, vals)
        emits[name] = (sorted(touched), emit, dict(st.snapshots_for(all_keys)))
    got_t, got, got_snaps = emits["port"]
    for other in ("single", "ref"):
        want_t, want, want_snaps = emits[other]
        assert got_t == want_t
        np.testing.assert_allclose(got.outs[0], want.outs[0], atol=1e-3)
        np.testing.assert_array_equal(got.outs[1], want.outs[1])
        for k in all_keys:
            (c1, m1, v1), (c2, m2, v2) = got_snaps[k], want_snaps[k]
            assert c1 == c2
            assert m1 == pytest.approx(m2, abs=1e-4)
            assert v1 == pytest.approx(v2, abs=1e-3)


def test_sharded_scan_multi_batch_and_growth(ref_mesh):
    # cap_per_shard=4 forces at least one doubling with 80 keys over 8
    # shards; every batch's per-key emission matches the host mapper
    # and the JAX package's sharded scan.
    rng = np.random.RandomState(23)
    port = port_ss.ShardedScanState(port_scan.WelfordZScore(2.5), port_make_mesh(N_SHARDS), cap_per_shard=4)
    ref = ref_ss.ShardedScanState(ref_scan.WelfordZScore(2.5), ref_mesh, cap_per_shard=4)
    mapper = port_xla.zscore(2.5)
    states, want = {}, collections.defaultdict(list)
    for _b in range(3):
        n = 200
        keys = np.array([f"g{j}" for j in rng.randint(0, 80, size=n)])
        vals = rng.randn(n).round(3)
        _t, emit = port.update(keys, vals)
        _t, ref_emit = ref.update(keys, vals)
        # The oracle's bar below (f32 against f64; large |z| is
        # relatively, not absolutely, accurate).
        np.testing.assert_allclose(emit.outs[0], ref_emit.outs[0], rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(emit.outs[1], ref_emit.outs[1])
        got = collections.defaultdict(list)
        for k, (v, z, a) in emit.items():
            got[k].append((v, z, a))
        for k, v in zip(keys.tolist(), vals.tolist()):
            s2, (vv, z, a) = mapper(states.get(k), v)
            states[k] = s2
            want[k].append((vv, z, a))
        for k, rows in got.items():
            for (gv, gz, ga), (wv, wz, wa) in zip(rows, want[k][-len(rows) :]):
                assert gv == pytest.approx(wv)
                assert gz == pytest.approx(wz, rel=1e-3, abs=1e-3)
                assert ga == wa
    assert port.cap_per_shard == ref.cap_per_shard > 4


def test_sharded_scan_resume_from_device_snapshot(ref_mesh):
    # The JAX package's single-device snapshots resume into the port's
    # sharded scan (and the JAX package's sharded one), and the port's
    # sharded snapshots back into a single-device table.
    sd = ref_sa.DeviceScanState(ref_scan.WelfordZScore(2.0))
    sd.update(np.array(["a", "a", "b"]), np.array([1.0, 2.0, 10.0]))
    snaps = sd.snapshots_for(["a", "b"])
    port = port_ss.ShardedScanState(port_scan.WelfordZScore(2.0), port_make_mesh(N_SHARDS))
    ref = ref_ss.ShardedScanState(ref_scan.WelfordZScore(2.0), ref_mesh)
    emits = []
    for st in (port, ref):
        st.load_many(snaps)
        emits.append(st.update(np.array(["a"]), np.array([3.0]))[1])
    _s, (_v, z, a) = port_xla.zscore(2.0)((2, 1.5, 0.5), 3.0)
    assert emits[0].outs[0][0] == pytest.approx(z, abs=1e-4)
    assert emits[0].outs[0][0] == pytest.approx(emits[1].outs[0][0], abs=1e-6)
    assert bool(emits[0].outs[1][0]) == a
    back = port_sa.DeviceScanState(port_scan.WelfordZScore(2.0))
    back.load_many(port.snapshots_for(["a", "b"]))
    assert dict(back.snapshots_for(["a", "b"])) == dict(ref.snapshots_for(["a", "b"]))
    assert dict(back.snapshots_for(["a"]))["a"][0] == 3


def test_make_scan_state_selection(monkeypatch):
    for name, pkg in BOTH.items():
        kind = pkg["scan"].WelfordZScore(2.0)
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
        assert isinstance(pkg["ss"].make_scan_state(kind), pkg["sa"].DeviceScanState), name
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "auto")
        assert isinstance(pkg["ss"].make_scan_state(kind), pkg["ss"].ShardedScanState), name


@pytest.mark.parametrize("kind_name", ["ema", "extrema"])
def test_sharded_scan_generic_kinds_match_single_device(kind_name, ref_mesh):
    def kind_of(scan):
        return scan.Ema(0.3) if kind_name == "ema" else scan.RunningExtrema()

    rng = np.random.RandomState(31)
    n = 300
    keys = np.array([f"k{j}" for j in rng.randint(0, 11, size=n)])
    vals = rng.randn(n).round(3)
    all_keys = sorted(set(keys.tolist()))
    port_sh, port_sd = _scan_states(PORT, kind_of)
    ref_sh, _ = _scan_states(REF, kind_of)
    runs = []
    for st in (port_sh, port_sd, ref_sh):
        touched, emit = st.update(keys, vals)
        runs.append((sorted(touched), emit, st.snapshots_for(all_keys)))
    got_t, got, got_snaps = runs[0]
    for want_t, want, want_snaps in runs[1:]:
        assert got_t == want_t
        assert len(got.outs) == len(want.outs)
        for o1, o2 in zip(got.outs, want.outs):
            np.testing.assert_allclose(o1, o2, atol=1e-4)
        for (k1, s1), (k2, s2) in zip(got_snaps, want_snaps):
            assert k1 == k2
            np.testing.assert_allclose(s1, s2, rtol=1e-4, atol=1e-5)


# -- keyed_all_to_all (tests/test_xla.py) -----------------------------------------


def _all_to_all_both(ref_mesh, port_mesh, capacity, shard_ids, values):
    n = len(shard_ids)
    valid = np.ones(n, dtype=bool)
    ref = ref_exchange.keyed_all_to_all(
        ref_mesh, capacity, jnp.asarray(shard_ids), jnp.asarray(values), jnp.asarray(valid)
    )

    def blocks(arr):
        return list(torch.from_numpy(arr).view(N_SHARDS, -1).unbind(0))

    port = port_exchange.keyed_all_to_all(
        port_mesh, capacity, blocks(shard_ids), blocks(values), blocks(valid)
    )
    got = np.asarray(ref[0]).reshape(N_SHARDS, -1)
    mask = np.asarray(ref[1]).reshape(N_SHARDS, -1)
    for d in range(N_SHARDS):
        np.testing.assert_array_equal(port[0][d].numpy(), got[d])
        np.testing.assert_array_equal(port[1][d].numpy(), mask[d])
        assert int(port[2][d]) == int(ref[2])
    return port


def test_keyed_all_to_all_mesh(ref_mesh, port_mesh):
    n = 64  # 8 rows per source block
    rng = np.random.RandomState(0)
    shard_ids = rng.randint(0, 8, size=n).astype(np.int32)
    values = np.arange(n, dtype=np.float32)
    got, mask, dropped = _all_to_all_both(ref_mesh, port_mesh, 16, shard_ids, values)
    assert int(dropped[0]) == 0
    for d in range(N_SHARDS):
        assert sorted(got[d][mask[d]].tolist()) == sorted(values[shard_ids == d].tolist())


def test_keyed_all_to_all_reports_drops(ref_mesh, port_mesh):
    n = 64
    shard_ids = np.zeros(n, dtype=np.int32)
    values = np.arange(n, dtype=np.float32)
    _got, mask, dropped = _all_to_all_both(ref_mesh, port_mesh, 4, shard_ids, values)
    # 8 rows per source block, capacity 4 -> 4 dropped per source.
    assert int(dropped[0]) == 32
    assert sum(int(m.sum()) for m in mask) == 32


# -- bucket_by_shard directly ------------------------------------------------------


@pytest.mark.parametrize("case", ["uniform", "skewed", "all_padding", "over_capacity"])
def test_bucket_by_shard_matches_the_jax_package(case):
    rng = np.random.RandomState(5)
    n = 4096
    shard_ids = rng.randint(0, N_SHARDS, size=n).astype(np.int32)
    if case == "skewed":
        shard_ids[rng.rand(n) < 0.9] = 3
    values = rng.randn(n, 2).astype(np.float32)
    valid = rng.rand(n) < 0.8
    if case == "all_padding":
        valid[:] = False
    top = max(1, int(np.bincount(shard_ids[valid], minlength=N_SHARDS).max()))
    capacity = top // 2 if case == "over_capacity" else top
    ref = ref_exchange.bucket_by_shard(
        jnp.asarray(shard_ids), jnp.asarray(values), jnp.asarray(valid), N_SHARDS, capacity
    )
    port = port_exchange.bucket_by_shard(
        torch.from_numpy(shard_ids), torch.from_numpy(values), torch.from_numpy(valid), N_SHARDS, capacity
    )
    for p, r in zip(port, ref):
        assert p.shape == np.asarray(r).shape
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert (int(port[2]) > 0) == (case == "over_capacity")


def test_bucket_blocks_position_and_decode_lanes():
    # The lanes the sharded steps ask for: lane 0 decoded to the local
    # slot (key // n_shards), empty positions on the scratch slot, and
    # the position lane (row index over all blocks; empty: the row
    # count).
    keys = torch.tensor([[9, 2, 17, 4], [1, 10, 26, 3]], dtype=torch.int32)
    vals = torch.arange(8, dtype=torch.int32).view(2, 4)
    valid = torch.tensor([[True, True, True, False], [True, True, True, True]])
    out, counts, dropped = port_exchange.bucket_blocks(
        [keys, vals], 8, 2, valid=valid, flags=port_exchange.DECODE | port_exchange.POS, pad0=99, pos_pad=8
    )
    assert counts.tolist() == [[0, 2, 1, 0, 0, 0, 0, 0], [0, 1, 2, 1, 0, 0, 0, 0]]
    assert dropped.tolist() == [0, 0]
    # Shard 1 from block 0: keys 9, 17 (slots 1, 2, rows 0, 2); from
    # block 1: key 1 (slot 0, row 4), then an empty position.
    assert out[:, 1].tolist() == [[[1, 2], [0, 99]], [[0, 2], [4, 0]], [[0, 2], [4, 8]]]


def test_exchange_over_a_run_per_shard_matches_one_run():
    # A mesh whose shards all lie on distinct devices buckets each
    # source block with its own call and copies every destination's
    # slices together; on the CPU the devices are one, so a mesh that
    # reports a run per shard takes that path and must give what one
    # call over all blocks gives.
    from bytewax_tpu_torch.parallel.mesh import Mesh

    class RunPerShard(Mesh):
        def runs(self):
            return [range(d, d + 1) for d in range(len(self.devices))]

    rng = np.random.RandomState(6)
    rows = 512
    keys = list(torch.from_numpy(rng.randint(0, 5000, size=8 * rows).astype(np.int32)).view(8, rows).unbind(0))
    vals = list(torch.from_numpy(rng.randint(0, 1 << 30, size=8 * rows).astype(np.int32)).view(8, rows).unbind(0))
    valid = list(torch.from_numpy(rng.rand(8 * rows) < 0.9).view(8, rows).unbind(0))
    flags = port_exchange.DECODE | port_exchange.POS
    got = [
        port_exchange.exchange_rows(mesh, 128, [keys, vals], valid=valid, flags=flags, pad0=99)
        for mesh in (Mesh([torch.device("cpu")] * 8), RunPerShard([torch.device("cpu")] * 8))
    ]
    (recv_a, counts_a, drop_a), (recv_b, counts_b, drop_b) = got
    assert len(recv_a) == len(recv_b) == 8
    for a, b in zip(recv_a, recv_b):
        assert torch.equal(a, b)
    assert torch.equal(counts_a, counts_b) and counts_a.shape == (8, 8)
    assert torch.equal(drop_a, drop_b) and int(drop_a.sum()) == 0


# -- a 2-process cluster, each process on a 4-shard mesh ----------------------------


class _OwnVocabPart(StatelessSourcePartition):
    def __init__(self, batches):
        self._it = iter(batches)

    def next_batch(self):
        return next(self._it)


class _OwnVocabSource(DynamicSource):
    """Each worker numbers the same stations in its own order: worker
    w's vocabulary is the stations rotated by 7·w."""

    def __init__(self, stations, rows):
        self._stations = stations
        self._rows = rows  # worker -> [(station index, value), ...] batches

    def build(self, step_id, worker_index, worker_count):
        order = np.roll(np.arange(len(self._stations)), 7 * worker_index)
        vocab = self._stations[order]
        pos = np.argsort(order)  # station index -> this worker's id
        return _OwnVocabPart(
            [
                PortBatch({"key_id": pos[idx].astype(np.int32), "value": vals}, key_vocab=vocab)
                for idx, vals in self._rows[worker_index]
            ]
        )


def test_two_process_cluster_shards_each_process_and_keeps_peer_vocabularies(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "4")
    stations = np.array([f"st{i:02d}" for i in range(40)])
    rng = np.random.RandomState(8)
    rows = {
        w: [(rng.randint(0, 40, size=300), rng.randint(-50, 50, size=300) * 0.5) for _ in range(3)]
        for w in (0, 1)
    }
    want = collections.defaultdict(list)
    for batches in rows.values():
        for idx, vals in batches:
            for i, v in zip(idx.tolist(), vals.tolist()):
                want[str(stations[i])].append(v)
    built = _states_built(monkeypatch)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    addrs = [f"127.0.0.1:{port}" for port in ports]
    outs, errors = ([], []), []

    def run(proc_id):
        try:
            flow = PortDataflow("peers")
            s = port_op.input("inp", flow, _OwnVocabSource(stations, rows))
            port_op.output("out", port_xla.stats_final("stats", s), PortSink(outs[proc_id]))
            port_cluster_main(flow, addrs, proc_id)
        except BaseException as ex:  # noqa: BLE001
            errors.append((proc_id, ex))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "the 2-process mesh hung"
    assert not errors, errors
    assert [(type(s).__name__, s.n_shards) for s in built] == [("ShardedAggState", 4)] * 2
    got = dict(outs[0] + outs[1])
    assert len(got) == len(outs[0]) + len(outs[1]) == len(want)
    for key, vals in want.items():
        mn, mean, mx, count = got[key]
        assert (mn, mx, count) == (min(vals), max(vals), len(vals)), key
        assert mean == pytest.approx(sum(vals) / len(vals), rel=1e-6), key
