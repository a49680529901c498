"""Asynchronous incremental checkpoints through the torch port, held to
the JAX package.

The cases of ``tests/test_ckpt.py`` run through the port, all but the
two-process cluster case (it waits for the port's multi-process
cluster): delta and async commits against the synchronous checkpointer
and a running-sum oracle under the three entry points, crashes at the
``snapshot_seal`` site and on the committer lane replayed exactly once,
the fault plan's random soak, latest-row-wins across cold keys,
compaction, recovery through the residency tiers under a state budget,
rescale of an uncompacted delta chain, the ``/status`` and
``/healthz`` checkpoint payloads, and the rescale hint.

Then the device tier through both packages (the JAX package on its
single-device slot table, ``BYTEWAX_TPU_SHARD=0``): delta and async
commits with an abort and a resume, and a crash at the seal and on the
committer lane under the in-process supervisor, for each of the three
device state classes (``stats_final``, ``xla.zscore``,
``stats_window``).  ``FileSink`` truncates to its snapshotted offset on
resume, so its file shows any replay.  The port's file must equal the
JAX package's and the port's own synchronous, uninterrupted run: counts,
keys, min and max exactly, means within ``rtol=atol=1e-5``, z within
``1e-4``.  Faults go through each engine's own injector only.
"""

import ast
import os
import pickle
import sqlite3
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as port_win
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.connectors.files import FileSink as RefFileSink
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import faults as ref_faults
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.connectors.files import FileSink as PortFileSink
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine import faults, flight
from bytewax_tpu_torch.engine.driver import derive_rescale_hint
from bytewax_tpu_torch.engine.recovery_store import (
    RecoveryStore,
    route_of,
)
from bytewax_tpu_torch.recovery import RecoveryConfig, init_db_dir
from bytewax_tpu_torch.testing import TestingSink, TestingSource, cluster_main, run_main
from bytewax_tpu_torch.utils import force_platform
from tests.torch_device_flows import (
    DEVICE_KINDS,
    assert_device_out,
    device_flow,
    device_items,
    device_tier,
)

ZERO_TD = timedelta(seconds=0)
RETAIN_TD = timedelta(hours=1)  # delay GC: retain every snaps row

REF = {
    "op": ref_op,
    "win": ref_win,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "FileSink": RefFileSink,
    "run_main": ref_run_main,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
}
PORT = {
    "op": op,
    "win": port_win,
    "xla": xla,
    "Dataflow": Dataflow,
    "Source": TestingSource,
    "FileSink": PortFileSink,
    "run_main": run_main,
    "RecoveryConfig": RecoveryConfig,
    "init_db_dir": init_db_dir,
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
def _single_device(monkeypatch):
    """The JAX package on its single-device slot table, the tier the
    port has."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")


def _cluster_main1x2(*args, **kwargs):
    return cluster_main(*args, [], 0, worker_count_per_proc=2, **kwargs)


def _cluster_main1x1(*args, **kwargs):
    return cluster_main(*args, [], 0, **kwargs)


@pytest.fixture(params=["run_main", "cluster_main-1thread", "cluster_main-2thread"])
def entry_point(request):
    """The port's three entry points, as ``tests/conftest.py`` gives
    the reference's."""
    return {
        "run_main": run_main,
        "cluster_main-1thread": _cluster_main1x1,
        "cluster_main-2thread": _cluster_main1x2,
    }[request.param]


@pytest.fixture
def recovery_config(tmp_path):
    """A recovery config pointing at a 1-partition port store."""
    init_db_dir(tmp_path, 1)
    yield RecoveryConfig(str(tmp_path))


@pytest.fixture(autouse=True)
def _fresh_fault_plan():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
def _ckpt_env(monkeypatch, async_=True, delta=True, compact=None):
    if async_:
        monkeypatch.setenv("BYTEWAX_TPU_CKPT_ASYNC", "1")
    else:
        monkeypatch.delenv("BYTEWAX_TPU_CKPT_ASYNC", raising=False)
    if delta:
        monkeypatch.setenv("BYTEWAX_TPU_CKPT_DELTA", "1")
    else:
        monkeypatch.delenv("BYTEWAX_TPU_CKPT_DELTA", raising=False)
    if compact is not None:
        monkeypatch.setenv(
            "BYTEWAX_TPU_CKPT_COMPACT_EVERY", str(compact)
        )
    else:
        monkeypatch.delenv(
            "BYTEWAX_TPU_CKPT_COMPACT_EVERY", raising=False
        )


def _file_flow(inp, out_path):
    from bytewax_tpu_torch.connectors.files import FileSink

    flow = Dataflow("ckpt_df")
    s = op.input("inp", flow, TestingSource(inp))
    s = op.stateful_map(
        "sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v)
    )
    s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    op.output("out", s, FileSink(out_path))
    return flow


def _running_sum_oracle(inp):
    sums, want = {}, []
    for k, v in inp:
        sums[k] = sums.get(k, 0) + v
        want.append(f"{k}={sums[k]}")
    return sorted(want)


def _mk_db(tmp_path, name):
    db = tmp_path / name
    db.mkdir()
    init_db_dir(db, 1)
    return db


def _snaps_rows(db):
    rows = []
    for part in sorted(Path(db).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        try:
            rows += con.execute(
                "SELECT step_id, state_key, epoch, route, ser_change"
                " FROM snaps"
            ).fetchall()
        finally:
            con.close()
    return rows


# -- async + delta vs the synchronous oracle ---------------------------


def test_async_delta_matches_sync_oracle_and_drains_clean(
    entry_point, tmp_path, monkeypatch
):
    """With both knobs on, a fault-free run emits exactly the
    synchronous engine's output, the run-ending close fences the
    committer lane (clean exit = fully durable), and a resume
    replays zero epochs."""
    _ckpt_env(monkeypatch, async_=True, delta=True, compact=3)
    inp = [(f"k{i % 3}", i) for i in range(12)]
    out_path = tmp_path / "out.txt"
    db = _mk_db(tmp_path, "db")
    entry_point(
        _file_flow(inp, str(out_path)),
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert sorted(out_path.read_text().split()) == _running_sum_oracle(
        inp
    )
    # Durability bookkeeping landed at lag 0: the final fence
    # committed the last sealed epoch before teardown.
    assert flight.RECORDER.counters.get("snapshot_lag_epochs") == 0
    from bytewax_tpu_torch._metrics import snapshot_lag_epochs

    assert (
        next(iter(snapshot_lag_epochs.collect())).samples[0].value == 0
    )
    # Clean exit replays ZERO epochs: resume appends nothing.
    entry_point(
        _file_flow(inp, str(out_path)),
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert sorted(out_path.read_text().split()) == _running_sum_oracle(
        inp
    )


# -- crash in the seal→commit window, all three entry points -----------


def test_seal_crash_replays_exactly_once(
    entry_point, tmp_path, monkeypatch
):
    """An injected crash at the pinned ``snapshot_seal`` site — the
    delta is sealed in memory, nothing durable has happened, and the
    PREVIOUS epoch's async commit may still be in flight — unwinds
    restartable.  Resume replays at most the sealed epoch plus the
    one unfenced commit, and the sink truncates to its snapshotted
    offset, so the final output is exactly-once vs the host oracle."""
    _ckpt_env(monkeypatch, async_=True, delta=True)
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "snapshot_seal:crash:3:x1")
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    inp = [(f"k{i % 3}", i) for i in range(12)]
    out_path = tmp_path / "out.txt"
    db = _mk_db(tmp_path, "db")
    restarts_before = flight.RECORDER.counters.get(
        "worker_restart_count", 0
    )
    entry_point(
        _file_flow(inp, str(out_path)),
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert (
        flight.RECORDER.counters.get("worker_restart_count", 0)
        == restarts_before + 1
    )
    assert sorted(out_path.read_text().split()) == _running_sum_oracle(
        inp
    )


def test_committer_lane_crash_replays_exactly_once(
    entry_point, tmp_path, monkeypatch
):
    """With async on, the store's ``snapshot.commit`` site fires on
    the committer lane's worker thread; the injected crash surfaces
    at the next fence, the write transaction rolls back whole, and
    the supervised resume replays that epoch exactly-once."""
    _ckpt_env(monkeypatch, async_=True, delta=True)
    monkeypatch.setenv(
        "BYTEWAX_TPU_FAULTS", "snapshot.commit:crash:3:x1"
    )
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    inp = [(f"k{i % 3}", i) for i in range(12)]
    out_path = tmp_path / "out.txt"
    db = _mk_db(tmp_path, "db")
    entry_point(
        _file_flow(inp, str(out_path)),
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert sorted(out_path.read_text().split()) == _running_sum_oracle(
        inp
    )


def test_random_soak_snapshot_seal_site(monkeypatch):
    """The new site participates in the seeded random soak and the
    ``BYTEWAX_TPU_FAULTS_SITES`` restriction, like every other."""
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "random")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_SITES", "snapshot_seal")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_KINDS", "crash")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_RATE", "1.0")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS_MIN_GAP_S", "0")
    faults.reset()
    faults.configure(0)
    # Filtered-out sites never fire...
    assert faults.fire("comm.send") is None
    assert faults.fire("snapshot.commit") is None
    # ...the selected seal site crashes.
    with pytest.raises(faults.InjectedCrash):
        faults.fire("snapshot_seal")


# -- delta rows: latest-row-wins, fewer writes, compaction -------------


def test_delta_latest_row_wins_across_cold_keys(
    tmp_path, monkeypatch
):
    """A key untouched for many epochs keeps only its old row under
    delta mode; resume reconstitutes it from that row (latest-row-
    per-key) while hot keys resume from their newest.  Under a
    retain-everything store the delta run writes strictly fewer
    snaps rows than the full-snapshot run of the same flow."""
    # "cold" is touched once up front; "hot" every delivery after.
    head = [("cold", 5)] + [("hot", i) for i in range(8)]
    tail = [("cold", 7), ("hot", 100)]
    oracle = _running_sum_oracle(head + tail)

    rows = {}
    for mode in ("delta", "full"):
        # Fresh ABORT per mode: the sentinel is single-use.
        inp = head + [TestingSource.ABORT()] + tail
        _ckpt_env(monkeypatch, async_=False, delta=(mode == "delta"))
        db = _mk_db(tmp_path, f"db_{mode}")
        cfg = RecoveryConfig(str(db), backup_interval=RETAIN_TD)
        out_path = tmp_path / f"out_{mode}.txt"
        # FileSink truncates to the snapshotted offset on resume, so
        # the abort/replay pair is exactly-once at the sink.
        run_main(
            _file_flow(inp, str(out_path)),
            epoch_interval=ZERO_TD,
            recovery_config=cfg,
        )
        run_main(
            _file_flow(inp, str(out_path)),
            epoch_interval=ZERO_TD,
            recovery_config=cfg,
        )
        rows[mode] = _snaps_rows(db)
        # Resume semantics identical to the full-snapshot engine —
        # including cold=12 (5 from the pre-abort row plus the
        # replayed 7, reconstituted latest-row-per-key).
        assert sorted(out_path.read_text().split()) == oracle
    # The delta store skipped the unchanged-key rewrites.
    assert len(rows["delta"]) < len(rows["full"])
    # ...and the cold key's chain stays short: one row per epoch it
    # actually changed in (plus at most a replayed rewrite).
    cold_epochs = {
        e
        for (_s, k, e, _r, b) in rows["delta"]
        if k == "cold" and b is not None
    }
    assert len(cold_epochs) <= 3


def test_compaction_bounds_retained_delta_chain(
    tmp_path, monkeypatch
):
    """BYTEWAX_TPU_CKPT_COMPACT_EVERY forces a commit/GC watermark
    every K closes even under a retain-everything backup interval:
    resume state is identical, the chain is strictly shorter."""
    head = [("hot", i) for i in range(10)]
    tail = [("hot", 100)]
    oracle = _running_sum_oracle(head + tail)
    rows = {}
    for mode, compact in (("plain", None), ("compact", 2)):
        # Fresh ABORT per mode: the sentinel is single-use.
        inp = head + [TestingSource.ABORT()] + tail
        _ckpt_env(
            monkeypatch, async_=False, delta=True, compact=compact
        )
        db = _mk_db(tmp_path, f"db_{mode}")
        cfg = RecoveryConfig(str(db), backup_interval=RETAIN_TD)
        out_path = tmp_path / f"out_{mode}.txt"
        run_main(
            _file_flow(inp, str(out_path)),
            epoch_interval=ZERO_TD,
            recovery_config=cfg,
        )
        run_main(
            _file_flow(inp, str(out_path)),
            epoch_interval=ZERO_TD,
            recovery_config=cfg,
        )
        rows[mode] = _snaps_rows(db)
        assert sorted(out_path.read_text().split()) == oracle
    assert len(rows["compact"]) < len(rows["plain"])


def test_cross_tier_recovery_with_state_budget(
    recovery_config, tmp_path, monkeypatch
):
    """Delta+async checkpoints read through the residency manager
    like the synchronous path: a budgeted device-tier run whose keys
    are evicted/spilled at the abort resumes to the exact host
    oracle."""
    _ckpt_env(monkeypatch, async_=True, delta=True, compact=3)
    monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "2")
    monkeypatch.setenv("BYTEWAX_TPU_HOST_STATE_BUDGET", "3")
    monkeypatch.setenv(
        "BYTEWAX_TPU_SPILL_DIR", str(tmp_path / "spill")
    )
    head = [(f"k{(i * 7) % 12:02d}", i) for i in range(60)]
    tail = [(f"k{(i * 5) % 12:02d}", i) for i in range(24)]
    inp = head + [TestingSource.ABORT()] + tail
    flow_id = "ckpt_res"

    def build(out):
        flow = Dataflow(flow_id)
        s = op.input("inp", flow, TestingSource(inp, batch_size=2))
        r = op.reduce_final("sum", s, xla.SUM)
        op.output("out", r, TestingSink(out))
        return flow

    out = []
    run_main(
        build(out),
        epoch_interval=ZERO_TD,
        recovery_config=recovery_config,
    )
    assert out == []  # reduce_final emits at EOF only
    out2 = []
    run_main(
        build(out2),
        epoch_interval=ZERO_TD,
        recovery_config=recovery_config,
    )
    sums = {}
    for k, v in head + tail:
        sums[k] = sums.get(k, 0) + v
    assert sorted(out2) == sorted(sums.items())


def test_rescale_migrates_uncompacted_delta_chain(tmp_path):
    """`rescale_snaps_rows` re-stamps EVERY row of an uncompacted
    delta chain — a cold key's single old row and a hot key's whole
    epoch chain — and route-scoped latest-per-key reads stay a
    disjoint exact cover under the new modulus."""
    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 2, 1)
    # Epoch 1 writes everything; epochs 2-4 are delta closes that
    # touch only the hot keys.  commit_epoch=None retains the chain.
    hot = [f"hot{i:02d}" for i in range(8)]
    cold = [f"cold{i:02d}" for i in range(8)]
    store.write_epoch(
        0,
        2,
        1,
        [("df.s", k, pickle.dumps(0)) for k in hot + cold],
        None,
    )
    for epoch in (2, 3, 4):
        store.write_epoch(
            0,
            2,
            epoch,
            [("df.s", k, pickle.dumps(epoch)) for k in hot],
            None,
        )
    migrated = store.rescale(3, ex_num=0)
    assert migrated == len(hot) + len(cold)
    for part in sorted(Path(tmp_path).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        try:
            for key, route in con.execute(
                "SELECT state_key, route FROM snaps"
            ):
                assert route == route_of(key, 3)
        finally:
            con.close()
    # Latest-per-key under the new routing: hot keys read epoch 4,
    # cold keys their epoch-1 row; the per-lane reads are a disjoint
    # exact cover.
    by_lane = {
        w: {
            k: pickle.loads(b)
            for _s, k, b in store.iter_snaps(5, routes=[w])
        }
        for w in range(3)
    }
    merged = {}
    for lane in by_lane.values():
        for k in lane:
            assert k not in merged, f"key {k} read by two lanes"
        merged.update(lane)
    assert merged == dict(
        {k: 4 for k in hot}, **{k: 0 for k in cold}
    )
    assert store.resume_from(worker_count=3).resume_epoch == 5
    store.close()


# -- observability: /status, /healthz, the hint ------------------------


def test_status_and_healthz_expose_committer_lane(
    tmp_path, monkeypatch
):
    """/status carries the checkpoint section (durable vs sealed
    epoch), /healthz stays green at lag <= 1 and degrades above —
    readiness drops with a distinct state while liveness holds."""
    from bytewax_tpu_torch.engine import driver as drv

    _ckpt_env(monkeypatch, async_=True, delta=True)
    seen = {}
    orig = drv._Driver._close_epoch

    def spy(self, workers=None):
        if "status" not in seen:
            seen["status"] = self._status()
            seen["health"] = self._health()
            # Force a lagging committer lane (payload builders only
            # — no engine behavior changes) and read /healthz again.
            sealed = self._ckpt_sealed_epoch
            self._ckpt_sealed_epoch = self._durable_epoch + 2
            seen["health_lagging"] = self._health()
            self._ckpt_sealed_epoch = sealed
        return orig(self, workers)

    monkeypatch.setattr(drv._Driver, "_close_epoch", spy)
    db = _mk_db(tmp_path, "db")
    out = []
    flow = Dataflow("ckpt_status_df")
    s = op.input("inp", flow, TestingSource([1, 2, 3]))
    op.output("out", s, TestingSink(out))
    run_main(
        flow,
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    ck = seen["status"]["checkpoint"]
    assert ck["async"] is True and ck["delta"] is True
    assert ck["lag_epochs"] <= 1
    assert ck["sealed_epoch"] - ck["durable_epoch"] == ck["lag_epochs"]
    health = seen["health"]
    assert health["ready"] is True
    assert health["snapshot_lag_epochs"] <= 1
    lagging = seen["health_lagging"]
    assert lagging["ready"] is False
    assert lagging["state"] == "checkpoint_lagging"
    assert lagging["snapshot_lag_epochs"] == 2


def test_rescale_hint_snapshot_stall_is_grow_and_blocks_shrink():
    """Fence stalls are durability pressure: loud ones are their own
    grow reason, and a non-quiet committer lane blocks shrink — so
    async checkpointing (which legitimately shrinks close p99) can
    never read as a shrink signal by itself."""
    advice, reasons = derive_rescale_hint(
        worker_count=2,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
        snapshot_stall_s_per_close=3.0,
    )
    assert advice == "grow"
    assert any("checkpoint durability" in r for r in reasons)
    # Not loud enough to grow, not quiet enough to shrink: hold.
    advice, _ = derive_rescale_hint(
        worker_count=4,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
        snapshot_stall_s_per_close=0.5,
    )
    assert advice == "hold"
    # A genuinely quiet lane leaves the shrink path untouched.
    advice, _ = derive_rescale_hint(
        worker_count=4,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
        snapshot_stall_s_per_close=0.0,
    )
    assert advice == "shrink"


# -- the device tier, held to the JAX package ---------------------------------


def _plain(x):
    """A row with numpy scalars turned into Python ones, so that its
    ``repr`` reads back with ``ast.literal_eval``."""
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return float(x)


def _device_file_flow(pkg, kind, inp, path):
    flow, s = device_flow(pkg, kind, inp, flow_id="ckpt_dev")
    s = pkg["op"].map("fmt", s, lambda kv: (kv[0], repr((kv[0], _plain(kv[1])))))
    pkg["op"].output("out", s, pkg["FileSink"](path))
    return flow


def _rows(path):
    return [ast.literal_eval(line) for line in Path(path).read_text().splitlines()]


def _device_run(pkg, kind, tmp_path, name, abort_at=None):
    """Run the device flow against a fresh store named ``name`` (with
    an ABORT sentinel at ``abort_at``, then a resume); returns the
    sink file's rows."""
    db = tmp_path / f"db_{name}"
    db.mkdir()
    pkg["init_db_dir"](db, 1)
    items = device_items(pkg, kind)
    if abort_at is not None:
        items = items[:abort_at] + [pkg["Source"].ABORT()] + items[abort_at:]
    path = tmp_path / f"out_{name}.txt"
    for _run in range(1 if abort_at is None else 2):
        pkg["run_main"](
            _device_file_flow(pkg, kind, items, str(path)),
            epoch_interval=ZERO_TD,
            recovery_config=pkg["RecoveryConfig"](str(db)),
        )
    return _rows(path)


@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_device_tier_async_delta_matches_sync_and_reference(tmp_path, monkeypatch, kind):
    """Delta and async commits with an abort and a resume on the device
    tier: the port's file equals the JAX package's under the same knobs
    and the port's own under the synchronous checkpointer, and the
    run-ending fence leaves no commit lagging."""
    device_tier(monkeypatch)
    _ckpt_env(monkeypatch, async_=True, delta=True, compact=3)
    got = {name: _device_run(pkg, kind, tmp_path, name, abort_at=130) for name, pkg in PKGS.items()}
    assert flight.RECORDER.counters.get("snapshot_lag_epochs") == 0
    _ckpt_env(monkeypatch, async_=False, delta=False)
    sync = _device_run(PORT, kind, tmp_path, "sync", abort_at=130)
    assert got["torch"]
    assert_device_out(kind, got["torch"], got["jax"])
    assert_device_out(kind, got["torch"], sync)


@pytest.mark.parametrize("site", ["snapshot_seal", "snapshot.commit"])
@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_device_tier_crash_replays_exactly_once(tmp_path, monkeypatch, kind, site):
    """A crash at the seal, or on the committer lane, of epoch 3 with
    delta and async commits on: the in-process supervisor restarts the
    run from the store, and the port's file equals the JAX package's
    under the same fault and the port's own run with no fault."""
    device_tier(monkeypatch)
    _ckpt_env(monkeypatch, async_=True, delta=True)
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    whole = _device_run(PORT, kind, tmp_path, "whole")
    monkeypatch.setenv("BYTEWAX_TPU_FAULTS", f"{site}:crash:3:x1")
    restarts = flight.RECORDER.counters.get("worker_restart_count", 0)
    got = {name: _device_run(pkg, kind, tmp_path, name) for name, pkg in PKGS.items()}
    assert flight.RECORDER.counters.get("worker_restart_count", 0) == restarts + 1
    assert_device_out(kind, got["torch"], got["jax"])
    assert_device_out(kind, got["torch"], whole)
