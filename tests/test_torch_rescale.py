"""Rescale on resume and live in-process reconfigure through the torch
port, held to the JAX package.

The cases of ``tests/test_rescale.py`` run through the port: the
worker-count gate, route rewrites and ``exs`` provenance, route-scoped
reads, whole rollback of a crashed migration, the delta-only migration,
the spill tier's shared row format, seeded restart backoff, the rescale
hint, resume at another lane count with keys in the spill tiers, live
reconfigure in one process (grow, shrink, refused without a store, a
crashed migration retried), a crashed resume migration retried under
the in-process supervisor, and (``slow``, as in the reference) real
clusters of 2 and 3 processes resized across a run with a crash in the
migration, and refused without the opt-in.

Then the device tier through both packages (the JAX package on its
single-device slot table, ``BYTEWAX_TPU_SHARD=0``): a run of the
in-process cluster aborted at one lane count and resumed with
``BYTEWAX_TPU_RESCALE=1`` at another, grow and shrink, for each of the
three device state classes (``stats_final``, ``xla.zscore``,
``stats_window``).  The port's output must equal the JAX package's and
the port's own uninterrupted run: counts, keys, min and max exactly,
means within ``rtol=atol=1e-5``, z within ``1e-4``.  Faults go through
the engine's own injector only.
"""

import os
import pickle
import random
import sqlite3
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as port_win
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import faults as ref_faults
from bytewax_tpu.engine.driver import cluster_main as ref_cluster_main
from bytewax_tpu.engine.driver import run_main as ref_run_main
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine import faults, flight
from bytewax_tpu_torch.engine.driver import (
    _backoff_delay,
    cluster_main,
    derive_rescale_hint,
    run_main,
)
from bytewax_tpu_torch.engine.recovery_store import (
    RecoveryStore,
    WorkerCountMismatchError,
    init_db_dir,
    rescale_snaps_rows,
    route_of,
)
from bytewax_tpu_torch.engine.residency import SpillStore
from bytewax_tpu_torch.recovery import RecoveryConfig
from bytewax_tpu_torch.testing import TestingSink, TestingSource
from bytewax_tpu_torch.utils import force_platform
from tests.torch_device_flows import (
    DEVICE_KINDS,
    assert_device_out,
    device_flow,
    device_items,
    device_tier,
    vm_steps,
)

ZERO_TD = timedelta(seconds=0)

REF = {
    "op": ref_op,
    "win": ref_win,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "cluster_main": ref_cluster_main,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
}
PORT = {
    "op": op,
    "win": port_win,
    "xla": xla,
    "Dataflow": Dataflow,
    "Source": TestingSource,
    "Sink": TestingSink,
    "run_main": run_main,
    "cluster_main": cluster_main,
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


@pytest.fixture(autouse=True)
def _fresh_fault_plan():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


# -- store-level: the mismatch gate ------------------------------------


def _seed_store(tmp_path, worker_count, keys=("a", "b", "c")):
    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, worker_count, 1)
    store.write_epoch(
        0,
        worker_count,
        1,
        [("df.s", k, pickle.dumps(ord(k[0]))) for k in keys],
        None,
    )
    return store


def test_resume_from_worker_count_gate(tmp_path):
    store = _seed_store(tmp_path, worker_count=2)
    # Equal counts and the legacy no-count call are untouched.
    assert store.resume_from(worker_count=2).stored_worker_counts == (2,)
    assert store.resume_from().resume_epoch == 2
    # A mismatch without the opt-in refuses with the typed error,
    # naming stored vs. actual and how to enable rescale.
    with pytest.raises(
        WorkerCountMismatchError,
        match=r"2 worker\(s\).*has 5.*--rescale.*BYTEWAX_TPU_RESCALE=1",
    ) as exc_info:
        store.resume_from(worker_count=5)
    assert exc_info.value.stored_counts == (2,)
    assert exc_info.value.actual_count == 5
    # With the opt-in, the stored counts ride back for the migration.
    resume = store.resume_from(worker_count=5, allow_rescale=True)
    assert resume.stored_worker_counts == (2,)
    assert (resume.ex_num, resume.resume_epoch) == (1, 2)
    store.close()


def test_rescale_rewrites_routes_and_exs_provenance(tmp_path):
    keys = [f"k{i:02d}" for i in range(40)]
    store = _seed_store(tmp_path, worker_count=2, keys=keys)
    migrated = store.rescale(3, ex_num=0)
    assert migrated == len(keys)
    for part in sorted(Path(tmp_path).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        for key, route in con.execute(
            "SELECT state_key, route FROM snaps"
        ):
            assert route == route_of(key, 3)
        for (count,) in con.execute("SELECT worker_count FROM exs"):
            assert count == 3
        con.close()
    # The provenance makes the migration durable: the store now
    # resumes at 3 workers without rescale, and refuses at 2.
    assert store.resume_from(worker_count=3).stored_worker_counts == (3,)
    with pytest.raises(WorkerCountMismatchError):
        store.resume_from(worker_count=2)
    store.close()


def test_rescale_route_scoped_reads_partition_the_state(tmp_path):
    # After migration to M workers, the per-lane route filters return
    # a disjoint cover of the keyed state — each resuming process
    # reads exactly its own keys.
    keys = [f"user-{i}" for i in range(64)]
    store = _seed_store(tmp_path, worker_count=2, keys=keys)
    store.rescale(3, ex_num=0)
    by_lane = {
        w: {k for _s, k, _b in store.iter_snaps(2, routes=[w])}
        for w in range(3)
    }
    assert set().union(*by_lane.values()) == set(keys)
    for w in range(3):
        assert by_lane[w] == {k for k in keys if route_of(k, 3) == w}
        for other in range(w + 1, 3):
            assert not (by_lane[w] & by_lane[other])
    store.close()


def test_rescale_mid_migration_crash_rolls_back_whole(
    tmp_path, monkeypatch
):
    # The pinned fault site fires inside the all-partition transaction
    # before any row moves: an injected crash leaves the store exactly
    # as it was (old routes, old exs provenance), and the retry —
    # what the supervisor does after re-entering run startup —
    # migrates cleanly.
    keys = [f"k{i:02d}" for i in range(10)]
    store = _seed_store(tmp_path, worker_count=2, keys=keys)
    monkeypatch.setenv(
        "BYTEWAX_TPU_FAULTS", "rescale_migrate:crash:*:x1"
    )
    faults.configure(0)
    with pytest.raises(faults.InjectedCrash):
        store.rescale(3, ex_num=0)
    for part in sorted(Path(tmp_path).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        for key, route in con.execute(
            "SELECT state_key, route FROM snaps"
        ):
            assert route == route_of(key, 2), "rollback was not whole"
        for (count,) in con.execute("SELECT worker_count FROM exs"):
            assert count == 2
        con.close()
    # The x1 spec is spent: the retry (same process, same plan — the
    # supervisor's restart semantics) succeeds and is idempotent.
    assert store.rescale(3, ex_num=0) == len(keys)
    assert store.rescale(3, ex_num=0) == len(keys)
    store.close()


# -- delta-only (partial) migration ------------------------------------


def test_rescale_partial_rewrites_only_moved_routes(tmp_path):
    # The live-rescale delta mode: a key whose home lane does not
    # change under the old→new modulus is NEVER touched — proven via
    # sqlite total_changes, not just the returned count.
    keys = [f"k{i:03d}" for i in range(200)]
    moved = [k for k in keys if route_of(k, 2) != route_of(k, 3)]
    unmoved = [k for k in keys if route_of(k, 2) == route_of(k, 3)]
    assert moved and unmoved  # the fixture really has both kinds
    init_db_dir(tmp_path, 1)
    con = sqlite3.connect(tmp_path / "part-0.sqlite3")
    con.executemany(
        "INSERT INTO snaps (step_id, state_key, epoch, ser_change, "
        "route) VALUES ('df.s', ?, 1, x'00', ?)",
        [(k, route_of(k, 2)) for k in keys],
    )
    before = con.total_changes
    assert (
        rescale_snaps_rows(con, 3, page_size=16, partial=True)
        == len(moved)
    )
    # Exactly the moved rows were written; unmoved rows never were.
    assert con.total_changes - before == len(moved)
    for key, route in con.execute(
        "SELECT state_key, route FROM snaps"
    ):
        assert route == route_of(key, 3)
    # Idempotent AND write-free on a store already at the new
    # modulus: the second pass touches nothing at all.
    before = con.total_changes
    assert rescale_snaps_rows(con, 3, page_size=16, partial=True) == 0
    assert con.total_changes == before
    # Full mode on the same store rewrites everything (the legacy
    # count), so the two modes stay interchangeable semantically.
    assert rescale_snaps_rows(con, 3, page_size=16) == len(keys)
    con.close()


def test_rescale_partial_heals_legacy_and_mixed_stamps(tmp_path):
    # Crash-healing: rows whose stamps are legacy (-1) or mixed
    # (a half-committed earlier migration) never compare equal to
    # the new route, so the delta pass always rewrites them — even
    # when the key's home lane did not move.
    keys = [f"u{i:02d}" for i in range(30)]
    init_db_dir(tmp_path, 1)
    con = sqlite3.connect(tmp_path / "part-0.sqlite3")
    for epoch in (1, 2):
        con.executemany(
            "INSERT INTO snaps (step_id, state_key, epoch, "
            "ser_change, route) VALUES ('df.s', ?, ?, x'00', ?)",
            [(k, epoch, route_of(k, 3)) for k in keys],
        )
    stale = keys[:7]
    con.executemany(
        "UPDATE snaps SET route = -1 WHERE state_key = ? AND epoch = 1",
        [(k,) for k in stale[:4]],
    )
    con.executemany(
        "UPDATE snaps SET route = 99 WHERE state_key = ? AND epoch = 2",
        [(k,) for k in stale[4:]],
    )
    # Already at the 3-lane modulus except the stale stamps: the
    # delta pass rewrites exactly those keys.
    assert (
        rescale_snaps_rows(con, 3, page_size=8, partial=True)
        == len(stale)
    )
    for key, route in con.execute(
        "SELECT state_key, route FROM snaps"
    ):
        assert route == route_of(key, 3)
    con.close()


def test_rescale_partial_crash_rolls_back_whole(
    tmp_path, monkeypatch
):
    # The pinned rescale_migrate site on the NEW delta path: an
    # injected crash inside the all-partition transaction leaves the
    # store exactly as it was, and the retry — the supervisor's
    # re-entry semantics — migrates the same delta cleanly.
    keys = [f"k{i:02d}" for i in range(40)]
    moved = [k for k in keys if route_of(k, 2) != route_of(k, 3)]
    store = _seed_store(tmp_path, worker_count=2, keys=keys)
    monkeypatch.setenv(
        "BYTEWAX_TPU_FAULTS", "rescale_migrate:crash:*:x1"
    )
    faults.configure(0)
    with pytest.raises(faults.InjectedCrash):
        store.rescale(3, ex_num=0, partial=True)
    for part in sorted(Path(tmp_path).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        for key, route in con.execute(
            "SELECT state_key, route FROM snaps"
        ):
            assert route == route_of(key, 2), "rollback was not whole"
        con.close()
    # The retry migrates exactly the delta; re-running it migrates
    # nothing (and the store is fully at the new modulus).
    assert store.rescale(3, ex_num=0, partial=True) == len(moved)
    assert store.rescale(3, ex_num=0, partial=True) == 0
    assert store.resume_from(worker_count=3).stored_worker_counts == (3,)
    store.close()


# -- row-format pin: recovery partitions and the spill tier ------------


def _table_shape(db_path):
    con = sqlite3.connect(db_path)
    info = [
        (name, ctype, notnull, pk)
        for _cid, name, ctype, notnull, _dflt, pk in con.execute(
            "PRAGMA table_info(snaps)"
        )
    ]
    con.close()
    return info


def test_spill_rows_share_snaps_format_and_migration(tmp_path):
    # The residency spill tier IS recovery-format rows: identical
    # column shape (route included), identical route stamping, and
    # the SAME migration routine applies.
    db = tmp_path / "db"
    db.mkdir()
    store = _seed_store(db, worker_count=2)
    store.close()
    spill = SpillStore(str(tmp_path / "spill"), "df.s", worker_count=2)
    spill.put_many(
        [(f"u{i}", float(i)) for i in range(20)], epoch=1
    )
    part = next(Path(db).glob("part-0.sqlite3"))
    assert _table_shape(part) == _table_shape(spill._path)
    con = sqlite3.connect(spill._path)
    for key, route in con.execute("SELECT state_key, route FROM snaps"):
        assert route == route_of(key, 2)
    con.close()
    # Shared migration routine, via the SpillStore surface.
    assert spill.rescale(5) == 20
    con = sqlite3.connect(spill._path)
    for key, route in con.execute("SELECT state_key, route FROM snaps"):
        assert route == route_of(key, 5)
    con.close()
    # And rescale_snaps_rows works directly on any snaps-format file.
    con = sqlite3.connect(spill._path)
    assert rescale_snaps_rows(con, 7) == 20
    con.close()
    # The delta-only mode rides the same shared routine (the raw
    # pass above was never committed — its connection closed without
    # one — so the store is still at the 5-lane modulus): already-at-
    # target rewrites nothing, a real move rewrites exactly the
    # changed-route keys.
    assert spill.rescale(5, partial=True) == 0
    spill_keys = [f"u{i}" for i in range(20)]
    spill_moved = [
        k for k in spill_keys if route_of(k, 7) != route_of(k, 5)
    ]
    assert spill.rescale(7, partial=True) == len(spill_moved)
    spill.close()


# -- supervisor backoff jitter ----------------------------------------


def test_restart_backoff_jitter_is_seeded_per_proc():
    def delays(proc_id):
        rng = random.Random(f"bytewax-restart:{proc_id}")
        return [_backoff_delay(0.5, a, rng) for a in range(1, 7)]

    # Deterministic per process (reproducible restart schedules)...
    assert delays(0) == delays(0)
    # ...but desynchronized across the cluster: no two processes of a
    # crashed cluster redial on the same schedule (thundering herd).
    assert delays(0) != delays(1) != delays(2)
    # Jitter stays within [0.5x, 1.5x) of the capped exponential
    # curve, so backoff still backs off and still caps.
    for proc in range(4):
        for attempt, d in enumerate(delays(proc), start=1):
            base = min(0.5 * (2 ** (attempt - 1)), 30.0)
            assert 0.5 * base <= d < 1.5 * base


# -- the rescale recommendation signal ---------------------------------


def test_rescale_hint_grow_on_slow_epoch_close():
    advice, reasons = derive_rescale_hint(
        worker_count=2,
        epoch_interval_s=10.0,
        close_p99_s=6.0,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
    )
    assert advice == "grow"
    assert any("epoch_close_p99" in r for r in reasons)


def test_rescale_hint_grow_on_flush_stalls_and_restores():
    advice, reasons = derive_rescale_hint(
        worker_count=1,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=3.0,
        restores_per_close=0.0,
    )
    assert advice == "grow" and any("stall" in r for r in reasons)
    advice, reasons = derive_rescale_hint(
        worker_count=1,
        epoch_interval_s=0.0,
        close_p99_s=0.001,
        stall_s_per_close=0.0,
        restores_per_close=8.0,
    )
    assert advice == "grow"
    assert any("residency restores" in r for r in reasons)
    # Active two-way disk-tier traffic (spills AND restores) is its
    # own grow reason — the residency-spill-rate signal.
    advice, reasons = derive_rescale_hint(
        worker_count=1,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.0,
        restores_per_close=0.5,
        spill_bytes_per_close=65536.0,
    )
    assert advice == "grow"
    assert any("spill bytes" in r for r in reasons)


def test_rescale_hint_transients_decay_instead_of_latching():
    # Signals are lifetime averages off cumulative counters: a one-off
    # warm-up spill/restore/stall must neither pin "grow" forever nor
    # block "shrink" forever once amortized over many epoch closes.
    advice, _ = derive_rescale_hint(
        worker_count=4,
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.001,  # one 1s stall over 1000 closes
        restores_per_close=0.01,  # one restore over 100 closes
        spill_bytes_per_close=10.0,  # one small spill, amortized
    )
    assert advice == "shrink"


def test_rescale_hint_shrink_only_when_everything_quiet():
    quiet = dict(
        epoch_interval_s=10.0,
        close_p99_s=0.1,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
    )
    advice, reasons = derive_rescale_hint(worker_count=4, **quiet)
    assert advice == "shrink" and reasons
    # A single worker can't shrink; any pressure flips to hold.
    assert derive_rescale_hint(worker_count=1, **quiet)[0] == "hold"
    assert (
        derive_rescale_hint(
            worker_count=4, **{**quiet, "restores_per_close": 0.5}
        )[0]
        == "hold"
    )


def test_rescale_hint_hold_before_any_signal():
    advice, reasons = derive_rescale_hint(
        worker_count=2,
        epoch_interval_s=10.0,
        close_p99_s=None,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
    )
    assert (advice, reasons) == ("hold", [])


# -- in-process engine: grow + shrink with the spill tier populated ----


def _ema_flow(inp, out):
    flow = Dataflow("rescale_df")
    s = op.input("inp", flow, TestingSource(inp, batch_size=4))
    scored = op.stateful_map("ema", s, xla.ema(0.3))
    op.output("out", scored, TestingSink(out))
    return flow


def _canon(rows):
    # (key, (orig, ema)) rows; round so device f32 vs host f64
    # arithmetic compares stably (the test_chaos demotion idiom).
    return sorted(
        (k, tuple(round(float(x), 3) for x in v)) for k, v in rows
    )


def _entry(worker_count):
    if worker_count == 1:
        return run_main
    return lambda *a, **kw: cluster_main(
        *a, [], 0, worker_count_per_proc=worker_count, **kw
    )


@pytest.mark.parametrize(
    "n_from,n_to",
    [(1, 3), (3, 1), (2, 3), (3, 2)],
    ids=["grow-1to3", "shrink-3to1", "grow-2to3", "shrink-3to2"],
)
def test_rescale_resume_with_spilled_keys(
    tmp_path, monkeypatch, n_from, n_to
):
    # A run stopped at N total workers resumes at M != N (grow AND
    # shrink, covering the run_main and in-process cluster_main entry
    # points) with the residency budget so small that most keys sit
    # in the host/disk spill tiers when the stop happens — outputs
    # must equal an uninterrupted host-tier oracle.
    n_keys, n_rows = 32, 256
    inp = [
        (f"u{i % n_keys:02d}", float(i % 11)) for i in range(n_rows)
    ]
    half = n_rows // 2
    db = tmp_path / "db"
    db.mkdir()
    init_db_dir(db, 2)
    rc = RecoveryConfig(str(db))
    monkeypatch.setenv("BYTEWAX_TPU_RESCALE", "1")
    monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "2")
    monkeypatch.setenv("BYTEWAX_TPU_HOST_STATE_BUDGET", "4")
    monkeypatch.setenv(
        "BYTEWAX_TPU_SPILL_DIR", str(tmp_path / "spill")
    )

    spilled_before = flight.RECORDER.counters.get(
        "state_spill_bytes", 0
    )
    out = []
    _entry(n_from)(
        _ema_flow(
            inp[:half] + [TestingSource.EOF()] + inp[half:], out
        ),
        epoch_interval=ZERO_TD,
        recovery_config=rc,
    )
    assert _canon(out) == _canon(_host_ema_oracle(inp[:half]))
    # The stop really left keys in the spill tier (the rescale must
    # carry them: their epoch snapshots read through the manager).
    assert (
        flight.RECORDER.counters.get("state_spill_bytes", 0)
        > spilled_before
    )

    rescales_before = flight.RECORDER.counters.get("rescale_count", 0)
    out2 = []
    _entry(n_to)(
        _ema_flow(
            inp[:half] + [TestingSource.EOF()] + inp[half:], out2
        ),
        epoch_interval=ZERO_TD,
        recovery_config=rc,
    )
    assert (
        flight.RECORDER.counters.get("rescale_count", 0)
        == rescales_before + 1
    )
    assert flight.RECORDER.counters.get("rescale_migrated_keys", 0) > 0
    assert _canon(out2) == _canon(
        _host_ema_oracle(inp)[half:]
    ), f"keyed state lost or duplicated across the {n_from}->{n_to} rescale"


def _host_ema_oracle(rows, alpha=0.3):
    # xla.ema semantics: debiased EMA over (count, s) state.
    state = {}
    out = []
    for key, value in rows:
        count, s = state.get(key, (0, 0.0))
        count += 1
        s = s * (1.0 - alpha) + alpha * value
        state[key] = (count, s)
        ema = s / (1.0 - (1.0 - alpha) ** count)
        out.append((key, (value, ema)))
    return out


# -- live partial rescale: in-process reconfiguration ------------------


@pytest.mark.parametrize(
    "n_from,n_to",
    [(2, 3), (3, 2)],
    ids=["grow-2to3", "shrink-3to2"],
)
def test_live_reconfigure_in_process_exactly_once(
    tmp_path, monkeypatch, n_from, n_to
):
    # A RUNNING flow takes a live reconfigure request mid-stream
    # (docs/recovery.md "Live partial rescale"): the change agrees at
    # the next epoch close, the driver unwinds to the run-startup
    # re-entry IN-PROCESS (one cluster_main call spans both shapes),
    # the startup migration runs delta-only, and the completed output
    # equals the host oracle exactly-once in both directions.
    from bytewax_tpu_torch.engine.driver import request_reconfigure

    n_keys, n_rows = 48, 384
    inp = [
        (f"u{i % n_keys:02d}", float(i % 11)) for i in range(n_rows)
    ]
    half = n_rows // 2
    items = inp[:half] + [("reconf", -1.0)] + inp[half:]
    db = tmp_path / "db"
    db.mkdir()
    init_db_dir(db, 2)
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    flight.RECORDER.activate(True)

    fired = [False]

    def trig(kv):
        if not fired[0] and kv[1] == -1.0:
            fired[0] = True
            request_reconfigure([], workers_per_process=n_to)
        return kv

    out = []
    flow = Dataflow("live_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=4))
    s = op.map("trig", s, trig)
    scored = op.stateful_map("ema", s, xla.ema(0.3))
    op.output("out", scored, TestingSink(out))
    rescales_before = flight.RECORDER.counters.get("rescale_count", 0)
    status = cluster_main(
        flow,
        [],
        0,
        worker_count_per_proc=n_from,
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert status is None  # ran to EOF at the new size
    assert fired[0]
    # Oracle over the full stream (the trigger sentinel flows through
    # the EMA like any other keyed item).
    assert _canon(out) == _canon(_host_ema_oracle(items)), (
        f"keyed state lost or duplicated across the live "
        f"{n_from}->{n_to} lane move"
    )
    # The move was the in-process re-entry + a DELTA migration, not
    # a full rewrite: strictly fewer keys migrated than the store
    # holds (the unmoved-route keys were skipped).
    assert (
        flight.RECORDER.counters.get("rescale_count", 0)
        == rescales_before + 1
    )
    events = flight.RECORDER.tail(1 << 14)
    resc = [e for e in events if e["kind"] == "rescale"][-1]
    assert resc["to_count"] == n_to
    total_keys = 0
    for part in sorted(Path(db).glob("part-*.sqlite3")):
        con = sqlite3.connect(part)
        total_keys += con.execute(
            "SELECT COUNT(DISTINCT state_key) FROM snaps"
        ).fetchone()[0]
        con.close()
    assert 0 < resc["keys"] < total_keys, (
        f"migrated {resc['keys']} of {total_keys} keys: not a delta"
    )
    assert any(e["kind"] == "reconfigure" for e in events)


def test_live_reconfigure_refused_without_recovery_store(
    monkeypatch,
):
    # A membership change without a recovery store would discard all
    # keyed state and replay the sources: the agreement refuses (and
    # consumes the request) instead of rebuilding into nothing.
    from bytewax_tpu_torch.engine.driver import request_reconfigure

    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    flight.RECORDER.activate(True)
    inp = [(f"k{i % 4}", float(i)) for i in range(64)]
    items = inp[:32] + [("reconf", -1.0)] + inp[32:]
    fired = [False]

    def trig(kv):
        if not fired[0] and kv[1] == -1.0:
            fired[0] = True
            request_reconfigure([], workers_per_process=3)
        return kv

    out = []
    flow = Dataflow("live_nostore_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=4))
    s = op.map("trig", s, trig)
    scored = op.stateful_map("ema", s, xla.ema(0.3))
    op.output("out", scored, TestingSink(out))
    reconfs_before = flight.RECORDER.counters.get(
        "reconfigure_count", 0
    )
    status = cluster_main(
        flow,
        [],
        0,
        worker_count_per_proc=2,
        epoch_interval=ZERO_TD,
        recovery_config=None,
    )
    assert status is None and fired[0]
    # No reconfiguration happened; the run completed at 2 lanes with
    # untouched output.
    assert (
        flight.RECORDER.counters.get("reconfigure_count", 0)
        == reconfs_before
    )
    assert _canon(out) == _canon(_host_ema_oracle(items))


def test_live_reconfigure_refused_under_distributed_flag(tmp_path, monkeypatch, caplog):
    """With ``BYTEWAX_TPU_DISTRIBUTED=1`` a one-process cluster runs (it
    joins no distributed runtime), and a live membership change is
    refused for the JAX package's reason, in the port's terms: the
    ``torch.distributed`` world size is fixed at initialization.  The
    request is consumed, no reconfiguration happens, and the host-tier
    run completes with its oracle's output."""
    import logging

    from bytewax_tpu_torch.engine.driver import request_reconfigure

    monkeypatch.setenv("BYTEWAX_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    flight.RECORDER.activate(True)
    db = tmp_path / "db"
    db.mkdir()
    init_db_dir(db, 1)
    inp = [(f"k{i % 4}", float(i)) for i in range(64)]
    items = inp[:32] + [("reconf", -1.0)] + inp[32:]
    fired = [False]

    def trig(kv):
        if not fired[0] and kv[1] == -1.0:
            fired[0] = True
            request_reconfigure([], workers_per_process=3)
        return kv

    out = []
    flow = Dataflow("live_dist_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=4))
    s = op.map("trig", s, trig)
    summed = op.stateful_map("sum", s, lambda st, v: ((st or 0.0) + v,) * 2)
    op.output("out", summed, TestingSink(out))
    reconfs_before = flight.RECORDER.counters.get("reconfigure_count", 0)
    with caplog.at_level(logging.WARNING):
        status = cluster_main(
            flow,
            [],
            0,
            worker_count_per_proc=2,
            epoch_interval=ZERO_TD,
            recovery_config=RecoveryConfig(str(db)),
        )
    assert status is None and fired[0]
    assert "cannot change world size in-process" in caplog.text
    assert "jax" not in caplog.text
    assert flight.RECORDER.counters.get("reconfigure_count", 0) == reconfs_before
    sums, want = {}, []
    for k, v in items:
        sums[k] = sums.get(k, 0.0) + v
        want.append((k, sums[k]))
    assert sorted(out) == sorted(want)


def test_live_reconfigure_migration_crash_retries_in_process(
    tmp_path, monkeypatch
):
    # Crash-mid-partial-migration on the LIVE path: the agreed
    # reconfiguration's first in-process re-entry crashes at the
    # pinned rescale_migrate site (inside the store transaction,
    # before any row moves); the in-process supervisor retries the
    # re-entry WITH the agreed target, the rolled-back delta
    # migration re-runs, and the completed output is exactly-once.
    from bytewax_tpu_torch.engine.driver import request_reconfigure

    inp = [(f"k{i % 8}", float(i)) for i in range(96)]
    half = len(inp) // 2
    items = inp[:half] + [("reconf", -1.0)] + inp[half:]
    db = tmp_path / "db"
    db.mkdir()
    init_db_dir(db, 1)
    monkeypatch.setenv(
        "BYTEWAX_TPU_FAULTS", "rescale_migrate:crash:*:x1"
    )
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    faults.reset()
    monkeypatch.setenv("BYTEWAX_FLIGHT_RECORDER", "1")
    flight.RECORDER.activate(True)

    fired = [False]

    def trig(kv):
        if not fired[0] and kv[1] == -1.0:
            fired[0] = True
            request_reconfigure([], workers_per_process=3)
        return kv

    out = []
    flow = Dataflow("live_crash_df")
    s = op.input("inp", flow, TestingSource(items, batch_size=4))
    s = op.map("trig", s, trig)
    scored = op.stateful_map("ema", s, xla.ema(0.3))
    op.output("out", scored, TestingSink(out))
    restarts_before = flight.RECORDER.counters.get(
        "worker_restart_count", 0
    )
    status = cluster_main(
        flow,
        [],
        0,
        worker_count_per_proc=2,
        epoch_interval=ZERO_TD,
        recovery_config=RecoveryConfig(str(db)),
    )
    assert status is None
    assert (
        flight.RECORDER.counters.get("worker_restart_count", 0)
        == restarts_before + 1
    )
    assert _canon(out) == _canon(_host_ema_oracle(items))


def test_rescale_resume_migration_crash_retries_under_supervisor(
    tmp_path, monkeypatch
):
    # End-to-end through the real fault site IN-PROCESS: the first
    # rescale attempt crashes mid-migration; the supervisor re-enters
    # at run startup, the rolled-back migration re-runs, and the
    # resumed output is exactly-once.
    inp = [(f"k{i % 4}", float(i)) for i in range(64)]
    half = len(inp) // 2
    db = tmp_path / "db"
    db.mkdir()
    init_db_dir(db, 1)
    rc = RecoveryConfig(str(db))
    out = []
    _entry(2)(
        _ema_flow(inp[:half] + [TestingSource.EOF()] + inp[half:], out),
        epoch_interval=ZERO_TD,
        recovery_config=rc,
    )

    monkeypatch.setenv("BYTEWAX_TPU_RESCALE", "1")
    monkeypatch.setenv(
        "BYTEWAX_TPU_FAULTS", "rescale_migrate:crash:*:x1"
    )
    monkeypatch.setenv("BYTEWAX_TPU_MAX_RESTARTS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.05")
    faults.reset()
    restarts_before = flight.RECORDER.counters.get(
        "worker_restart_count", 0
    )
    out2 = []
    _entry(3)(
        _ema_flow(inp[:half] + [TestingSource.EOF()] + inp[half:], out2),
        epoch_interval=ZERO_TD,
        recovery_config=rc,
    )
    assert (
        flight.RECORDER.counters.get("worker_restart_count", 0)
        == restarts_before + 1
    )
    assert _canon(out2) == _canon(_host_ema_oracle(inp)[half:])


# -- the device tier, held to the JAX package ---------------------------------

def _lanes(pkg, n):
    if n == 1:
        return pkg["run_main"]
    return lambda *a, **kw: pkg["cluster_main"](*a, [], 0, worker_count_per_proc=n, **kw)


@pytest.mark.parametrize("n_from,n_to", [(1, 3), (3, 1), (2, 3)], ids=["grow-1to3", "shrink-3to1", "grow-2to3"])
@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_device_tier_rescale_resume_matches_reference(tmp_path, monkeypatch, kind, n_from, n_to):
    """A device-tier run aborted at ``n_from`` lanes resumes at
    ``n_to`` with ``BYTEWAX_TPU_RESCALE=1``: each package migrates its
    store once, and the port's output (both runs) equals the JAX
    package's and the port's own uninterrupted run."""
    device_tier(monkeypatch)
    monkeypatch.setenv("BYTEWAX_TPU_RESCALE", "1")
    outs = {}
    for name, pkg in PKGS.items():
        db = tmp_path / name
        db.mkdir()
        pkg["init_db_dir"](db, 2)
        items = device_items(pkg, kind, n_keys=12)
        flow, s = device_flow(pkg, kind, items[:120] + [pkg["Source"].ABORT()] + items[120:])
        out = []
        pkg["op"].output("out", s, pkg["Sink"](out))
        rescales = flight.RECORDER.counters.get("rescale_count", 0)
        for lanes in (n_from, n_to):
            _lanes(pkg, lanes)(
                flow,
                epoch_interval=ZERO_TD,
                recovery_config=pkg["RecoveryConfig"](str(db)),
            )
        if name == "torch":
            assert flight.RECORDER.counters.get("rescale_count", 0) == rescales + 1
        outs[name] = out
    assert_device_out(kind, outs["torch"], outs["jax"])
    whole = []
    flow, s = device_flow(PORT, kind, device_items(PORT, kind, n_keys=12))
    op.output("out", s, TestingSink(whole))
    run_main(flow)
    assert_device_out(kind, outs["torch"], whole)


def test_rescale_migration_stays_linear_in_the_keys(tmp_path):
    """Migrating n keys costs SQLite work in proportion to n (4× the
    keys, under 5× the steps; the JAX package pages and updates by
    ``state_key`` without an index on it and costs 16× here), stamps
    the routes the JAX package's migration stamps, and leaves no index
    behind."""
    from bytewax_tpu.engine.recovery_store import rescale_snaps_rows as ref_rescale_snaps_rows

    steps = {}
    for n in (1000, 4000):
        routes = {}
        for name, migrate in (("port", rescale_snaps_rows), ("ref", ref_rescale_snaps_rows)):
            db = tmp_path / f"{name}{n}"
            db.mkdir()
            init_db_dir(db, 1)
            con = sqlite3.connect(db / "part-0.sqlite3")
            con.executemany(
                "INSERT INTO snaps (step_id, state_key, epoch, ser_change, route) VALUES (?, ?, ?, x'00', ?)",
                [(sid, f"k{i:06d}", e, route_of(f"k{i:06d}", 2)) for sid in ("df.a", "df.s") for i in range(n) for e in (1, 2)],
            )
            if name == "port":
                steps[n] = vm_steps([con], lambda con=con: rescale_snaps_rows(con, 3, page_size=100))
            else:
                assert migrate(con, 3, page_size=100) == n
            routes[name] = con.execute("SELECT step_id, state_key, epoch, route FROM snaps ORDER BY 1, 2, 3").fetchall()
            indexes = con.execute("SELECT name FROM sqlite_master WHERE type = 'index' AND tbl_name = 'snaps'").fetchall()
            assert all(not name.startswith("snaps_rescale") for (name,) in indexes)
            con.close()
        assert routes["port"] == routes["ref"]
    assert steps[4000] < 5 * steps[1000], steps


ROOT = Path(__file__).resolve().parent.parent


# -- subprocess clusters: 2<->3 processes under injected crashes -------


def _cluster_env(extra=None, accel=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    if not accel:
        env["BYTEWAX_TPU_ACCEL"] = "0"  # keep subprocess startup light
    for k in (
        "BYTEWAX_TPU_FAULTS",
        "BYTEWAX_TPU_MAX_RESTARTS",
        "BYTEWAX_TPU_RESCALE",
        "BYTEWAX_TPU_STATE_BUDGET",
        "BYTEWAX_TPU_SPILL_DIR",
        "BYTEWAX_TPU_HOST_STATE_BUDGET",
    ):
        env.pop(k, None)
    if extra:
        env.update(extra)
    return env


_CLUSTER_SEQ_FLOW = '''
import os

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition


class _Part(StatefulSourcePartition):
    def __init__(self, name, resume):
        self._name = name
        self._i = resume or 0

    def next_batch(self):
        if self._i >= int(os.environ["RESCALE_CAP"]):
            raise StopIteration()
        self._i += 1
        return [(f"{{self._name}}-{{self._i % 8}}", float(self._i % 13))]

    def snapshot(self):
        return self._i


class SeqSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(name, resume)


flow = Dataflow("rescale_cluster_df")
s = op.input("inp", flow, SeqSource())
s = op.stateful_map("ema", s, lambda st, v: (
    (v if st is None else st + 0.3 * (v - st),) * 2
))
s = op.map("fmt", s, lambda kv: (kv[0], f"{{kv[0]}}={{kv[1]:.3f}}"))
op.output("out", s, FileSink({out_path!r}))
'''


def _spawn_cluster(tmp_path, name, procs, cap, db, out_path, extra_env):
    flow_py = tmp_path / f"{name}.py"
    flow_py.write_text(_CLUSTER_SEQ_FLOW.format(out_path=str(out_path)))
    env = _cluster_env(extra_env)
    env["RESCALE_CAP"] = str(cap)
    cmd = [
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
    if extra_env and extra_env.get("BYTEWAX_TPU_RESCALE") == "1":
        cmd.append("--rescale")
    return subprocess.run(
        cmd,
        env=env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=240,
    )


def _cluster_seq_oracle(cap):
    want = []
    for part in ("p0", "p1"):
        emas = {}
        for i in range(1, cap + 1):
            key = f"{part}-{i % 8}"
            v = float(i % 13)
            prev = emas.get(key)
            emas[key] = (
                v if prev is None else prev + 0.3 * (v - prev)
            )
            want.append(f"{key}={emas[key]:.3f}")
    return sorted(want)


def _init_db(tmp_path, name):
    db = tmp_path / f"{name}_db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
        env=_cluster_env(),
        check=True,
        timeout=60,
    )
    return db


@pytest.mark.slow
@pytest.mark.parametrize(
    "p_from,p_to", [(2, 3), (3, 2)], ids=["grow-2to3", "shrink-3to2"]
)
def test_cluster_rescale_under_injected_migration_crash(
    tmp_path, p_from, p_to
):
    # A real multi-process cluster stops at N processes (EOF at half
    # the input); the relaunch at M processes takes an injected CRASH
    # at the pinned rescale_migrate site on proc 0 (mid-migration,
    # inside the store transaction).  The supervisors restart the
    # whole cluster, the rolled-back migration re-runs, and the final
    # output is byte-identical to an uninterrupted run — exactly-once
    # across both the resize and the crash.
    name = f"resc_{p_from}to{p_to}"
    cap = 40
    db = _init_db(tmp_path, name)
    out = tmp_path / f"{name}_out.txt"

    res = _spawn_cluster(
        tmp_path, name, p_from, cap // 2, db, out, {}
    )
    assert res.returncode == 0, res.stderr[-3000:]

    res = _spawn_cluster(
        tmp_path,
        name,
        p_to,
        cap,
        db,
        out,
        {
            "BYTEWAX_TPU_RESCALE": "1",
            "BYTEWAX_TPU_FAULTS": "rescale_migrate:crash:*:0:x1",
            "BYTEWAX_TPU_MAX_RESTARTS": "3",
            "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
        },
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "supervised restart" in res.stderr, res.stderr[-3000:]
    assert "rescaled recovery store" in res.stderr, res.stderr[-3000:]
    assert sorted(out.read_text().split()) == _cluster_seq_oracle(cap)


@pytest.mark.slow
def test_cluster_rescale_refused_without_flag(tmp_path):
    # The same relaunch WITHOUT the opt-in fails fast on every
    # process with the typed mismatch error and consumes nothing.
    name = "refuse"
    cap = 20
    db = _init_db(tmp_path, name)
    out = tmp_path / f"{name}_out.txt"
    res = _spawn_cluster(tmp_path, name, 2, cap // 2, db, out, {})
    assert res.returncode == 0, res.stderr[-3000:]
    before = sorted(out.read_text().split())

    res = _spawn_cluster(tmp_path, name, 3, cap, db, out, {})
    assert res.returncode != 0
    assert "WorkerCountMismatchError" in res.stderr
    assert sorted(out.read_text().split()) == before

    # And with it, the run completes against the oracle.
    res = _spawn_cluster(
        tmp_path, name, 3, cap, db, out, {"BYTEWAX_TPU_RESCALE": "1"}
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(out.read_text().split()) == _cluster_seq_oracle(cap)
