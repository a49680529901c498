"""Recovery and resume through the torch port, held to the JAX package.

The 18 cases of ``tests/test_recovery.py`` run through the port with the
same literal outputs: abort and continuation replay sets, stateful
continuation, rescale on resume and its gate, the partition errors,
``fold_final`` discards, the commit-watermark checks of
``resume_from``, paged ``iter_snaps`` and a resume whose memory the
store's paging bounds.

Then the device tier, run through both packages (the JAX package on its
single-device slot table, ``BYTEWAX_TPU_SHARD=0``): an abort and a
resume through each of the three device state classes (``stats_final``,
the keyed aggregation; ``xla.zscore``, the scan; ``stats_window``, the
windows), a store that one package wrote resumed by the other, both
ways, and window state resumed in pages against the reference's
per-window install.  Counts, keys, min and max must be equal, float
sums and means within ``rtol=atol=1e-5``, z-scores within ``1e-4``
(the reference's own bar); values lie on a grid of halves, so that the
JAX package's float32 sums are exact.
"""

import os
import pickle
import shutil
from datetime import timedelta

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as port_win
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import window_accel as ref_wa
from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine import scan_accel as port_sa
from bytewax_tpu_torch.engine import window_accel as port_wa
from bytewax_tpu_torch.engine import xla as port_xla_state
from bytewax_tpu_torch.engine.recovery_store import RecoveryStore as PortStore
from bytewax_tpu_torch.engine.recovery_store import loads as port_loads
from bytewax_tpu_torch.recovery import (
    InconsistentPartitionsError,
    MissingPartitionsError,
    NoPartitionsError,
    RecoveryConfig,
    init_db_dir,
)
from bytewax_tpu_torch.testing import TestingSink, TestingSource, cluster_main, run_main
from bytewax_tpu_torch.utils import force_platform
from tests.torch_device_flows import (
    ALIGN,
    DEVICE_KINDS,
    WAIT,
    assert_device_out,
    close,
    device_flow,
    device_items,
    device_tier,
    vm_steps,
)

ZERO_TD = timedelta(seconds=0)
FIVE_TD = timedelta(seconds=5)

REF = {
    "op": ref_op,
    "win": ref_win,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
}
PORT = {
    "op": op,
    "win": port_win,
    "xla": port_xla,
    "Dataflow": Dataflow,
    "Source": TestingSource,
    "Sink": TestingSink,
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


@pytest.fixture
def recovery_config(tmp_path):
    """A recovery config pointing at a 1-partition port store."""
    init_db_dir(tmp_path, 1)
    yield RecoveryConfig(str(tmp_path))




def test_abort_no_snapshots(recovery_config):
    inp = [0, 1, 2, TestingSource.ABORT(), 3, 4]
    out = []

    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    op.output("out", s, TestingSink(out))

    # Epoch interval of 5s means no snapshot before the abort.
    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == [0, 1, 2]

    # So resume replays all input.
    out.clear()
    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == [0, 1, 2, 3, 4]


def test_abort_with_snapshots(recovery_config):
    inp = [0, 1, 2, TestingSource.ABORT(), 3, 4]
    out = []

    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    op.output("out", s, TestingSink(out))

    # Epoch interval of 0 means a snapshot after each item.
    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [0, 1, 2]

    # Resume as if it was an EOF.
    out.clear()
    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [3, 4]


def test_continuation(recovery_config):
    inp = [0, 1, 2, TestingSource.EOF(), 3, 4]
    out = []

    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    op.output("out", s, TestingSink(out))

    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == [0, 1, 2]

    out.clear()
    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == [3, 4]

    out.clear()
    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == []

    out.clear()
    run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
    assert out == []


def test_continuation_with_delayed_backup(tmp_path):
    init_db_dir(tmp_path, 1)
    recovery_config = RecoveryConfig(str(tmp_path), backup_interval=FIVE_TD * 2)

    inp = [
        0,
        TestingSource.EOF(),
        1,
        TestingSource.EOF(),
        2,
        TestingSource.EOF(),
        3,
        TestingSource.EOF(),
        4,
    ]
    out = []

    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    op.output("out", s, TestingSink(out))

    for expect in ([0], [1], [2], [3], [4], []):
        out.clear()
        run_main(flow, epoch_interval=FIVE_TD, recovery_config=recovery_config)
        assert out == expect


def keep_max(max_val, new_val):
    if max_val is None:
        max_val = 0
    max_val = max(max_val, new_val)
    return (max_val, max_val)


def build_keep_max_dataflow(inp, out):
    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    s = op.stateful_map("max", s, keep_max)
    op.output("out", s, TestingSink(out))
    return flow


def test_stateful_continuation(recovery_config):
    inp = [
        ("a", 4),
        ("b", 4),
        TestingSource.EOF(),
        ("a", 1),
        ("b", 5),
    ]
    out = []
    flow = build_keep_max_dataflow(inp, out)

    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [("a", 4), ("b", 4)]

    # State (max so far) must survive the continuation.
    out.clear()
    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [("a", 4), ("b", 5)]


def test_rescale(tmp_path, monkeypatch):
    # Rescale-on-resume is opt-in: with BYTEWAX_TPU_RESCALE=1 the
    # keyed state is re-sharded to the new worker count at run
    # startup (grow AND shrink), state intact across every resize.
    monkeypatch.setenv("BYTEWAX_TPU_RESCALE", "1")
    init_db_dir(tmp_path, 3)
    recovery_config = RecoveryConfig(str(tmp_path))

    inp = [
        ("a", 4),
        ("b", 4),
        TestingSource.EOF(),
        ("a", 1),
        ("b", 5),
        TestingSource.EOF(),
        ("a", 8),
        ("b", 1),
    ]
    out = []

    flow = build_keep_max_dataflow(inp, out)

    def entry_point(worker_count_per_proc):
        cluster_main(
            flow,
            addresses=[],
            proc_id=0,
            epoch_interval=ZERO_TD,
            recovery_config=recovery_config,
            worker_count_per_proc=worker_count_per_proc,
        )

    # 2 continuations with different worker counts each time.
    entry_point(3)
    assert out == [("a", 4), ("b", 4)]

    out.clear()
    entry_point(5)
    assert out == [("a", 4), ("b", 5)]

    out.clear()
    entry_point(1)
    assert out == [("a", 8), ("b", 5)]


def test_rescale_refused_without_flag(tmp_path, monkeypatch):
    # Resuming a store written by N workers at M != N without the
    # rescale opt-in must raise the typed mismatch error (naming the
    # stored and actual counts and how to enable rescale) instead of
    # silently routing snaps rows with a stale modulus.
    from bytewax_tpu_torch.recovery import WorkerCountMismatchError

    monkeypatch.delenv("BYTEWAX_TPU_RESCALE", raising=False)
    init_db_dir(tmp_path, 2)
    recovery_config = RecoveryConfig(str(tmp_path))
    inp = [("a", 4), ("b", 7), TestingSource.EOF(), ("a", 9)]
    out = []
    flow = build_keep_max_dataflow(inp, out)

    def entry_point(worker_count_per_proc):
        cluster_main(
            flow,
            addresses=[],
            proc_id=0,
            epoch_interval=ZERO_TD,
            recovery_config=recovery_config,
            worker_count_per_proc=worker_count_per_proc,
        )

    entry_point(3)
    assert out == [("a", 4), ("b", 7)]
    with pytest.raises(
        WorkerCountMismatchError,
        match=r"3 worker\(s\).*has 2.*BYTEWAX_TPU_RESCALE=1",
    ) as exc_info:
        entry_point(2)
    assert exc_info.value.stored_counts == (3,)
    assert exc_info.value.actual_count == 2
    # Nothing was consumed or emitted by the refused execution; the
    # same-count resume still works.
    out.clear()
    entry_point(3)
    assert out == [("a", 9)]


def test_no_parts(tmp_path):
    # Don't init_db_dir.
    recovery_config = RecoveryConfig(str(tmp_path))

    inp = []
    out = []
    flow = build_keep_max_dataflow(inp, out)

    with pytest.raises(NoPartitionsError):
        run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)


def test_missing_parts(tmp_path):
    init_db_dir(tmp_path, 3)
    recovery_config = RecoveryConfig(str(tmp_path))

    os.remove(tmp_path / "part-0.sqlite3")

    inp = []
    out = []
    flow = build_keep_max_dataflow(inp, out)

    with pytest.raises(MissingPartitionsError):
        run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)


def test_inconsistent_parts(tmp_path):
    part_count = 3
    init_db_dir(tmp_path, part_count)
    recovery_config = RecoveryConfig(str(tmp_path), backup_interval=ZERO_TD)

    for i in range(part_count):
        shutil.copy(tmp_path / f"part-{i}.sqlite3", tmp_path / f"part-{i}.run0")

    inp = [
        ("a", 4),
        ("b", 4),
        TestingSource.ABORT(),
        ("a", 1),
        ("b", 5),
    ]
    out = []
    flow = build_keep_max_dataflow(inp, out)

    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [("a", 4), ("b", 4)]

    # Overwrite partition 0 with its initial (pre-run) version.  With
    # backup interval 0 the other partitions have already GC'd the
    # state needed to resume that far back.
    out.clear()
    shutil.copy(tmp_path / "part-0.run0", tmp_path / "part-0.sqlite3")
    with pytest.raises(InconsistentPartitionsError):
        run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)


def test_fold_final_discard_not_resurrected(recovery_config):
    # fold_final emits at EOF and discards its state; the discard must
    # be durable so the key is not resurrected on the next execution.
    inp = [
        ("a", 1),
        ("a", 2),
        TestingSource.EOF(),
        ("b", 10),
    ]
    out = []
    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    s = op.fold_final("sum", s, int, lambda acc, x: acc + x)
    op.output("out", s, TestingSink(out))

    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert sorted(out) == [("a", 3)]

    out.clear()
    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert sorted(out) == [("b", 10)]


def test_fold_final_resume_mid_stream_keeps_state(recovery_config):
    # An ABORT mid-stream must preserve partial fold state so the
    # final result is identical to an uninterrupted run.
    inp = [
        ("a", 1),
        TestingSource.ABORT(),
        ("a", 2),
    ]
    out = []
    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource(inp))
    s = op.fold_final("sum", s, int, lambda acc, x: acc + x)
    op.output("out", s, TestingSink(out))

    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == []

    run_main(flow, epoch_interval=ZERO_TD, recovery_config=recovery_config)
    assert out == [("a", 3)]


def test_resume_from_inconsistent_commit_watermark(tmp_path):
    # Store-level coverage of the resume_from() inconsistency check:
    # a partition whose GC watermark reached (or passed) the computed
    # resume epoch came from a newer backup than its siblings — resume
    # must refuse with a message naming the partition, the watermark,
    # and the resume epoch.
    import sqlite3

    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 1, 1)
    store.write_epoch(0, 1, 1, [], None)
    store.write_epoch(0, 1, 2, [], None)
    assert store.resume_from().resume_epoch == 3

    # Poison partition 1 with a commit watermark at the resume epoch
    # (simulating siblings restored from older backups).
    con = sqlite3.connect(tmp_path / "part-1.sqlite3")
    con.execute("INSERT OR REPLACE INTO commits (epoch) VALUES (3)")
    con.commit()
    con.close()
    with pytest.raises(
        InconsistentPartitionsError,
        match=(
            r"partition 1 already garbage-collected state up to "
            r"epoch 3.*resume epoch is 3.*inconsistent backups"
        ),
    ):
        store.resume_from()
    store.close()


def test_resume_from_commit_watermark_boundary_ok(tmp_path):
    # The boundary case must NOT raise: a watermark strictly below the
    # resume epoch is the normal delayed-GC state.
    import sqlite3

    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 1, 1)
    store.write_epoch(0, 1, 1, [], None)
    store.write_epoch(0, 1, 2, [], None)
    con = sqlite3.connect(tmp_path / "part-0.sqlite3")
    con.execute("INSERT OR REPLACE INTO commits (epoch) VALUES (2)")
    con.commit()
    con.close()
    resume = store.resume_from()
    assert (resume.ex_num, resume.resume_epoch) == (1, 3)
    store.close()


def test_resume_from_lost_exs_row_does_not_constrain(tmp_path):
    # A worker of the last execution whose exs row was lost (stale
    # partition restored from backup) must not drag the resume epoch
    # down to its start epoch; only surviving exs rows constrain the
    # minimum, and the commit check still guards real inconsistency.
    import sqlite3

    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 2, 1)  # workers 0 and 1
    store.write_epoch(0, 2, 1, [], None)
    store.write_epoch(0, 2, 5, [], None)
    assert store.resume_from().resume_epoch == 6

    # Drop worker 1's exs row (it lives in partition 1 % 2).
    con = sqlite3.connect(tmp_path / "part-1.sqlite3")
    con.execute("DELETE FROM exs WHERE worker_index = 1")
    con.commit()
    con.close()
    resume = store.resume_from()
    # Worker 0's frontier still decides; worker 1's orphaned front
    # row is ignored rather than treated as a brand-new worker at the
    # start epoch.
    assert (resume.ex_num, resume.resume_epoch) == (1, 6)
    store.close()


def test_inconsistent_parts_error_wording():
    # The class docstring is user-facing guidance (it names the
    # backup_interval knob); pin the wording the engine relies on.
    assert issubclass(InconsistentPartitionsError, ValueError)
    assert "backup_interval" in (InconsistentPartitionsError.__doc__ or "")


def test_iter_snaps_paginates_latest_per_key(tmp_path):
    # Keyset-paginated snapshot reads: latest epoch wins, discard
    # markers drop the key, step filter applies — identical results
    # at any page size (reference pages at 1000: src/recovery.rs:817).
    import pickle

    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore

    init_db_dir(tmp_path, 3)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 1, 1)
    snaps1 = [("df.a", f"k{i:03d}", pickle.dumps(i)) for i in range(100)]
    snaps1 += [("df.b", "x", pickle.dumps("old"))]
    store.write_epoch(0, 1, 1, snaps1, None)
    snaps2 = [("df.a", f"k{i:03d}", pickle.dumps(i * 10)) for i in range(0, 100, 2)]
    snaps2 += [("df.a", "k001", None)]  # discard marker
    snaps2 += [("df.b", "x", pickle.dumps("new"))]
    store.write_epoch(0, 1, 2, snaps2, None)

    def collect(**kw):
        return {
            (s, k): pickle.loads(b) for s, k, b in store.iter_snaps(3, **kw)
        }

    expect = {("df.a", f"k{i:03d}"): (i * 10 if i % 2 == 0 else i) for i in range(100)}
    del expect[("df.a", "k001")]
    expect[("df.b", "x")] = "new"
    assert collect(page_size=7) == expect
    assert collect(page_size=100000) == expect
    only_a = collect(page_size=7, step_ids=["df.a"])
    assert set(s for s, _k in only_a) == {"df.a"}
    # Reads strictly before an epoch exclude that epoch's writes.
    before2 = {
        (s, k): pickle.loads(b)
        for s, k, b in store.iter_snaps(2, page_size=7)
    }
    assert before2[("df.b", "x")] == "old"
    assert before2[("df.a", "k001")] == 1


def test_resume_memory_bounded_by_paging(tmp_path, monkeypatch):
    # A synthetic large keyed state resumes through the engine in
    # store pages: the peak python allocation during resume must stay
    # far below the cost of materializing every blob in one dict
    # (~100 MB for this shape), and the monolithic load_snaps must
    # not be called at all.
    import pickle
    import tracemalloc

    from bytewax_tpu_torch.engine.recovery_store import RecoveryStore
    from bytewax_tpu_torch.xla import SUM

    n = 150_000
    init_db_dir(tmp_path, 2)
    store = RecoveryStore(tmp_path)
    store.write_ex_started(0, 1, 1)
    step = "test_df.sum.fold_final.stateful.stateful_batch"
    store.write_epoch(
        0,
        1,
        1,
        [(step, f"key{i:07d}", pickle.dumps(float(i))) for i in range(n)],
        None,
    )
    store.write_epoch(0, 1, 2, [], None)
    store.close()

    monkeypatch.setattr(
        RecoveryStore,
        "load_snaps",
        lambda *a, **k: pytest.fail("resume must stream, not load_snaps"),
    )
    rc = RecoveryConfig(str(tmp_path))
    out = []
    flow = Dataflow("test_df")
    s = op.input("inp", flow, TestingSource([("key0000000", 1.0)]))
    r = op.reduce_final("sum", s, SUM)
    keep = ("key0000000", "key0149999")
    r = op.filter("keep", r, lambda kv: kv[0] in keep)
    op.output("out", r, TestingSink(out))
    tracemalloc.start()
    run_main(flow, recovery_config=rc)
    _cur, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert dict(out) == {"key0000000": 1.0, "key0149999": 149999.0}
    # Live resumed state (slot tables + key maps) is ~25 MB here; the
    # all-blobs dict alone would add >40 MB on top.
    assert peak < 45 * 1024 * 1024, f"resume peaked at {peak/1e6:.0f} MB"


# -- the device tier, held to the JAX package ---------------------------------

def _spent(pkg, inp, spent: bool):
    """``inp`` with ``None`` replaced by an ABORT sentinel, already
    triggered when ``spent``."""
    abort = pkg["Source"].ABORT()
    abort._triggered = spent
    return [abort if x is None else x for x in inp]


def _abort_run(pkg, kind, db, inp, spent):
    out = []
    flow, s = device_flow(pkg, kind, _spent(pkg, inp, spent))
    pkg["op"].output("out", s, pkg["Sink"](out))
    pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=pkg["RecoveryConfig"](str(db)))
    return out


@pytest.fixture
def loads_seen(monkeypatch):
    """Counts ``load_many`` calls on the port's three device state
    classes (a resume installs through them)."""
    seen = {}
    for cls in (port_xla_state.DeviceAggState, port_sa.DeviceScanState, port_wa.DeviceWindowAggState):
        inner = cls.load_many

        def counted(self, items, inner=inner, name=cls.__name__):
            seen[name] = seen.get(name, 0) + len(items)
            return inner(self, items)

        monkeypatch.setattr(cls, "load_many", counted)
    return seen


@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_device_tier_abort_and_resume_matches_reference(tmp_path, monkeypatch, loads_seen, kind):
    """An abort mid-input and a resume in one process, on the device
    tier: both packages replay the same rows and emit the same output,
    and the port's output equals its own uninterrupted run."""
    device_tier(monkeypatch)
    outs = {}
    for name, pkg in PKGS.items():
        items = device_items(pkg, kind)
        inp = items[:130] + [None] + items[130:]
        db = tmp_path / name
        db.mkdir()
        pkg["init_db_dir"](db, 1)
        head = _abort_run(pkg, kind, db, inp, spent=False)
        tail = _abort_run(pkg, kind, db, inp, spent=True)
        outs[name] = (head, tail)
    assert_device_out(kind, outs["torch"][0], outs["jax"][0])
    assert_device_out(kind, outs["torch"][1], outs["jax"][1])
    cls = {"stats_final": "DeviceAggState", "zscore": "DeviceScanState"}.get(kind, "DeviceWindowAggState")
    assert loads_seen.get(cls, 0) > 0, loads_seen
    whole = []
    flow, s = device_flow(PORT, kind, device_items(PORT, kind))
    op.output("out", s, TestingSink(whole))
    run_main(flow)
    assert_device_out(kind, outs["torch"][0] + outs["torch"][1], whole)


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("kind", ["stats_final", "sum_int", "stats_window"])
def test_store_resumes_across_packages(tmp_path, monkeypatch, kind, first, second):
    """A store that one package wrote before an abort resumes in the
    other package, and the output continues as the first package's own
    resume continues it (``anomaly_flow``'s scan state crosses in
    ``test_torch_scan.py``)."""
    device_tier(monkeypatch)
    a, b = PKGS[first], PKGS[second]
    (tmp_path / "own").mkdir()
    a["init_db_dir"](tmp_path / "own", 1)
    items = device_items(a, kind, seed=9)
    inp = items[:150] + [None] + items[150:]
    _abort_run(a, kind, tmp_path / "own", inp, spent=False)
    if (first, kind) == ("torch", "stats_window"):
        # The port's store pickles the port's window classes: the JAX
        # package reads them only with the port importable (ROADMAP C).
        store = PortStore(str(tmp_path / "own"))
        try:
            rows = [ser for sid, _k, ser in store.iter_snaps(10**6) if sid.endswith("stateful_batch")]
        finally:
            store.close()
        assert rows and all(b"bytewax_tpu_torch.operators.windowing" in ser for ser in rows)
    shutil.copytree(tmp_path / "own", tmp_path / "other")
    own = _abort_run(a, kind, tmp_path / "own", inp, spent=True)
    b_items = device_items(b, kind, seed=9)
    other = _abort_run(b, kind, tmp_path / "other", b_items[:150] + [None] + b_items[150:], spent=True)
    assert own
    assert_device_out(kind, other, own)


def _window_spec(pkg_wa, windower, kind="stats"):
    if windower == "session":
        return pkg_wa.SessionAccelSpec(kind, lambda x: x, timedelta(seconds=7), WAIT)
    length, offset = (
        (timedelta(minutes=1), timedelta(minutes=1))
        if windower == "tumbling"
        else (timedelta(minutes=2), timedelta(seconds=40))
    )
    return pkg_wa.WindowAccelSpec(kind, lambda x: x, ALIGN, length, offset, WAIT)


def _window_rows(batch_cls, seed=3, n=600, n_keys=40):
    rng = np.random.RandomState(seed)
    secs = np.sort(rng.randint(0, 900, n))
    ids = rng.randint(0, n_keys, n)
    vals = (rng.randint(-40, 40, n) / 2.0).astype(np.float64)
    vocab = np.array([f"key{k}" for k in range(n_keys)])
    ts = np.datetime64(ALIGN.replace(tzinfo=None), "us") + secs.astype("timedelta64[s]")
    return batch_cls({"key": vocab[ids], "ts": ts, "value": vals})


def _window_snaps_equal(got, want):
    assert [k for k, _s in got] == [k for k, _s in want]
    for (key, g), (_key, w) in zip(got, want):
        if w is None:
            assert g is None, key
            continue
        assert g.clock_state.watermark_base == w.clock_state.watermark_base, key
        gws, wws = g.windower_state, w.windower_state
        if hasattr(wws, "opened"):
            assert {i: (m.open_time, m.close_time) for i, m in gws.opened.items()} == {
                i: (m.open_time, m.close_time) for i, m in wws.opened.items()
            }, key
        else:
            assert gws.next_id == wws.next_id, key
            assert {i: (m.open_time, m.close_time, m.merged_ids) for i, m in gws.sessions.items()} == {
                i: (m.open_time, m.close_time, m.merged_ids) for i, m in wws.sessions.items()
            }, key
        assert g.logic_states.keys() == w.logic_states.keys(), key
        for wid, (wmn, wmx, wsum, wn) in w.logic_states.items():
            gmn, gmx, gsum, gn = g.logic_states[wid]
            assert (gmn, gmx, gn) == (wmn, wmx, wn), (key, wid)
            assert close(gsum, wsum), (key, wid)


@pytest.mark.parametrize("windower", ["tumbling", "sliding", "session"])
def test_paged_window_resume_matches_per_window_install(windower):
    """Window state that the JAX package snapshotted, pickled as a
    store row holds it and read back by the port's ``loads``: the
    port's paged install (``load_many``, one fold-table write for the
    page) and its one-key ``load`` give the same snapshots, key by key,
    as the reference's per-window install of the same snapshots."""
    ref_state = _window_spec(ref_wa, windower).make_state()
    late, phase = ref_state.on_batch_columnar(_window_rows(RefBatch))
    phase()
    keys = sorted(ref_state.key_ids)
    rows = [(k, pickle.dumps(s)) for k, s in ref_state.snapshots_for(keys) if s is not None]
    assert len(rows) > 20

    per_window = _window_spec(ref_wa, windower).make_state()
    for key, ser in rows:
        per_window.load(key, pickle.loads(ser))
    want = per_window.snapshots_for(keys)

    loaded = [(key, port_loads(ser)) for key, ser in rows]
    assert {type(snap).__module__ for _k, snap in loaded} == {"bytewax_tpu_torch.operators.windowing"}
    paged = _window_spec(port_wa, windower).make_state()
    paged.load_many(loaded)
    per_key = _window_spec(port_wa, windower).make_state()
    for key, ser in rows:
        per_key.load(key, port_loads(ser))
    got = paged.snapshots_for(keys)
    _window_snaps_equal(got, want)
    _window_snaps_equal(per_key.snapshots_for(keys), got)
    assert len(paged.agg.keys()) == sum(len(s.logic_states) for _k, s in want if s)


def test_paged_reads_stay_linear_in_the_keys(tmp_path):
    """A step- and route-scoped ``iter_snaps`` of n keys, in pages,
    costs SQLite work in proportion to n (4× the keys, under 5× the
    steps; the JAX package's read restarts each page at the step's
    first row and costs 10× here), and it reads the same rows as the
    JAX package's from the same store."""
    from bytewax_tpu.engine.recovery_store import RecoveryStore as RefStore

    steps = {}
    for n in (1000, 4000):
        db = tmp_path / str(n)
        db.mkdir()
        init_db_dir(db, 1)
        store = PortStore(db)
        store.write_ex_started(0, 1, 1)
        rows = [(sid, f"k{i:06d}", pickle.dumps(i)) for sid in ("df.a", "df.s", "df.z") for i in range(n)]
        store.write_epoch(0, 1, 1, rows, None)
        store.write_epoch(0, 1, 2, [("df.s", f"k{i:06d}", pickle.dumps(-i)) for i in range(0, n, 3)], None)
        got = []
        steps[n] = vm_steps(
            store._cons.values(),
            lambda store=store, got=got: got.extend(store.iter_snaps(3, step_ids=["df.s"], page_size=100, routes=[0])),
        )
        store.close()
        ref = RefStore(db)
        try:
            assert got == list(ref.iter_snaps(3, step_ids=["df.s"], page_size=100, routes=[0]))
        finally:
            ref.close()
        assert len(got) == n
    assert steps[4000] < 5 * steps[1000], steps
