"""Tiered key-state residency (``engine/residency.py``) of the torch
port held against the JAX package.

Each case of ``tests/test_residency.py`` runs the same flow, or drives
the same state, through both packages: budgeted aggregation under the
three entry points, the budget invariant and the tier counters, the
unset budget, the budgeted scan, spilled keys resumed from a recovery
store, restore faults retried in place and demoting with every tier,
the collective tier's exclusion, and the extract/inject round trips
of the aggregation, scan, window and sharded states.  State also
crosses between the packages: a store that a budgeted run of one
package left at an abort, with keys on all three tiers, resumes in the
other, and ``extract_keys`` snapshots of each package's states
``inject_keys`` into the other's.

Tolerances: integer sums, counts, min, max, keys, tier counters and
spill bytes exactly; float sums to ``rtol=atol=1e-5``; the EMA scan's
emissions against the host mapper as ``tests/test_residency.py``
holds them (``pytest.approx``, the EMA within 1e-4).
"""

import pickle
import sqlite3
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import bytewax_tpu._metrics as ref_metrics
import bytewax_tpu.engine.driver as ref_driver
import bytewax_tpu_torch._metrics as port_metrics
import bytewax_tpu_torch.engine.driver as port_driver
from bytewax_tpu.engine import arrays as ref_arrays
from bytewax_tpu.engine import faults as ref_faults
from bytewax_tpu.engine import flight as ref_flight
from bytewax_tpu.engine import residency as ref_residency
from bytewax_tpu.engine import sharded_state as ref_ss
from bytewax_tpu.engine import window_accel as ref_wa
from bytewax_tpu.ops import scan as ref_scan
from bytewax_tpu.parallel.mesh import make_mesh as ref_make_mesh
from bytewax_tpu_torch.engine import arrays as port_arrays
from bytewax_tpu_torch.engine import faults as port_faults
from bytewax_tpu_torch.engine import flight as port_flight
from bytewax_tpu_torch.engine import recovery_store as port_store
from bytewax_tpu_torch.engine import residency as port_residency
from bytewax_tpu_torch.engine import sharded_state as port_ss
from bytewax_tpu_torch.engine import window_accel as port_wa
from bytewax_tpu_torch.ops import scan as port_scan
from bytewax_tpu_torch.parallel.mesh import make_mesh as port_make_mesh
from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    PORT,
    REF,
    entry,
    port_deliveries,
    port_on_cpu,
    recovery_config,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
N_SHARDS = 8

#: Each package's engine modules, by the package's name.
ENGINE = {
    REF["name"]: {
        "driver": ref_driver,
        "faults": ref_faults,
        "flight": ref_flight,
        "metrics": ref_metrics,
        "residency": ref_residency,
        "ss": ref_ss,
        "wa": ref_wa,
        "scan": ref_scan,
        "arrays": ref_arrays,
    },
    PORT["name"]: {
        "driver": port_driver,
        "faults": port_faults,
        "flight": port_flight,
        "metrics": port_metrics,
        "residency": port_residency,
        "ss": port_ss,
        "wa": port_wa,
        "scan": port_scan,
        "arrays": port_arrays,
    },
}
BY_NAME = {"jax": REF, "port": PORT}


def _eng(pkg):
    return ENGINE[pkg["name"]]


@pytest.fixture(autouse=True)
def _fresh_fault_plans():
    ref_faults.reset()
    port_faults.reset()
    yield
    ref_faults.reset()
    port_faults.reset()


def _budget(monkeypatch, spill, budget, host_budget=None):
    monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", str(budget))
    monkeypatch.setenv("BYTEWAX_TPU_SPILL_DIR", str(spill))
    if host_budget is None:
        monkeypatch.delenv("BYTEWAX_TPU_HOST_STATE_BUDGET", raising=False)
    else:
        monkeypatch.setenv("BYTEWAX_TPU_HOST_STATE_BUDGET", str(host_budget))


def _sum_flow(pkg, flow_id, inp, out, batch_size=2):
    flow = pkg["Dataflow"](flow_id)
    s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=batch_size))
    r = pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)
    pkg["op"].output("out", r, pkg["Sink"](out))
    return flow


def _sum_oracle(inp):
    sums = {}
    for k, v in inp:
        sums[k] = sums.get(k, 0) + v
    return sorted(sums.items())


def _cycling_items(n, n_keys, stride=7):
    """Every key recurs throughout the stream, so a small budget
    forces continuous evict/restore churn."""
    return [(f"k{(i * stride) % n_keys:03d}", i) for i in range(n)]


def _peak_resident(pkg, flow_id):
    return max(
        (
            v
            for k, v in _eng(pkg)["flight"].RECORDER.counters.items()
            if k.startswith("state_resident_keys_peak[") and flow_id in k
        ),
        default=0,
    )


def _counter(pkg, name):
    return _eng(pkg)["flight"].RECORDER.counters.get(name, 0)


def _managers(monkeypatch, pkg):
    """Record the residency managers ``pkg``'s driver builds."""
    made = []
    mod = _eng(pkg)["driver"]
    wrap = mod.maybe_wrap

    def recording(step_id, state, worker_count=None):
        wrapped = wrap(step_id, state, worker_count=worker_count)
        if wrapped is not state:
            made.append(wrapped)
        return wrapped

    monkeypatch.setattr(mod, "maybe_wrap", recording)
    return made


# -- eviction/restore output equality ---------------------------------------


@pytest.mark.parametrize("entry_name", ENTRY_POINTS)
@pytest.mark.parametrize("budget", [2, 8, None])
def test_budgeted_agg_matches_reference(entry_name, budget, monkeypatch, tmp_path):
    """``test_budgeted_agg_matches_host_oracle``: integer sums at
    tight, loose and unbounded budgets under each package's own entry
    point equal the host oracle and each other exactly, and each
    package's resident keys hold the budget."""
    flow_id = f"tres_eq_{budget}_{entry_name}"
    inp = _cycling_items(240, 24)
    outs = []
    for pkg in PKGS:
        if budget is None:
            monkeypatch.delenv("BYTEWAX_TPU_STATE_BUDGET", raising=False)
        else:
            _budget(monkeypatch, tmp_path / pkg["name"], budget, host_budget=4)
        out = []
        entry(pkg, entry_name)(_sum_flow(pkg, flow_id, inp, out), epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(inp), pkg["name"]
        if budget is not None:
            assert 0 < _peak_resident(pkg, flow_id) <= budget, pkg["name"]
        outs.append(sorted(out))
    assert outs[1] == outs[0]


def test_budget_invariant_and_tier_counters_match_reference(monkeypatch, tmp_path):
    """``test_budget_invariant_and_tier_counters``: with cardinality
    far above the budget both packages evict, restore and spill the
    same number of keys and bytes, and resident keys never pass the
    budget at a drain point (the peak counter and the port's gauge)."""
    flow_id = "tres_invariant"
    inp = _cycling_items(200, 20)
    deltas = []
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 3, host_budget=4)
        names = ("state_evictions_count", "residency_restore_count", "state_spill_bytes")
        before = {name: _counter(pkg, name) for name in names}
        out = []
        pkg["run_main"](_sum_flow(pkg, flow_id, inp, out), epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(inp)
        delta = {name: _counter(pkg, name) - before[name] for name in names}
        assert all(v > 0 for v in delta.values()), (pkg["name"], delta)
        assert 0 < _peak_resident(pkg, flow_id) <= 3
        gauge = [
            s.value
            for metric in _eng(pkg)["metrics"].state_resident_keys.collect()
            for s in metric.samples
            if flow_id in str(s.labels.get("step_id", ""))
        ]
        assert gauge and max(gauge) <= 3
        deltas.append(delta)
    assert deltas[1] == deltas[0]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_unset_budget_never_builds_a_manager(name, monkeypatch):
    """``test_unset_budget_never_builds_a_manager``, for each package,
    and a run with no budget builds no manager."""
    pkg = BY_NAME[name]
    monkeypatch.delenv("BYTEWAX_TPU_STATE_BUDGET", raising=False)
    eng = _eng(pkg)
    st = eng["ss"].make_agg_state("sum")
    assert eng["residency"].maybe_wrap("step", st) is st
    made = _managers(monkeypatch, pkg)
    out = []
    pkg["run_main"](_sum_flow(pkg, "tres_unset", _cycling_items(40, 8), out))
    assert sorted(out) == _sum_oracle(_cycling_items(40, 8))
    assert made == []


# -- scan tier ----------------------------------------------------------------


def test_budgeted_scan_matches_reference(monkeypatch, tmp_path):
    """``test_budgeted_scan_matches_host_oracle``: the EMA scan
    restores evicted keys before it folds, so each package's per-row
    emissions equal its host mapper's under a budget of 2, and the
    port's equal the JAX package's."""
    items = [(f"k{(i * 3) % 9}", float(np.round(np.sin(i), 3))) for i in range(120)]
    outs = []
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 2, host_budget=3)
        states, want = {}, []
        mapper = pkg["xla"].ema(0.5)
        for k, v in items:
            st, emit = mapper(states.get(k), v)
            states[k] = st
            want.append((k, emit))
        out = []
        flow = pkg["Dataflow"]("tres_scan")
        s = pkg["op"].input("inp", flow, pkg["Source"](items, batch_size=2))
        s = pkg["op"].stateful_map("scan", s, pkg["xla"].ema(0.5))
        pkg["op"].output("out", s, pkg["Sink"](out))
        pkg["run_main"](flow, epoch_interval=ZERO_TD)
        by_g, by_w = {}, {}
        for k, row in out:
            by_g.setdefault(k, []).append(row)
        for k, row in want:
            by_w.setdefault(k, []).append(row)
        assert by_g.keys() == by_w.keys()
        for k in by_w:
            assert len(by_g[k]) == len(by_w[k]), k
            for g_row, w_row in zip(by_g[k], by_w[k]):
                assert g_row[0] == pytest.approx(w_row[0])
                assert g_row[1] == pytest.approx(w_row[1], abs=1e-4)
        assert 0 < _peak_resident(pkg, "tres_scan") <= 2
        outs.append(by_g)
    ref, port = outs
    assert port.keys() == ref.keys()
    for k in ref:
        assert [r[0] for r in port[k]] == [r[0] for r in ref[k]]
        np.testing.assert_allclose([r[1] for r in port[k]], [r[1] for r in ref[k]], **SUM_TOL)


# -- spilled-key recovery via resume_from() -----------------------------------


def _spent_abort(pkg):
    abort = pkg["Source"].ABORT()
    abort._triggered = True
    return abort


@pytest.mark.parametrize(
    "first,second", [("port", "port"), ("jax", "port"), ("port", "jax")]
)
def test_spilled_key_recovery_resume_from(first, second, monkeypatch, tmp_path):
    """``test_spilled_key_recovery_resume_from``, within the port and
    across the packages both ways: a budgeted run aborts with keys on
    all three tiers (the device, host snapshots, the spill file, whose
    rows are recovery ``snaps`` rows of pickled ints); the other
    package resumes the store exactly once against the oracle."""
    _budget(monkeypatch, tmp_path / "spill", 2, host_budget=3)
    head = _cycling_items(90, 18)
    tail = _cycling_items(36, 18, stride=5)
    flow_id = "tres_resume"
    db = tmp_path / "db"

    writer = BY_NAME[first]
    made = _managers(monkeypatch, writer)
    inp = head + [writer["Source"].ABORT()] + tail
    out = []
    writer["run_main"](
        _sum_flow(writer, flow_id, inp, out),
        epoch_interval=ZERO_TD,
        recovery_config=recovery_config(writer, db),
    )
    assert out == []  # reduce_final emits at EOF only
    (manager,) = made
    status = manager.status()
    assert status["resident"] > 0 and status["evicted"] > 0 and status["spilled"] > 0, status

    files = list((tmp_path / "spill").glob("spill-*.sqlite3"))
    assert files, "expected a spill store file"
    con = sqlite3.connect(files[0])
    try:
        rows = con.execute("SELECT step_id, state_key, epoch, ser_change FROM snaps").fetchall()
    finally:
        con.close()
    assert rows, "expected spilled rows in recovery row format"
    for sid, _key, _epoch, ser in rows:
        assert "stateful_batch" in sid
        assert isinstance(pickle.loads(ser), int)

    reader = BY_NAME[second]
    out2 = []
    reader["run_main"](
        _sum_flow(reader, flow_id, head + [_spent_abort(reader)] + tail, out2),
        epoch_interval=ZERO_TD,
        recovery_config=reader["recovery"].RecoveryConfig(str(db)),
    )
    assert sorted(out2) == _sum_oracle(head + tail)


# -- residency faults through each package's injector -------------------------


def test_mid_restore_device_fault_retries_in_place(monkeypatch, tmp_path):
    """``test_mid_restore_device_fault_retries_in_place``: one
    ``DeviceFault`` at the pinned ``residency_restore`` site is retried
    in place by each package; outputs equal the oracle."""
    inp = _cycling_items(120, 12)
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 2)
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "residency_restore:error:*:x1")
        _eng(pkg)["faults"].reset()
        c0 = _counter(pkg, "fault_injected_count")
        d0 = _counter(pkg, "demotion_count")
        out = []
        pkg["run_main"](_sum_flow(pkg, "tres_fault_retry", inp, out), epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(inp), pkg["name"]
        assert _counter(pkg, "fault_injected_count") == c0 + 1, pkg["name"]
        assert _counter(pkg, "demotion_count") == d0, pkg["name"]


def test_persistent_restore_faults_demote_with_all_tiers(monkeypatch, tmp_path):
    """``test_persistent_restore_faults_demote_with_all_tiers``: each
    package demotes the step once, and its demotion drains the
    resident, evicted and spilled tiers (all three hold keys when the
    faults begin), so the host logics own every key."""
    inp = _cycling_items(120, 12)
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 2, host_budget=3)
        monkeypatch.setenv("BYTEWAX_TPU_FAULTS", "residency_restore:error:*")
        _eng(pkg)["faults"].reset()
        made = _managers(monkeypatch, pkg)
        drained = []

        def recording(self, inner=_eng(pkg)["residency"].ResidentKeyState.demotion_snapshots):
            drained.append(dict(self.status()))
            return inner(self)

        monkeypatch.setattr(_eng(pkg)["residency"].ResidentKeyState, "demotion_snapshots", recording)
        c0 = _counter(pkg, "demotion_count")
        out = []
        pkg["run_main"](_sum_flow(pkg, "tres_fault_demote", inp, out), epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(inp), pkg["name"]
        assert _counter(pkg, "demotion_count") == c0 + 1, pkg["name"]
        assert len(made) == 1
        (status,) = drained
        assert status["resident"] > 0 and status["evicted"] > 0 and status["spilled"] > 0, status


# -- the collective tier never evicts -----------------------------------------


def test_global_exchange_tier_never_evicts(monkeypatch):
    """``test_global_exchange_tier_never_evicts`` on the port: a budget
    never wraps a ``global_exchange`` state, and the port's
    ``GlobalAggState`` has no residency surface."""
    monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "2")

    class _FakeGlobal:
        global_exchange = True

    fake = _FakeGlobal()
    assert port_residency.maybe_wrap("step", fake) is fake
    assert not hasattr(port_ss.GlobalAggState, "extract_keys")
    assert not hasattr(port_ss.GlobalAggState, "inject_keys")
    st = port_ss.make_agg_state("sum")
    assert isinstance(port_residency.maybe_wrap("step", st), port_residency.ResidentKeyState)


# -- extract/inject round trips, within the port and across the packages ------

DIRECTIONS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _agg_state(name, kind):
    return _eng(BY_NAME[name])["ss"].make_agg_state(kind)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_agg_extract_inject_round_trip(src, dst):
    """``test_agg_extract_inject_round_trip``: keys extracted from one
    package's aggregation state inject into the other's (or back into
    the same state) and fold on exactly."""
    st = _agg_state(src, "sum")
    st.update(np.asarray(["a", "b", "c"]), np.asarray([1, 2, 3]))
    items = dict(st.extract_keys(["a", "b"]))
    assert items == {"a": 1, "b": 2}
    assert set(st.keys()) == {"c"}
    if dst != src:
        st = _agg_state(dst, "sum")
        st.update(np.asarray(["c"]), np.asarray([3]))
    st.inject_keys(list(items.items()))
    st.update(np.asarray(["a"]), np.asarray([10]))
    assert sorted(st.finalize()) == [("a", 11), ("b", 2), ("c", 3)]


def _stats_rows(seed, n=400, n_keys=12):
    rng = np.random.RandomState(seed)
    keys = np.array([f"s{k:02d}" for k in rng.randint(0, n_keys, size=n)])
    return keys, (rng.randn(n) * 10).round(1)


def _same_stats(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, (gmn, gmean, gmx, gct)), (_k, (wmn, wmean, wmx, wct)) in zip(got, want):
        assert (gmn, gmx, gct) == (wmn, wmx, wct), k
        np.testing.assert_allclose(gmean, wmean, err_msg=k, **SUM_TOL)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_stats_snapshots_cross_and_fold_on(src, dst):
    """``stats`` snapshots (min, max, sum, count) of half the keys
    extracted mid-stream from one package's state and injected into
    the other's: the snapshots equal the extracting state's own
    ``snapshots_for``, and the finals equal an uninterrupted run of
    the injecting package."""
    keys, vals = _stats_rows(3)
    half = len(keys) // 2
    moved = sorted(set(keys[:half].tolist()))[::2]
    st = _agg_state(src, "stats")
    st.update(keys[:half], vals[:half])
    before = dict(st.snapshots_for(moved))
    items = st.extract_keys(moved)
    assert [k for k, _ in items] == moved
    for k, snap in items:
        assert tuple(snap) == tuple(before[k]), k
    assert not set(moved) & set(st.keys())
    if dst != src:
        rest_keys = [k for k in sorted(set(keys[:half].tolist())) if k not in moved]
        carried = st.snapshots_for(rest_keys)
        st = _agg_state(dst, "stats")
        st.load_many(carried)
    st.inject_keys(items)
    st.update(keys[half:], vals[half:])
    whole = _agg_state(dst, "stats")
    whole.update(keys[:half], vals[:half])
    whole.update(keys[half:], vals[half:])
    _same_stats(sorted(st.finalize()), sorted(whole.finalize()))


def _same_emits(got, want):
    """Two scan emissions: the same keys and values in the same order,
    outputs to the float tolerance."""
    _same_emits_items(got.items(), want.items())


def _same_emits_items(got, want):
    assert [(k, r[0]) for k, r in got] == [(k, r[0]) for k, r in want]
    np.testing.assert_allclose(
        [r[1:] for _k, r in got], [r[1:] for _k, r in want], **SUM_TOL
    )


def _ema_state(name):
    eng = _eng(BY_NAME[name])
    return eng["ss"].make_scan_state(eng["scan"].Ema(0.5))


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_scan_extract_inject_round_trip(src, dst):
    """``test_scan_extract_inject_round_trip``: an EMA key's snapshot
    (its count rides along) extracted from one package's scan state
    and injected into the other's resumes as the same snapshot, and
    the next rows score as in a state that never let it go."""
    st = _ema_state(src)
    st.update(np.asarray(["a", "a", "b"]), np.asarray([1.0, 2.0, 3.0]))
    items = st.extract_keys(["a"])
    assert [k for k, _s in items] == ["a"]
    (snap,) = [s for _k, s in items]
    assert snap[0] == 2  # count field rode the snapshot
    assert "a" not in st.keys()
    if dst != src:
        carried = st.snapshots_for(["b"])
        st = _ema_state(dst)
        st.load_many(carried)
    st.inject_keys(items)
    (resumed,) = [s for _k, s in st.snapshots_for(["a"])]
    assert resumed == pytest.approx(snap)
    kept = _ema_state(dst)
    kept.update(np.asarray(["a", "a", "b"]), np.asarray([1.0, 2.0, 3.0]))
    rows = (np.asarray(["b", "a", "a"]), np.asarray([4.0, 5.0, -1.0]))
    _same_emits(st.update(*rows)[1], kept.update(*rows)[1])


def _window_state(name):
    pkg = BY_NAME[name]
    align = datetime(2024, 1, 1, tzinfo=timezone.utc)
    spec = _eng(pkg)["wa"].WindowAccelSpec(
        "sum",
        lambda v: v.ts,
        align,
        timedelta(seconds=10),
        timedelta(seconds=10),
        timedelta(seconds=0),
    )
    return spec.make_state(), align


def _to(name, items):
    """Window snapshots as the other package reads them: the JAX
    package's classes become the port's through the port's store
    ``loads``; the JAX package takes the port's objects as they are
    (as it does when it resumes a port-written store)."""
    if name == "port":
        return [(k, port_store.loads(pickle.dumps(s))) for k, s in items]
    return items


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_window_extract_inject_round_trip(src, dst):
    """``test_window_extract_inject_round_trip``: extraction drains a
    key's open windows to its host-format ``_WindowSnapshot`` and frees
    its fold slots; injection (into the same state, or the other
    package's) reinstates them: the same logic states and opened
    windows."""
    st, align = _window_state(src)
    ts = align + timedelta(seconds=1)
    tsv = _eng(BY_NAME[src])["arrays"].TsValue
    _late, phase = st.on_batch(["a", "b"], [tsv(2.0, ts), tsv(5.0, ts)])
    phase()
    before = dict(st.snapshots_for(["a"]))
    items = st.extract_keys(["a"])
    assert [k for k, _s in items] == ["a"]
    assert not any(k2 == st.key_ids["a"] for (k2, _w) in st.open_close_us)
    if dst != src:
        st, _align = _window_state(dst)
        items = _to(dst, items)
    st.inject_keys(items)
    after = dict(st.snapshots_for(["a"]))
    assert after["a"].logic_states == before["a"].logic_states
    assert {
        i: (m.open_time, m.close_time) for i, m in after["a"].windower_state.opened.items()
    } == {i: (m.open_time, m.close_time) for i, m in before["a"].windower_state.opened.items()}
    # The reinstated window closes with the extracted sum.
    tsv = _eng(BY_NAME[dst])["arrays"].TsValue
    _late, phase = st.on_batch(["a"], [tsv(1.5, align + timedelta(seconds=3))])
    phase()
    closed = [(k, v) for k, (_w, tag, v) in st.on_eof() if tag == "E" and k == "a"]
    assert closed == [("a", 3.5)]


def _sharded(name, kind_of):
    if name == "jax":
        import jax

        if len(jax.devices()) < N_SHARDS:
            pytest.skip(f"needs {N_SHARDS} virtual devices")
        mesh = ref_make_mesh(N_SHARDS)
    else:
        mesh = port_make_mesh(devices=[torch.device("cpu")] * N_SHARDS)
    eng = _eng(BY_NAME[name])
    if kind_of == "stats":
        return eng["ss"].ShardedAggState("stats", mesh)
    return eng["ss"].ShardedScanState(eng["scan"].Ema(0.5), mesh)


@pytest.mark.parametrize("src,dst", DIRECTIONS[1:])
def test_sharded_agg_keys_cross_the_packages(src, dst):
    """``ShardedAggState.extract_keys`` of one package, mid-stream,
    injected into the other package's sharded state: the finals equal
    an uninterrupted sharded run of the injecting package."""
    keys, vals = _stats_rows(5, n=1200, n_keys=60)
    half = len(keys) // 2
    seen = sorted(set(keys[:half].tolist()))
    st = _sharded(src, "stats")
    st.update(keys[:half], vals[:half])
    items = st.extract_keys(seen)
    assert [k for k, _ in items] == seen
    assert st.keys() == []
    dest = _sharded(dst, "stats")
    dest.inject_keys(items)
    dest.update(keys[half:], vals[half:])
    whole = _sharded(dst, "stats")
    whole.update(keys, vals)
    _same_stats(sorted(dest.finalize()), sorted(whole.finalize()))


@pytest.mark.parametrize("src,dst", DIRECTIONS[1:])
def test_sharded_scan_keys_cross_the_packages(src, dst):
    """``ShardedScanState.extract_keys`` of one package injected into
    the other's: the EMA snapshots carry over, and the next rows score
    as in an uninterrupted sharded state of the injecting package."""
    rng = np.random.RandomState(9)
    keys = np.array([f"k{i}" for i in rng.randint(0, 20, size=300)])
    vals = rng.randn(300).round(2)
    st = _sharded(src, "ema")
    st.update(keys[:150], vals[:150])
    seen = sorted(set(keys[:150].tolist()))
    items = st.extract_keys(seen)
    assert sorted(k for k, _ in items) == seen
    dest = _sharded(dst, "ema")
    dest.inject_keys(items)
    for (k, got), (_k, want) in zip(sorted(dest.snapshots_for(seen)), sorted(items)):
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                                   err_msg=k, **SUM_TOL)
    whole = _sharded(dst, "ema")
    whole.update(keys[:150], vals[:150])
    _same_emits(dest.update(keys[150:], vals[150:])[1], whole.update(keys[150:], vals[150:])[1])


# -- the chip's budgeted paths at a small size ---------------------------------


def _band_ids(n_batches, rows, n_keys, ring, band, step, seed):
    """Dictionary ids of ``chip_smoke.py`` phase 15's traffic, small:
    98% of each batch's rows from a hot band of ``band`` keys that
    advances ``step`` keys a batch around a ring of ``ring`` keys (so
    the band comes back to keys evicted to the host or spilled), the
    rest uniform over all ``n_keys``."""
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n_batches):
        hot = rng.rand(rows) < 0.98
        band_ids = (b * step + rng.randint(0, band, rows)) % ring
        out.append(np.where(hot, band_ids, rng.randint(0, n_keys, rows)).astype(np.int32))
    return out


def _stats_oracle(vocab, ids_b, vals_b):
    acc = {}
    for ids, vals in zip(ids_b, vals_b):
        for i, v in zip(ids.tolist(), np.asarray(vals, dtype=np.float64).tolist()):
            mn, mx, tot, ct = acc.get(i, (np.inf, -np.inf, 0.0, 0))
            acc[i] = (min(mn, v), max(mx, v), tot + v, ct + 1)
    return {str(vocab[i]): a for i, a in acc.items()}


@pytest.mark.parametrize("tier", ["single", "sharded"])
@pytest.mark.parametrize("form", ["float32", "int16_scaled"])
def test_budgeted_dictionary_stats_match_reference(tier, form, monkeypatch, tmp_path, port_deliveries):
    """``stats_final`` over dictionary-encoded batches of band traffic
    under a budget of 128 keys (of 1,024; host budget 128, so keys
    also spill): the vocabulary drop at each eviction and the
    id-to-slot table's rebuild, on the single-device and the sharded
    tier.  Counts, min and max equal the float64 oracle and the JAX
    package's exactly, means within 1e-5; the port evicts, restores
    and spills, holds the budget at every drain point, and folds one
    delivery a batch (a budget turns coalescing off)."""
    from bytewax_tpu_torch.utils import VIRTUAL_DEVICES_ENV

    if tier == "sharded":
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", str(N_SHARDS))
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(N_SHARDS))
    n_batches, rows = 16, 512
    vocab = np.array([f"station_{i:04d}" for i in range(1024)])
    ids_b = _band_ids(n_batches, rows, 1024, ring=512, band=96, step=48, seed=21)
    rng = np.random.RandomState(22)
    deci = [rng.randint(-999, 1000, rows).astype(np.int16) for _ in range(n_batches)]
    if form == "float32":
        vals_b = [(d * np.float32(0.1)).astype(np.float32) for d in deci]
        want = _stats_oracle(vocab, ids_b, vals_b)
    else:
        vals_b = deci
        want = _stats_oracle(vocab, ids_b, [d.astype(np.float64) * 0.1 for d in deci])
    flow_id = f"tres_dict_{tier}_{form}"
    outs, counters = [], []
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 128, host_budget=128)
        names = ("state_evictions_count", "residency_restore_count", "state_spill_bytes")
        before = {name: _counter(pkg, name) for name in names}
        scale = {} if form == "float32" else {"value_scale": 0.1}
        batches = [
            pkg["Batch"]({"key_id": i, "value": v}, key_vocab=vocab, **scale) for i, v in zip(ids_b, vals_b)
        ]
        out = []
        flow = pkg["Dataflow"](flow_id)
        s = pkg["op"].input("inp", flow, pkg["ArraySource"](batches))
        pkg["op"].output("out", pkg["xla"].stats_final("stats", s), pkg["Sink"](out))
        pkg["run_main"](flow, epoch_interval=ZERO_TD)
        assert 0 < _peak_resident(pkg, flow_id) <= 128, pkg["name"]
        counters.append({name: _counter(pkg, name) - before[name] for name in names})
        outs.append(dict(out))
    ref, port = outs
    assert all(v > 0 for v in counters[1].values()), counters
    assert len(port_deliveries) == n_batches
    assert set(port) == set(ref) == set(want)
    for k, (mn, mx, tot, ct) in want.items():
        pmn, pmean, pmx, pct = port[k]
        assert (pmn, pmx, pct) == (ref[k][0], ref[k][2], ref[k][3]), k
        # float32 extrema against the float64 oracle: within an ulp
        assert pct == ct and pmn == pytest.approx(mn, abs=1e-5) and pmx == pytest.approx(mx, abs=1e-5), k
        np.testing.assert_allclose(pmean, ref[k][1], err_msg=k, **SUM_TOL)
        np.testing.assert_allclose(pmean, tot / ct, err_msg=k, **SUM_TOL)


def test_budgeted_anomaly_flow_matches_reference(monkeypatch, tmp_path):
    """``anomaly_flow`` over dictionary-encoded batches of band traffic
    under a budget of 64 sensors (of 512): every scored row equals the
    JAX package's (values exactly, z within 1e-4 of max(1, |z|), the
    same flags; values on a grid of halves in small batches, where the
    reference's z-score sums are exact, ROADMAP C)."""
    from bytewax_tpu.models.anomaly import anomaly_flow as ref_anomaly_flow
    from bytewax_tpu_torch.models.anomaly import anomaly_flow as port_anomaly_flow

    flows = {REF["name"]: ref_anomaly_flow, PORT["name"]: port_anomaly_flow}
    vocab = np.array([f"sensor_{i:04d}" for i in range(512)])
    ids_b = _band_ids(10, 128, 512, ring=256, band=48, step=24, seed=31)
    rng = np.random.RandomState(32)
    vals_b = [(rng.randint(-40, 40, 128) / 2).astype(np.float32) for _ in ids_b]
    outs = []
    for pkg in PKGS:
        _budget(monkeypatch, tmp_path / pkg["name"], 64, host_budget=64)
        r0 = _counter(pkg, "residency_restore_count")
        batches = [pkg["Batch"]({"key_id": i, "value": v}, key_vocab=vocab) for i, v in zip(ids_b, vals_b)]
        out = []
        pkg["run_main"](
            flows[pkg["name"]](pkg["ArraySource"](batches), pkg["Sink"](out), threshold=2.0),
            epoch_interval=ZERO_TD,
        )
        assert _counter(pkg, "residency_restore_count") > r0, pkg["name"]
        assert 0 < _peak_resident(pkg, "anomaly_detector") <= 64
        by_key = {}
        for k, (v, z, flag) in out:
            by_key.setdefault(k, []).append((v, z, flag))
        outs.append(by_key)
    ref, port = outs
    assert sum(map(len, port.values())) == sum(map(len, ids_b))
    assert port.keys() == ref.keys()
    for k in ref:
        assert [(v, f) for v, _z, f in port[k]] == [(v, f) for v, _z, f in ref[k]], k
        for (_v, gz, _f), (_w, wz, _g) in zip(port[k], ref[k]):
            assert abs(gz - wz) <= 1e-4 * max(1.0, abs(wz)), k


@pytest.mark.parametrize("budget", [None, 8])
def test_budget_caps_the_pipeline_depth(budget, monkeypatch, tmp_path):
    """With a budget the dispatch pipeline is capped at depth 2 in both
    packages (a fold still running could otherwise alloc keys past the
    budget unseen); without one it keeps the depth asked for."""
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", "4")
    depths = []
    for pkg in PKGS:
        if budget is None:
            monkeypatch.delenv("BYTEWAX_TPU_STATE_BUDGET", raising=False)
        else:
            _budget(monkeypatch, tmp_path / pkg["name"], budget)
        out = []
        pkg["run_main"](_sum_flow(pkg, "tres_depth", _cycling_items(60, 12), out), epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(_cycling_items(60, 12))
        depths.append(_counter(pkg, "pipeline_depth"))
    assert depths[1] == depths[0] == (4 if budget is None else 2)


@pytest.mark.parametrize("partial", [False, True])
def test_spill_rows_rescale_like_the_reference(partial, tmp_path):
    """``SpillStore.rescale``: the spill tier's ``snaps`` rows migrate
    through ``rescale_snaps_rows`` to the same home lanes, with the
    same number of rows rewritten, in both packages; the spilled
    states read back unchanged."""
    items = [(f"key{i:03d}", i * 7) for i in range(60)]
    routes, moved = [], []
    for name, residency in (("jax", ref_residency), ("port", port_residency)):
        store = residency.SpillStore(str(tmp_path / name), "flow.step", worker_count=2)
        store.put_many(items, epoch=3)
        moved.append(store.rescale(3, partial=partial))
        routes.append(
            store._con.execute("SELECT state_key, route FROM snaps ORDER BY state_key").fetchall()
        )
        assert [store.get(k) for k, _v in items] == [v for _k, v in items]
        store.close()
    assert moved[1] == moved[0] > 0
    assert routes[1] == routes[0]
    assert {r for _k, r in routes[1]} == {0, 1, 2}


@pytest.mark.parametrize("src,dst", DIRECTIONS[1:])
@pytest.mark.parametrize("windower", ["tumbling", "sliding", "session"])
def test_window_keys_cross_the_packages_and_close_alike(windower, src, dst):
    """Window keys extracted mid-stream from one package's window state
    (tumbling, sliding and session windows) take the place of the same
    keys in the other package's state: every later close, late row and
    EOF emission equals that of a state that kept its own."""
    from tests import test_torch_windowing as tw

    pkgs = {"jax": tw.REF, "port": tw.PORT}
    secs, ids, vals = tw._events(seed=71, n=400, n_keys=4, spread_s=900)
    half = len(secs) // 2
    first = (secs[:half], ids[:half], vals[:half])
    rest = (secs[half:], ids[half:], vals[half:])
    keys = ["key0", "key2"]
    donor = tw._spec(pkgs[src], windower, "sum").make_state()
    tw._ingest(donor, pkgs[src], *first)
    items = _to(dst, donor.extract_keys(keys))
    assert [k for k, _s in items] == keys
    moved = tw._spec(pkgs[dst], windower, "sum").make_state()
    kept = tw._spec(pkgs[dst], windower, "sum").make_state()
    for state in (moved, kept):
        tw._ingest(state, pkgs[dst], *first)
    moved.extract_keys(keys)
    moved.inject_keys(items)
    got = tw._ingest(moved, pkgs[dst], *rest) + moved.on_eof()
    want = tw._ingest(kept, pkgs[dst], *rest) + kept.on_eof()
    tw._assert_events_match("sum", got, want)


@pytest.mark.parametrize("kind", ["stats", "count"])
def test_freed_slots_start_from_identity_on_reuse(kind):
    """``extract_keys`` frees slots and ``alloc`` queues a reset of each
    freed slot it hands to a new key (``_pending_reset``): new keys in
    reused slots fold from the identity, not from the extracted keys'
    values, in the port as in the JAX package."""
    outs = []
    for name in ("jax", "port"):
        st = _agg_state(name, kind)
        st.update(np.asarray(["a", "b", "c"]), np.asarray([5.0, -7.0, 9.0]))
        gone = st.extract_keys(["a", "b"])
        st.update(np.asarray(["x", "y", "c"]), np.asarray([1.5, 2.5, 1.0]))
        outs.append((sorted(gone), sorted(st.finalize())))
    assert outs[1] == outs[0]
    finals = dict(outs[1][1])
    if kind == "count":
        assert finals == {"c": 2, "x": 1, "y": 1}
    else:
        assert finals["x"] == (1.5, 1.5, 1.5, 1) and finals["y"] == (2.5, 2.5, 2.5, 1)


def test_discarded_scan_key_restarts_from_identity():
    """``DeviceScanState.discard`` frees a key's slot; the key, seen
    again, scores as a new key in the port as in the JAX package (and
    the reused slot carries nothing of it)."""
    outs = []
    for name in ("jax", "port"):
        st = _ema_state(name)
        st.update(np.asarray(["a", "a", "b"]), np.asarray([1.0, 2.0, 3.0]))
        st.discard("a")
        assert "a" not in st.keys()
        emit = st.update(np.asarray(["c", "a", "b"]), np.asarray([7.0, 4.0, 5.0]))[1]
        outs.append(emit.items())
    _same_emits_items(outs[1], outs[0])
    fresh = _ema_state("port").update(np.asarray(["a"]), np.asarray([4.0]))[1].items()
    assert dict(outs[1])["a"] == pytest.approx(dict(fresh)["a"])
