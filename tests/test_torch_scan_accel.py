"""The ``stateful_map`` lowering cases of ``tests/test_scan_accel.py``
that ``tests/test_torch_scan.py`` does not already hold under another
name, each run on the JAX package and on the torch port with the same
input and held to the reference test's expectations in both: the
z-score scan against the host oracle under every entry point and in
one-item batches, a non-string key's error, device snapshots resumed on
the host tier (z-score, EMA and a per-key UDF), an EMA whose alpha is
below float32's rounding of ``1 - alpha``, and the example anomaly
detector's flow on the device tier.  The port runs on the CPU."""

import os
from datetime import timedelta
from importlib import import_module

import numpy as np
import pytest

from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    PORT,
    REF,
    entry,
    port_on_cpu,
    recovery_config,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)


@pytest.fixture(autouse=True)
def _device_tier(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")


def _oracle(mapper, items):
    """The mapper per item in Python (the host tier)."""
    states, out = {}, []
    for k, v in items:
        states[k], emit = mapper(states.get(k), v)
        out.append((k, emit))
    return out


def _assert_rows_close(got, want, atol=1e-4):
    """The reference's check: the same rows per key, in order; bools
    equal, other cells within ``atol``."""
    assert len(got) == len(want)
    by_g, by_w = {}, {}
    for k, row in got:
        by_g.setdefault(k, []).append(row)
    for k, row in want:
        by_w.setdefault(k, []).append(row)
    assert by_g.keys() == by_w.keys()
    for k in by_w:
        for g_row, w_row in zip(by_g[k], by_w[k]):
            assert len(g_row) == len(w_row)
            for g_cell, w_cell in zip(g_row, w_row):
                if isinstance(w_cell, bool):
                    assert g_cell == w_cell
                else:
                    assert g_cell == pytest.approx(w_cell, abs=atol)


def _lowered(pkg, flow):
    specs = [o.conf.get("_accel") for o in pkg["flatten"](flow).ops if o.name == "stateful_batch"]
    return [type(s).__name__ for s in specs]


def _scan_flow(pkg, name, items, out, mapper, batch_size=7):
    flow = pkg["Dataflow"](name)
    s = pkg["op"].input("inp", flow, pkg["Source"](items, batch_size=batch_size))
    s = pkg["op"].stateful_map("scan", s, mapper)
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


def _zscore_items():
    rng = np.random.RandomState(7)
    items = [(f"k{rng.randint(0, 5)}", float(np.round(rng.randn(), 3))) for _ in range(400)]
    # Two blatant outliers, so both anomaly branches fire.
    items[200] = ("k0", 50.0)
    items[300] = ("k3", -40.0)
    return items


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_device_matches_host_oracle(entry_point, monkeypatch):
    """Both packages with the source's 7-row batches delivered as they
    are, and the port again with the default coalescing.  (Coalesced
    into one 400-row batch, the JAX package's single-device z-score
    body cancels past the 1e-4 bar: ROADMAP C, pinned by
    ``tests/test_torch_scan.py::test_reference_zscore_body_cancels_in_large_batches``.)"""
    items = _zscore_items()
    want = _oracle(REF["xla"].zscore(3.0), items)
    outs = []
    for pkg, target in ((REF, "0"), (PORT, "0"), (PORT, None)):
        if target is None:
            monkeypatch.delenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", raising=False)
        else:
            monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", target)
        out = []
        flow = _scan_flow(pkg, "scan_accel", items, out, pkg["xla"].zscore(3.0))
        assert _lowered(pkg, flow) == ["ScanAccelSpec"]
        entry(pkg, entry_point)(flow)
        _assert_rows_close(out, want)
        outs.append(out)
    assert any(row[2] for _k, row in want)
    _assert_rows_close(outs[1], outs[0])


def test_single_item_batches_match_oracle():
    items = [("a", 1.0), ("b", 2.0), ("a", 3.0), ("a", 2.0), ("b", 9.0)]
    want = _oracle(REF["xla"].zscore(2.0), items)
    for pkg in PKGS:
        out = []
        pkg["run_main"](_scan_flow(pkg, "scan_accel", items, out, pkg["xla"].zscore(2.0), batch_size=1))
        _assert_rows_close(out, want)


def test_mixed_malformed_rows_error_like_host():
    """A non-string key: the device path falls back and surfaces the
    host tier's step-qualified ``TypeError``."""
    errors = []
    for pkg in PKGS:
        flow = _scan_flow(pkg, "scan_accel", [(1, 2.0)], [], pkg["xla"].zscore(2.0))
        with pytest.raises(TypeError, match="str") as info:
            pkg["run_main"](flow)
        errors.append(str(info.value).replace(PORT["name"], REF["name"]))
    assert errors[1] == errors[0]


def _cross_tier(pkg, name, items, tail, make, rc, batch_size=2):
    """``items``, an abort, ``tail``: the device tier up to the abort,
    then the host tier (``BYTEWAX_TPU_ACCEL=0``) from its snapshots."""
    inp = items + [pkg["Source"].ABORT()] + tail
    out1, out2 = [], []
    pkg["run_main"](_scan_flow(pkg, name, inp, out1, make(pkg), batch_size), epoch_interval=ZERO_TD, recovery_config=rc)
    prev = os.environ.get("BYTEWAX_TPU_ACCEL")
    os.environ["BYTEWAX_TPU_ACCEL"] = "0"
    try:
        pkg["run_main"](
            _scan_flow(pkg, name, inp, out2, make(pkg), batch_size), epoch_interval=ZERO_TD, recovery_config=rc
        )
    finally:
        if prev is None:
            os.environ.pop("BYTEWAX_TPU_ACCEL", None)
        else:
            os.environ["BYTEWAX_TPU_ACCEL"] = prev
    return out1, out2


def test_device_snapshot_resumes_on_host_tier(tmp_path):
    items = [("a", 1.0), ("a", 2.0), ("b", 5.0)]
    tail = [("a", 3.0), ("b", 6.0)]
    want = _oracle(REF["xla"].zscore(2.0), items + tail)
    for pkg in PKGS:
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        out1, out2 = _cross_tier(pkg, "scan_accel", items, tail, lambda p: p["xla"].zscore(2.0), rc)
        assert len(out1) == len(items)
        _assert_rows_close(out1 + out2, want)


def _rand_items(n=300, n_keys=4, seed=11):
    rng = np.random.RandomState(seed)
    return [(f"k{rng.randint(0, n_keys)}", float(np.round(rng.randn(), 3))) for _ in range(n)]


def test_ema_cross_tier_snapshot(tmp_path):
    items = _rand_items(n=40, n_keys=3, seed=5)
    tail = [("a", 3.0), ("b", 6.0)]
    want = _oracle(REF["xla"].ema(0.5), items + tail)
    for pkg in PKGS:
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        out1, out2 = _cross_tier(pkg, "scan_ema_rt", items, tail, lambda p: p["xla"].ema(0.5), rc)
        _assert_rows_close(out1 + out2, want)


def test_ema_tiny_alpha_stays_finite():
    """An alpha below float32's rounding of ``1 - alpha`` keeps the
    debias factor (the ``expm1``/``log1p`` spelling): device ≈ host."""
    alpha = 1e-8
    items = [("a", v) for v in [3.0, 5.0, 4.0, 6.0]]
    want = _oracle(REF["xla"].ema(alpha), items)
    for pkg in PKGS:
        out = []
        flow = _scan_flow(pkg, "scan_kind", items, out, pkg["xla"].ema(alpha), batch_size=2)
        assert _lowered(pkg, flow) == ["ScanAccelSpec"]
        pkg["run_main"](flow)
        _assert_rows_close(out, want, atol=1e-3)


def test_example_anomaly_detector_runs_device_tier():
    """The example anomaly detector's flow engages the scan tier and
    scores all 50 readings of its source."""
    outs = []
    for pkg in PKGS:
        demo = import_module(f"{pkg['name']}.connectors.demo")
        flow = pkg["Dataflow"]("anomaly_device")
        s = pkg["op"].input(
            "inp", flow, demo.RandomMetricSource("metric", interval=timedelta(0), count=50, seed=1)
        )
        out = []
        s = pkg["op"].stateful_map("zscore", s, pkg["xla"].zscore(2.5))
        pkg["op"].output("out", s, pkg["Sink"](out))
        assert _lowered(pkg, flow) == ["ScanAccelSpec"]
        pkg["run_main"](flow)
        assert len(out) == 50
        assert all(k == "metric" for k, _ in out)
        outs.append(out)
    _assert_rows_close(outs[1], outs[0])


def _runsum_jax(state, v):
    (total,) = state
    total = total + v
    return (total,), (total,)


def _runsum_torch(state, v):
    (total,) = state
    total = total + v
    return (total,), (total,)


def _runsum(pkg):
    if pkg is REF:
        return pkg["xla"].jax_stateful_map(_runsum_jax, (0.0,))
    return pkg["xla"].torch_stateful_map(_runsum_torch, (0.0,))


def test_torch_stateful_map_cross_tier_snapshot(tmp_path):
    """The counterpart of ``test_jax_stateful_map_cross_tier_snapshot``:
    a per-key UDF's device snapshots resume on the host tier."""
    items = [("a", 1.0), ("b", 10.0), ("a", 2.0)]
    tail = [("a", 3.0), ("b", 5.0)]
    want = _oracle(_runsum(REF), items + tail)
    for pkg in PKGS:
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        out1, out2 = _cross_tier(pkg, "scan_udf_rt", items, tail, _runsum, rc)
        _assert_rows_close(out1 + out2, want)
