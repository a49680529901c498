"""Device-tier flows that the recovery, checkpoint and rescale parity
tests (``tests/test_torch_recovery.py``, ``test_torch_ckpt.py``,
``test_torch_rescale.py``) run through both packages, and the
comparison of their outputs.

``pkg`` is a test module's dict of one package's names (``op``,
``win``, ``xla``, ``Dataflow``, ``Source``).  The three device state
classes each have a kind: ``stats_final`` (the keyed aggregation),
``zscore`` (the scan) and ``stats_window`` (tumbling windows);
``sum_int`` is ``reduce_final`` with ``SUM`` over int values.  Values
lie on a grid of halves, so that the JAX package's float32 sums are
exact.
"""

from datetime import datetime, timedelta, timezone

import numpy as np

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)
WAIT = timedelta(seconds=5)
DEVICE_KINDS = ("stats_final", "zscore", "stats_window")


def device_tier(monkeypatch):
    """Both packages on their device tier, with the source's batches
    delivered as they are (no coalescing: one epoch a batch)."""
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")


def device_items(pkg, kind, n=240, n_keys=6, seed=5):
    """``(key, value)`` items (windows: ``(key, TsValue)`` with mostly
    rising event seconds over 8 minutes, 5% pushed back 30 s)."""
    rng = np.random.RandomState(seed)
    keys = [f"k{int(i):02d}" for i in rng.randint(0, n_keys, n)]
    vals = (rng.randint(-40, 40, n) / 2.0).tolist()
    if kind == "sum_int":
        return [(k, int(2 * v)) for k, v in zip(keys, vals)]
    if kind != "stats_window":
        return list(zip(keys, vals))
    secs = np.sort(rng.randint(0, 480, n))
    back = rng.rand(n) < 0.05
    secs[back] -= 30
    ts = [ALIGN + timedelta(seconds=int(s)) for s in secs]
    return [(k, pkg["xla"].TsValue(v, t)) for k, v, t in zip(keys, vals, ts)]


def device_flow(pkg, kind, inp, flow_id="dev_df"):
    """The flow over ``inp`` (8 items a batch) up to its keyed output
    stream; returns the flow and the stream."""
    flow = pkg["Dataflow"](flow_id)
    s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=8))
    if kind == "stats_final":
        s = pkg["xla"].stats_final("stats", s)
    elif kind == "sum_int":
        s = pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)
    elif kind == "zscore":
        s = pkg["op"].stateful_map("z", s, pkg["xla"].zscore(2.5))
    else:
        win = pkg["win"]
        clock = win.EventClock(ts_getter=pkg["xla"].column_ts, wait_for_system_duration=WAIT)
        windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
        s = win.stats_window("w", s, clock, windower).down
    return flow, s


def close(g, w):
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def assert_device_out(kind, got, want):
    """Outputs of the same flow from two runs: the same rows per key in
    the same order, z within 1e-4 (scans); or the same keyed finals,
    counts, min and max exactly and means within ``rtol=atol=1e-5``
    (aggregation, windows); ints exactly and of the same type."""
    assert len(got) == len(want)
    if kind == "zscore":
        by_key = {}
        for rows, tag in ((got, 0), (want, 1)):
            for key, row in rows:
                by_key.setdefault(key, ([], []))[tag].append(row)
        for key, (g_rows, w_rows) in by_key.items():
            assert len(g_rows) == len(w_rows), key
            for (gv, gz, ga), (wv, wz, wa) in zip(g_rows, w_rows):
                assert gv == wv and ga == wa, (key, gv, wv)
                assert abs(gz - wz) <= 1e-4, (key, gz, wz)
        return
    got, want = sorted(got, key=repr), sorted(want, key=repr)
    if kind == "sum_int":
        # Of the reference's type too (ROADMAP C: resumed int state
        # folds as float in both packages for stats and mean).
        assert [(k, v, type(v)) for k, v in got] == [(k, v, type(v)) for k, v in want]
        return
    for (gk, g), (wk, w) in zip(got, want):
        assert gk == wk
        if kind == "stats_window":
            (gwid, g), (wwid, w) = g, w
            assert gwid == wwid, gk
        assert (g[0], g[2], g[3]) == (w[0], w[2], w[3]), (gk, g, w)
        assert close(g[1], w[1]), (gk, g, w)


def vm_steps(cons, fn):
    """SQLite virtual-machine steps (in hundreds) that ``fn`` costs on
    the connections ``cons``: a count that does not depend on timing."""
    count = [0]

    def tick():
        count[0] += 1
        return 0

    for con in cons:
        con.set_progress_handler(tick, 100)
    try:
        fn()
    finally:
        for con in cons:
            con.set_progress_handler(None, 100)
    return count[0]
