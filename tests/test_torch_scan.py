"""The scan tier (``stateful_map`` lowered to a segmented scan) of the
JAX package and of the torch port, on the same seeded inputs.

Each built-in kind, the plain z-score body, the plain generic body and
the UDF kind (``TorchUdfScan`` against ``JaxUdfScan``) run the same
grouped rows from the same state tables (carried in through
``load_many``); z must agree within ``atol=1e-4`` (the reference's own
bar), counts and extrema exactly, other float32 state within 1e-5
relative.  The JAX side runs on the CPU (``BYTEWAX_TPU_SHARD=0``: its
single-device slot table, the tier the port has), the port's on the CPU
through each kind's plain version.

Values lie on a grid of halves in small batches, so that the JAX
package's z-score body sums them exactly: its float32 batch-wide
prefix sums cancel on near-equal values in large batches
(``test_reference_zscore_body_cancels_in_large_batches`` shows it; the
port's plain body and the kernel do not).

Also here: whole flows (``anomaly_flow``, ``ema``, ``running_extrema``,
``torch_stateful_map`` against ``jax_stateful_map``) through both
packages' ``run_main``, the lowering annotations, bool UDF state
snapshots, construction-time rejection of bad UDFs, the host-tier
fallback for non-numeric rows, and an ``anomaly_flow`` recovery store
written by one package and resumed by the other, both ways.
"""

import os
import pickle
import shutil
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bytewax_tpu.operators as ref_op
import bytewax_tpu_torch.operators as port_op
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import scan_accel as ref_sa
from bytewax_tpu.models import anomaly as ref_anomaly
from bytewax_tpu.ops import scan as ref_scan
from bytewax_tpu.recovery import RecoveryConfig as RefRecoveryConfig
from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.engine import scan_accel as port_sa
from bytewax_tpu_torch.engine.flatten import flatten as port_flatten
from bytewax_tpu_torch.engine.recovery_store import RecoveryStore as PortStore
from bytewax_tpu_torch.models import anomaly as port_anomaly
from bytewax_tpu_torch.ops import scan as port_scan
from bytewax_tpu_torch.recovery import RecoveryConfig as PortRecoveryConfig
from bytewax_tpu_torch.recovery import init_db_dir as port_init_db_dir
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform

REF = {
    "op": ref_op,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "anomaly": ref_anomaly,
    "RecoveryConfig": RefRecoveryConfig,
    "init_db_dir": ref_init_db_dir,
}
PORT = {
    "op": port_op,
    "xla": port_xla,
    "Dataflow": PortDataflow,
    "Source": PortSource,
    "Sink": PortSink,
    "run_main": port_run_main,
    "anomaly": port_anomaly,
    "RecoveryConfig": PortRecoveryConfig,
    "init_db_dir": port_init_db_dir,
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
def _small_batches(monkeypatch):
    """Both packages on their single-device device tier, with the
    source's batches delivered as they are (no coalescing)."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")


def _grid_items(n=300, n_keys=5, seed=11):
    """``(key, value)`` items, values multiples of 0.5 and a few
    outliers, so both anomaly branches fire."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, n)
    vals = np.round(rng.randn(n) * 4.0) / 2.0
    vals[rng.rand(n) < 0.02] = 20.0
    return [(f"k{k}", float(v)) for k, v in zip(keys, vals)]


def _per_key(rows):
    by = {}
    for k, row in rows:
        by.setdefault(k, []).append(row)
    return by


def _assert_rows_close(got, want, atol=1e-4):
    """Per key, in order: bools and ints exactly, floats within
    ``atol`` of max(1, |want|)."""
    assert len(got) == len(want)
    g, w = _per_key(got), _per_key(want)
    assert g.keys() == w.keys()
    for k in w:
        assert len(g[k]) == len(w[k]), k
        for g_row, w_row in zip(g[k], w[k]):
            assert len(g_row) == len(w_row)
            for gc, wc in zip(g_row, w_row):
                if isinstance(wc, (bool, np.bool_, int)):
                    assert gc == wc, (k, g_row, w_row)
                else:
                    assert abs(gc - wc) <= atol * max(1.0, abs(wc)), (k, g_row, w_row)


# -- the kinds and the plain bodies ---------------------------------------


def _kinds(name):
    """(JAX kind, port kind) of one name."""
    if name == "zscore":
        return ref_scan.WelfordZScore(2.5), port_scan.WelfordZScore(2.5)
    if name == "ema":
        return ref_scan.Ema(0.3), port_scan.Ema(0.3)
    if name == "ema_alpha1":
        return ref_scan.Ema(1.0), port_scan.Ema(1.0)
    return ref_scan.RunningExtrema(), port_scan.RunningExtrema()


def _carried(name, keys, rng):
    """Host-format states for ``keys``, consistent with the kind."""
    out = []
    for k in keys:
        c = int(rng.randint(1, 30))
        if name == "zscore":
            out.append((k, (c, float(np.float32(rng.randn() * 3)), float(np.float32(c * 4.0)))))
        elif name.startswith("ema"):
            out.append((k, (c, float(np.float32(rng.randn() * 3)))))
        else:
            lo = float(np.float32(rng.randn() * 3))
            out.append((k, (lo, lo + 2.5)))
    return out


def _assert_states(name, got, want):
    for (gk, gs), (wk, ws) in zip(got, want):
        assert gk == wk
        if ws is None:
            assert gs is None
            continue
        for gv, wv in zip(gs, ws):
            if isinstance(wv, int) or name == "extrema":
                assert gv == wv, (gk, gs, ws)
            else:
                assert abs(gv - wv) <= 1e-5 * max(1.0, abs(wv)), (gk, gs, ws)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("name", ["zscore", "ema", "ema_alpha1", "extrema"])
def test_scan_state_matches_reference(name, carried):
    """``DeviceScanState`` of both packages over three batches of the
    same rows, from the same (loaded) states: outputs per row and
    snapshots agree."""
    ref_kind, port_kind = _kinds(name)
    ref_state = ref_sa.DeviceScanState(ref_kind)
    port_state = port_sa.DeviceScanState(port_kind)
    assert port_state.device == torch.device("cpu")
    rng = np.random.RandomState(3)
    keys = [f"k{i}" for i in range(7)]
    if carried:
        loaded = _carried(name, keys[:5], rng)
        ref_state.load_many(loaded)
        port_state.load_many(loaded)
    for b in range(3):
        items = _grid_items(n=64, n_keys=7, seed=20 + b)
        k = np.array([i[0] for i in items])
        v = np.array([i[1] for i in items])
        ref_touched, ref_emit = ref_state.update(k, v)
        port_touched, port_emit = port_state.update(k, v)
        assert port_touched == ref_touched
        _assert_rows_close(port_emit.items(), ref_emit.items())
    _assert_states(
        name, port_state.snapshots_for(keys + ["missing"]), ref_state.snapshots_for(keys + ["missing"])
    )


def _grouped(n, n_keys, seed, capacity=16):
    rng = np.random.RandomState(seed)
    slots = np.sort(rng.randint(0, n_keys, n)).astype(np.int32)
    vals = (np.round(rng.randn(n) * 4.0) / 2.0).astype(np.float32)
    return slots, vals


def _ref_fields(kind, capacity, rng):
    """Field tables with state in every real slot (numpy)."""
    out = {}
    for name, (init, dtype) in kind.fields.items():
        arr = np.full(capacity, init, dtype=np.dtype(dtype))
        out[name] = arr
    m = capacity - 1
    if "count" in out:
        out["count"][:m] = rng.randint(1, 20, m)
    if "mean" in out:
        out["mean"][:m] = rng.randn(m).astype(np.float32)
        out["m2"][:m] = (rng.rand(m) * 30).astype(np.float32)
    if "s" in out:
        out["s"][:m] = rng.randn(m).astype(np.float32)
    if "mn" in out:
        out["mn"][:m] = rng.randn(m).astype(np.float32)
        out["mx"][:m] = out["mn"][:m] + 1.0
    return out


BODIES = {
    # name -> (kind name, reference body, port body)
    "zscore_body": ("zscore", lambda k: ref_scan.zscore_scan_body, lambda k: port_scan.zscore_scan_body),
    "generic_zscore": ("zscore", ref_scan.generic_scan_body, port_scan.generic_scan_body),
    "generic_ema": ("ema", ref_scan.generic_scan_body, port_scan.generic_scan_body),
    "generic_extrema": ("extrema", ref_scan.generic_scan_body, port_scan.generic_scan_body),
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_body_matches_reference(body):
    kind_name, ref_body, port_body = BODIES[body]
    ref_kind, port_kind = _kinds(kind_name)
    capacity = 16
    host = _ref_fields(ref_kind, capacity, np.random.RandomState(5))
    slots, vals = _grouped(96, capacity - 1, seed=6)
    ref_fields = {k: jnp.asarray(v) for k, v in host.items()}
    port_fields = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    ref_outs, ref_new = ref_body(ref_kind)(ref_fields, jnp.asarray(slots), jnp.asarray(vals))
    port_outs, port_new = port_body(port_kind)(port_fields, torch.from_numpy(slots), torch.from_numpy(vals))
    for r, p in zip(ref_outs, port_outs):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
    real = slice(0, capacity - 1)  # the scratch slot holds arbitrary rows
    for name in host:
        r = np.asarray(ref_new[name])[real]
        p = port_new[name].numpy()[real]
        if r.dtype.kind == "i" or kind_name == "extrema":
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)


def test_generic_zscore_matches_specialized():
    """The kind's lift/merge/emit (the generic spelling) and its
    pivot-shifted body are two formulations of one scan."""
    kind = port_scan.WelfordZScore(2.0)
    slots, vals = _grouped(200, 6, seed=9)
    host = _ref_fields(ref_scan.WelfordZScore(2.0), 8, np.random.RandomState(1))
    a = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    b = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    (za,), _ = kind.plain(a, torch.from_numpy(slots), torch.from_numpy(vals))
    (zb,), _ = port_scan.generic_scan_body(kind)(b, torch.from_numpy(slots), torch.from_numpy(vals))
    np.testing.assert_allclose(za.numpy(), zb.numpy(), atol=1e-4)
    for name in host:
        np.testing.assert_allclose(a[name][:7].numpy(), b[name][:7].numpy(), rtol=1e-5)


def test_reference_zscore_body_cancels_in_large_batches():
    """ROADMAP C: the JAX package's z-score body takes batch-wide
    float32 cumsums and subtracts their value at each segment head, so
    a segment's small sums (the squares of near-equal values) lose
    their digits in a large batch.  The port's plain body (prefix sums
    that restart at each head) stays within 1e-4 of a float64 oracle
    where the reference is off by more than 1."""
    rng = np.random.RandomState(600)
    n, n_keys, capacity = 1 << 16, 600, 1024
    keys = np.sort(rng.randint(0, n_keys, n))
    slots = keys.astype(np.int32)
    vals = (rng.randn(n) * 5 + 20).astype(np.float32)
    # float64 oracle: the host mapper, per key, in order.
    want = np.zeros(n)
    mapper = port_xla.zscore(3.0)
    states = {}
    for i, (k, v) in enumerate(zip(keys.tolist(), vals.astype(np.float64).tolist())):
        states[k], (_v, want[i], _a) = mapper(states.get(k), v)
    fields = {
        name: np.full(capacity, init, dtype=np.dtype(dt))
        for name, (init, dt) in ref_scan.WELFORD_FIELDS.items()
    }
    (ref_z,), _ = ref_scan.zscore_scan_body(
        {k: jnp.asarray(v) for k, v in fields.items()}, jnp.asarray(slots), jnp.asarray(vals)
    )
    (port_z,), _ = port_scan.zscore_scan_body(
        {k: torch.from_numpy(v.copy()) for k, v in fields.items()},
        torch.from_numpy(slots),
        torch.from_numpy(vals),
    )
    scale = np.maximum(1.0, np.abs(want))
    assert np.max(np.abs(port_z.numpy() - want) / scale) <= 1e-4
    assert np.max(np.abs(np.asarray(ref_z) - want)) > 1.0


def test_welford_merge_matches_sequential():
    rng = np.random.RandomState(3)
    xs = rng.randn(100)

    def summarize(arr):
        c, m, s = 0, 0.0, 0.0
        for v in arr:
            c += 1
            d = v - m
            m += d / c
            s += d * (v - m)
        return c, m, s

    def as_torch(t):
        return (torch.tensor(t[0], dtype=torch.int32), torch.tensor(t[1], dtype=torch.float32),
                torch.tensor(t[2], dtype=torch.float32))

    count, mean, m2 = summarize(xs)
    n, me, s2 = port_scan.welford_merge(as_torch(summarize(xs[:50])), as_torch(summarize(xs[50:])))
    assert int(n) == count
    assert float(me) == pytest.approx(mean, abs=1e-5)
    assert float(s2) == pytest.approx(m2, rel=1e-4)


def test_count_stays_exact_past_fp24():
    big = 1 << 24
    st = port_sa.DeviceScanState(port_scan.WelfordZScore(3.0))
    st.load_many([("a", (big, 0.0, 1000.0))])
    st.update(np.array(["a", "a"]), np.array([1.0, -1.0]))
    (count, _mean, _m2) = dict(st.snapshots_for(["a"]))["a"]
    assert count == big + 2


def test_reused_slot_starts_from_identity():
    """A discarded key's slot is reset (in one batched write) before
    another key's rows fold into it."""
    st = port_sa.DeviceScanState(port_scan.RunningExtrema())
    st.update(np.array(["a", "b"]), np.array([5.0, -3.0]))
    slot_a = st.key_to_slot["a"]
    st.discard("a")
    st.update(np.array(["c"]), np.array([1.0]))
    assert st.key_to_slot["c"] == slot_a
    assert dict(st.snapshots_for(["c", "b"])) == {"c": (1.0, 1.0), "b": (-3.0, -3.0)}


# -- the kernel's single-pass decomposition, modelled on the CPU -------------
#
# ``csrc/segment_scan.cu`` runs one launch a call: tiles claimed in order,
# each tile's aggregate (with the table state read at its last head)
# published as status A, or at once as an inclusive prefix P when the
# tile holds a head (whose element absorbs everything before it); a
# look-back over the predecessors that stops at the first P; then every
# row as
# ``carry ⊕ prefix``, and the tails written back.  The model below runs
# that algorithm over small tiles, with the tiles' steps interleaved in
# a random order under a bound on the tiles in flight, status words
# tagged with the call's sequence number and kept across calls, and
# checks that no tail is written before its head was read.  The kernel
# itself cannot run here (no nvcc); this finds a fault in the algorithm
# before the card does.

_ST_A, _ST_P = 1, 2


def _model_scan(kind, fields, slots, values, tile_rows, resident, work, rng):
    """One kernel call, modelled: updates ``fields`` in place and
    returns the output columns.  ``work`` carries the sequence number
    and the status words from call to call, as the workspace does."""
    names = tuple(kind.fields)
    capacity = fields[names[0]].shape[0]
    n = slots.shape[0]
    ntiles = -(-n // tile_rows)
    tag = work["calls"] + 1
    status = work["status"]  # tile -> (tag, state, element)
    ident_cols = tuple(torch.full((1,), init, dtype=dt) for init, dt in kind.fields.values())
    ident = (False, ident_cols, ident_cols)

    def combine(a, b):
        if b[0]:
            return b
        return (a[0], kind.merge(a[1], b[1]), a[2])

    outs = None
    ctx = {}
    read = set()

    def load(t):
        lo, hi = t * tile_rows, min(n, (t + 1) * tile_rows)
        s = slots[lo:hi]
        prev = torch.cat([slots[lo - 1 : lo] if lo > 0 else torch.tensor([-1], dtype=s.dtype), s[:-1]])
        nxt = torch.cat([s[1:], slots[hi : hi + 1] if hi < n else torch.tensor([-1], dtype=s.dtype)])
        head, tail = s != prev, s != nxt
        valid = (s >= 0) & (s < capacity)
        take = head & valid
        idx = s.long().clamp(0, capacity - 1)
        carry = tuple(torch.where(take, fields[nm][idx], i) for nm, i in zip(names, ident_cols))
        read.update(s[take].tolist())
        x = kind.lift(values[lo:hi])
        incl = port_scan._segmented_inclusive(kind.merge, head, x)
        flag = bool(head.any())
        last = int(torch.nonzero(head).max()) if flag else 0
        total = (flag, tuple(c[-1:] for c in incl), tuple(c[last : last + 1] for c in carry) if flag else ident_cols)
        ctx[t] = (lo, hi, s, head, tail, valid, carry, incl, total)
        if t == 0 or flag:
            status[t] = (tag, _ST_P, total)
        else:
            status[t] = (tag, _ST_A, total)

    def look_back(t):
        """The tile's exclusive prefix, or None while a status it needs
        is not yet published in this call."""
        acc = ident
        for k in range(t - 1, -1, -1):
            word = status.get(k)
            if word is None or word[0] != tag:
                return None
            acc = combine(word[2], acc)
            if word[1] == _ST_P:
                return acc
        msg = "the look-back passed tile 0"
        raise AssertionError(msg)

    def rows(t, excl):
        nonlocal outs
        lo, hi, s, head, tail, valid, carry, incl, _total = ctx[t]
        pos = torch.arange(hi - lo)
        head_pos = torch.cummax(torch.where(head, pos, -1), 0).values
        seen = head_pos >= 0
        hp = head_pos.clamp(min=0)
        c = tuple(torch.where(seen, col[hp], e) for col, e in zip(carry, excl[2]))
        st_in = tuple(
            torch.where(seen, i, m.to(i.dtype)) for i, m in zip(incl, kind.merge(excl[1], incl))
        )
        st_ex = tuple(
            torch.where(head, i, torch.cat([e, col[:-1]]))
            for col, e, i in zip(st_in, excl[1], ident_cols)
        )
        pre = kind.merge(c, st_ex)
        post = kind.merge(c, st_in)
        got = kind.emit(pre, post, values[lo:hi])
        if outs is None:
            outs = tuple(torch.empty(n, dtype=o.dtype) for o in got)
        for o, g in zip(outs, got):
            o[lo:hi] = g
        write = tail & valid
        assert set(s[write].tolist()) <= read, "a tail was written before its head was read"
        for nm, p in zip(names, post):
            fields[nm][s[write].long()] = p[write].to(fields[nm].dtype)

    step = {}
    prefix = {}
    claimed = 0
    while len(step) < ntiles or any(v < 3 for v in step.values()):
        live = [t for t, v in step.items() if v < 3]
        options = ["claim"] if claimed < ntiles and len(live) < resident else []
        for t in live:
            if step[t] == 1:
                found = look_back(t) if t > 0 else ident
                if found is None:
                    continue
                prefix[t] = found
            options.append(t)
        assert options, "the look-back deadlocked"
        pick = options[rng.randint(len(options))]
        if pick == "claim":
            step[claimed] = 0
            claimed += 1
        elif step[pick] == 0:
            load(pick)
            step[pick] = 1
        elif step[pick] == 1:
            total = ctx[pick][-1]
            if pick > 0 and not total[0]:
                status[pick] = (tag, _ST_P, combine(prefix[pick], total))
            step[pick] = 2
        else:
            rows(pick, prefix[pick])
            step[pick] = 3
    work["calls"] = tag
    return outs


#: name -> (rows, keys, capacity): the three key layouts of
#: ``SCAN_LAYOUTS`` in ``test_torch_kernel_cuda.py`` at 1,536 rows
#: (segments of about 128 rows, one key, mostly one-row segments); the
#: random tile sizes leave a ragged last tile.
MODEL_LAYOUTS = {
    "many_keys": (1536, 12, 64),
    "one_key": (1536, 1, 16),
    "one_row_segments": (1536, 1536, 4096),
}
MODEL_KINDS = {
    "welford": lambda: port_scan.WelfordZScore(3.0),
    "ema": lambda: port_scan.Ema(0.3),
    "ema_alpha1": lambda: port_scan.Ema(1.0),
    "ema_tiny": lambda: port_scan.Ema(1e-8),
    "extrema_nan": lambda: port_scan.RunningExtrema(),
}


def _model_table(kind, capacity, resumed, rng):
    fields = {name: torch.full((capacity,), init, dtype=dt) for name, (init, dt) in kind.fields.items()}
    if resumed:
        m = capacity - 1
        count = torch.from_numpy(rng.randint(0, 40, m).astype(np.int32))
        level = torch.from_numpy((rng.randn(m) * 5 + 20).astype(np.float32))
        if kind.kernel == "welford":
            fields["count"][:m] = count
            fields["mean"][:m] = level
            fields["m2"][:m] = torch.from_numpy((rng.rand(m) * 30).astype(np.float32)) * (count - 1).clamp(min=0)
        elif kind.kernel == "ema":
            fields["count"][:m] = count
            fields["s"][:m] = level * (1 - (1 - kind.alpha) ** count.double()).float()
        else:
            fields["mn"][:m] = level
            fields["mx"][:m] = level + torch.from_numpy((rng.rand(m) * 10).astype(np.float32))
    return fields


def _model_close(got, want, rtol, what):
    err = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
    assert float(err.max()) <= rtol, f"{what}: error {float(err.max())}"


def _model_same(got, want, what):
    if got.is_floating_point():
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), f"{what}: NaN in other places"
        got, want = got[~nan], want[~nan]
    assert torch.equal(got, want), f"{what}: {int((got != want).sum())} differ"


@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
@pytest.mark.parametrize("layout", sorted(MODEL_LAYOUTS))
@pytest.mark.parametrize("name", sorted(MODEL_KINDS))
def test_single_pass_model_matches_plain(name, layout, resumed):
    """The kernel's algorithm, modelled over tiles of 4 to 64 rows
    visited in a random interleaving, against ``kind.plain``: two calls
    back to back (the second over fewer rows, with the first call's
    stale status words still in place), counts and extrema exact (NaN
    in the same places), other float32 state within 1e-5 relative, z
    within 1e-4 of max(1, |z|), the EMA within 1e-4 relative."""
    kind = MODEL_KINDS[name]()
    n, n_keys, capacity = MODEL_LAYOUTS[layout]
    rng = np.random.RandomState(sorted(MODEL_KINDS).index(name) * 10 + len(layout) + resumed)
    fields = _model_table(kind, capacity, resumed, rng)
    work = {"calls": 0, "status": {}}
    slot_of = rng.permutation(capacity - 1)[:n_keys].astype(np.int32)
    for rows in (n, n // 3 + 5):
        keys = np.sort(rng.randint(0, n_keys, rows))
        vals = (rng.randn(rows) * 5 + 20).astype(np.float32)
        if name == "extrema_nan":
            vals[rng.rand(rows) < 0.01] = np.nan
        slots = torch.from_numpy(slot_of[keys])
        values = torch.from_numpy(vals)
        want = {k: v.clone() for k, v in fields.items()}
        want_outs, _ = kind.plain(want, slots, values)
        tile = int(rng.randint(4, 65))
        got_outs = _model_scan(kind, fields, slots, values, tile, int(rng.randint(1, 5)), work, rng)
        real = slice(0, capacity - 1)  # the plain versions write non-tail rows to scratch
        for fname, (_init, dt) in kind.fields.items():
            g, w = fields[fname][real], want[fname][real]
            if dt == torch.int32 or kind.kernel == "extrema":
                _model_same(g, w, fname)
            else:
                _model_close(g, w, 1e-5, fname)
        for i, (g, w) in enumerate(zip(got_outs, want_outs)):
            if kind.kernel == "extrema":
                _model_same(g, w, f"out{i}")
            else:
                _model_close(g, w, 1e-4, "z" if kind.kernel == "welford" else "ema")
    if name == "extrema_nan":
        assert bool(torch.isnan(fields["mn"]).any())


# -- whole flows -------------------------------------------------------------


def _capped_decay_jax(state, v):
    total, n = state
    total = jnp.minimum(total * 0.9 + v, 12.0)
    return (total, n + 1), (total, n + 1)


def _capped_decay_torch(state, v):
    total, n = state
    total = torch.clamp(total * 0.9 + v, max=12.0)
    return (total, n + 1), (total, n + 1)


def _mapper(pkg, kind):
    xla = pkg["xla"]
    if kind == "zscore":
        return xla.zscore(2.5)
    if kind == "ema":
        return xla.ema(0.3)
    if kind == "extrema":
        return xla.running_extrema()
    if pkg is REF:
        return xla.jax_stateful_map(_capped_decay_jax, (0.0, 0))
    return xla.torch_stateful_map(_capped_decay_torch, (0.0, 0))


def _scan_flow(pkg, kind, inp, out, batch_size=8):
    op = pkg["op"]
    flow = pkg["Dataflow"]("scan_flow")
    s = op.input("inp", flow, pkg["Source"](inp, batch_size=batch_size))
    s = op.stateful_map("scan", s, _mapper(pkg, kind))
    op.output("out", s, pkg["Sink"](out))
    return flow


@pytest.mark.parametrize("kind", ["zscore", "ema", "extrema", "udf"])
def test_scan_flow_matches_reference(kind):
    items = _grid_items(n=250, n_keys=5, seed=21)
    flow = _scan_flow(PORT, kind, items, [])
    specs = [o.conf.get("_accel") for o in port_flatten(flow).ops if o.name == "stateful_batch"]
    assert len(specs) == 1 and isinstance(specs[0], port_sa.ScanAccelSpec)
    got, want = [], []
    port_run_main(_scan_flow(PORT, kind, items, got))
    ref_run_main(_scan_flow(REF, kind, items, want))
    _assert_rows_close(got, want)
    if kind == "zscore":
        assert any(row[2] for _k, row in want)
    if kind == "udf":
        # The int state field stays an exact int through the device tier.
        assert all(isinstance(row[-1], int) for _k, row in got)


@pytest.mark.parametrize("columnar", [False, True], ids=["items", "columnar"])
def test_anomaly_flow_matches_reference(columnar):
    """The whole anomaly detector through both packages' ``run_main``,
    over itemized rows or dictionary-encoded batches."""
    from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
    from bytewax_tpu.models.brc import ArrayBatchSource as RefBatches
    from bytewax_tpu_torch.engine.arrays import ArrayBatch as PortBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource as PortBatches

    items = _grid_items(n=400, n_keys=6, seed=7)
    outs = {}
    for name, pkg, batch, batches in (
        ("jax", REF, RefBatch, RefBatches),
        ("torch", PORT, PortBatch, PortBatches),
    ):
        if columnar:
            vocab = np.array([f"k{i}" for i in range(6)])
            ids = np.array([int(k[1:]) for k, _v in items], dtype=np.int32)
            vals = np.array([v for _k, v in items], dtype=np.float32)
            source = batches(
                [batch({"key_id": ids[i : i + 32], "value": vals[i : i + 32]}, key_vocab=vocab)
                 for i in range(0, len(items), 32)]
            )
        else:
            source = pkg["Source"](items, batch_size=16)
        outs[name] = []
        pkg["run_main"](pkg["anomaly"].anomaly_flow(source, pkg["Sink"](outs[name]), threshold=2.5))
    _assert_rows_close(outs["torch"], outs["jax"])
    assert sum(row[2] for _k, row in outs["jax"]) > 0


def test_annotation_leaves_other_mappers_on_the_host():
    """A ScanMap whose device_kind is None, and a plain mapper, lower
    to nothing and run as host mappers."""

    class Running(port_xla.ScanMap):
        kind = "running_sum"

        def __call__(self, st, v):
            total = (st or 0.0) + v
            return total, total

    out = []
    flow = PortDataflow("scan_host")
    s = port_op.input("inp", flow, PortSource([("a", 1.0), ("a", 2.0)]))
    s = port_op.stateful_map("m", s, Running())
    s = port_op.stateful_map("p", s, lambda st, v: ((st or 0) + v, v))
    port_op.output("out", s, PortSink(out))
    specs = [o.conf.get("_accel") for o in port_flatten(flow).ops if o.name == "stateful_batch"]
    assert specs == [None, None]
    port_run_main(flow)
    assert out == [("a", 1.0), ("a", 3.0)]


def test_non_numeric_values_fall_back_to_host():
    # String values cannot ride the device scan: the step falls back
    # to the host tier, whose mapper raises its own TypeError.
    out = []
    flow = _scan_flow(PORT, "zscore", [("a", "x"), ("a", "x"), ("b", "y")], out, batch_size=2)
    with pytest.raises(TypeError):
        port_run_main(flow)


def test_torch_stateful_map_rejects_bad_fns_at_construction():
    def branchy(state, v):
        (total,) = state
        if total > 50:  # data-dependent Python control flow
            total = total * 0
        return (total + v,), (total,)

    with pytest.raises(TypeError, match="vmap"):
        port_xla.torch_stateful_map(branchy, (0.0,))

    def shrinker(state, v):
        total, _n = state
        return (total + v,), (total,)

    with pytest.raises(TypeError, match="state fields"):
        port_xla.torch_stateful_map(shrinker, (0.0, 0))

    def ok(state, v):
        (total,) = state
        return (torch.clamp(total + v, max=9.0),), (total,)

    assert port_xla.torch_stateful_map(ok, (0.0,)) is not None


def _latch(state, v):
    (armed,) = state
    return (armed | (v > 5.0),), (armed | (v > 5.0),)


def test_torch_stateful_map_bool_state_snapshots(tmp_path, monkeypatch):
    """Bool state snapshots as exact Python bools on the device tier,
    and the host tier resumes from them with the same semantics."""
    port_init_db_dir(tmp_path, 1)
    rc = PortRecoveryConfig(str(tmp_path))
    items = [("a", 1.0), ("a", 9.0), ("b", 2.0)]
    tail = [("a", 0.5), ("b", 1.0)]
    inp = items + [PortSource.ABORT()] + tail

    def build(out):
        flow = PortDataflow("scan_bool")
        s = port_op.input("inp", flow, PortSource(inp, batch_size=1))
        s = port_op.stateful_map("scan", s, port_xla.torch_stateful_map(_latch, (False,)))
        port_op.output("out", s, PortSink(out))
        return flow

    out1 = []
    port_run_main(build(out1), epoch_interval=timedelta(0), recovery_config=rc)
    store = PortStore(str(tmp_path))
    try:
        snaps = {k: pickle.loads(ser) for sid, k, ser in store.iter_snaps(10**6) if "stateful_batch" in sid}
    finally:
        store.close()
    assert snaps == {"a": (True,), "b": (False,)}
    assert all(type(s[0]) is bool for s in snaps.values())
    out2 = []
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    port_run_main(build(out2), epoch_interval=timedelta(0), recovery_config=rc)
    assert out1 + out2 == [
        ("a", (1.0, False)),
        ("a", (9.0, True)),
        ("b", (2.0, False)),
        ("a", (0.5, True)),
        ("b", (1.0, False)),
    ]


# -- cross-package resume (recovery stores interchange) -----------------------


def _resume_run(pkg, db, inp, out, spent_abort):
    """One run of ``anomaly_flow`` over ``inp`` (an ABORT sentinel at
    its place) against the store in ``db``."""
    abort = pkg["Source"].ABORT()
    abort._triggered = spent_abort
    rows = [abort if x is None else x for x in inp]
    flow = pkg["anomaly"].anomaly_flow(pkg["Source"](rows, batch_size=8), pkg["Sink"](out), threshold=2.5)
    pkg["run_main"](flow, epoch_interval=timedelta(0), recovery_config=pkg["RecoveryConfig"](str(db)))


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_anomaly_store_resumes_across_packages(tmp_path, first, second):
    """A store that one package's ``anomaly_flow`` wrote before an
    abort resumes in the other package, and the output continues as
    the first package's own resume continues it."""
    items = _grid_items(n=120, n_keys=4, seed=31)
    inp = items[:70] + [None] + items[70:]
    (tmp_path / "own").mkdir()
    PKGS[first]["init_db_dir"](tmp_path / "own", 1)
    head = []
    _resume_run(PKGS[first], tmp_path / "own", inp, head, spent_abort=False)
    assert len(head) == 70
    shutil.copytree(tmp_path / "own", tmp_path / "other")
    own, other = [], []
    _resume_run(PKGS[first], tmp_path / "own", inp, own, spent_abort=True)
    _resume_run(PKGS[second], tmp_path / "other", inp, other, spent_abort=True)
    assert len(own) == len(items) - 70
    _assert_rows_close(other, own)
