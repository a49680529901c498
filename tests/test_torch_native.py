"""The native host runtime of the torch port (``native/``: the C++
1BRC parser and the C host ops) held against the JAX package: each
case of ``tests/test_native.py`` runs the same bytes or items through
both packages' native functions and compares their results, and
``BrcFileSource`` feeds the same stations to both packages'
``stats_final``.

Parsed values, ids, vocabularies, offsets, grouped items and encoded
columns must be equal; the 1BRC means to ``rtol=atol=1e-5`` against
each other (and within the reference's own bounds of the oracle).
"""

from datetime import timedelta

import numpy as np
import pytest

import bytewax_tpu.engine.driver as ref_driver
import bytewax_tpu_torch.engine.driver as port_driver
from bytewax_tpu import native as ref_native
from bytewax_tpu.models import brc as ref_brc
from bytewax_tpu_torch import native as port_native
from bytewax_tpu_torch.models import brc as port_brc
from tests.torch_entry_points import (  # noqa: F401
    PKGS,
    PORT,
    REF,
    port_deliveries,
    port_on_cpu,
    unsharded,
)

NATIVE = {REF["name"]: ref_native, PORT["name"]: port_native}
BRC = {REF["name"]: ref_brc, PORT["name"]: port_brc}
DRIVER = {REF["name"]: ref_driver, PORT["name"]: port_driver}
NATIVES = (ref_native, port_native)


@pytest.fixture(scope="module")
def parsers():
    if not (ref_native.is_available() and port_native.is_available()):
        pytest.skip("native toolchain unavailable")
    return ref_native.BrcParser(), port_native.BrcParser()


def test_brc_parse(parsers):
    outs = []
    for parser in parsers:
        ids, temps = parser.parse(b"oslo;-3.5\nrome;18.2\noslo;0.0\n")
        assert temps.tolist() == [-35, 182, 0]
        assert parser.vocab()[ids].tolist() == ["oslo", "rome", "oslo"]
        outs.append((ids.tolist(), temps.dtype, parser.vocab().tolist()))
    assert outs[1] == outs[0]


def test_brc_vocab_stable_across_chunks(parsers):
    ids = []
    for parser in parsers:
        ids1, _ = parser.parse(b"oslo;1.0\n")
        ids2, _ = parser.parse(b"oslo;2.0\n")
        assert ids1[0] == ids2[0]
        ids.append((ids1.tolist(), ids2.tolist()))
    assert ids[1] == ids[0]


def test_brc_malformed():
    """A value that is not a number raises the same ``ValueError`` in
    both packages."""
    if not port_native.is_available():
        pytest.skip("native toolchain unavailable")
    msgs = []
    for native in NATIVES:
        with pytest.raises(ValueError, match="malformed") as info:
            native.BrcParser().parse(b"oslo;abc\n")
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


#: Lines outside the 1BRC format (one decimal digit after the point)
#: and what both parsers make of them, in tenths of a degree: a line
#: with no separator is skipped, an empty station name is a station,
#: and the digits are read as tenths whatever the point's place.
LENIENT = [
    (b"oslo\n", [], []),
    (b";1.0\n", [""], [10]),
    (b"oslo;1\n", ["oslo"], [1]),
    (b"oslo;1.05\n", ["oslo"], [105]),
]


@pytest.mark.parametrize("chunk,stations,tenths", LENIENT)
def test_brc_lenient_lines_parse_like_the_reference(chunk, stations, tenths):
    """The port's parser reads lines outside the format as the JAX
    package's does (the reference's behaviour, pinned)."""
    if not port_native.is_available():
        pytest.skip("native toolchain unavailable")
    for native in NATIVES:
        parser = native.BrcParser()
        ids, temps = parser.parse(chunk)
        assert parser.vocab()[ids].tolist() == stations, native.__name__
        assert temps.tolist() == tenths, native.__name__


def test_split_point(parsers):
    for parser in parsers:
        assert parser.split_point(b"a;1.0\nb;2") == 6
        assert parser.split_point(b"no-newline") == 0


def _brc_file(tmp_path):
    path = tmp_path / "measurements.txt"
    rng = np.random.RandomState(0)
    lines = []
    for _ in range(5000):
        lines.append(f"st{rng.randint(20)};{rng.randint(-999, 999) / 10:.1f}")
    path.write_text("\n".join(lines) + "\n")
    return path, lines


def test_brc_file_source_end_to_end(tmp_path, port_deliveries):
    """``BrcFileSource`` over 3 partitions in 4 KiB chunks into
    ``stats_final``: each package's output against the plain Python
    oracle as ``tests/test_native.py`` bounds it, counts, min and max
    equal across the packages, means within 1e-5; the port folds every
    line on its device tier."""
    if not port_native.is_available():
        pytest.skip("native toolchain unavailable")
    path, lines = _brc_file(tmp_path)
    expect = {}
    for line in lines:
        k, v = line.split(";")
        v = float(v)
        mn, mx, tot, ct = expect.get(k, (float("inf"), float("-inf"), 0.0, 0))
        expect[k] = (min(mn, v), max(mx, v), tot + v, ct + 1)
    outs = []
    for pkg in PKGS:
        out = []
        flow = pkg["Dataflow"]("brc_native")
        s = pkg["op"].input(
            "inp", flow, BRC[pkg["name"]].BrcFileSource(path, part_count=3, chunk_bytes=4096)
        )
        pkg["op"].output("out", pkg["xla"].stats_final("stats", s), pkg["Sink"](out))
        pkg["run_main"](flow)
        got = dict(out)
        assert set(got) == set(expect)
        for k, (mn, mx, tot, ct) in expect.items():
            gmn, gmean, gmx, gct = got[k]
            assert gct == ct, k
            assert abs(gmn - mn) < 1e-4 and abs(gmx - mx) < 1e-4
            assert abs(gmean - tot / ct) < 1e-3
        outs.append(got)
    ref, port = outs
    for k, (mn, mean, mx, ct) in ref.items():
        assert (port[k][0], port[k][2], port[k][3]) == (mn, mx, ct), k
        np.testing.assert_allclose(port[k][1], mean, rtol=1e-5, atol=1e-5, err_msg=k)
    assert sum(port_deliveries) == len(lines)


@pytest.mark.parametrize("part_count", [1, 3])
def test_brc_file_source_resumes_across_packages(part_count, tmp_path):
    """A ``BrcFileSource`` partition's byte-offset snapshot, taken by
    either package after any chunk, resumes in the other to exactly
    the rest of that partition's lines."""
    if not port_native.is_available():
        pytest.skip("native toolchain unavailable")
    path, _lines = _brc_file(tmp_path)

    def rows(part):
        got = []
        while True:
            try:
                b = part.next_batch()
            except StopIteration:
                return got
            vocab = np.asarray(b.key_vocab)
            got.extend(zip(vocab[b.cols["key_id"]].tolist(), b.cols["value"].tolist()))

    for src_pkg, dst_pkg in ((REF, PORT), (PORT, REF)):
        src = BRC[src_pkg["name"]].BrcFileSource(path, part_count=part_count, chunk_bytes=4096)
        dst = BRC[dst_pkg["name"]].BrcFileSource(path, part_count=part_count, chunk_bytes=4096)
        assert dst.list_parts() == src.list_parts()
        for name in src.list_parts():
            whole = rows(src.build_part("inp", name, None))
            assert whole == rows(dst.build_part("inp", name, None))
            part, done = src.build_part("inp", name, None), []
            while True:
                assert done + rows(dst.build_part("inp", name, part.snapshot())) == whole
                try:
                    b = part.next_batch()
                except StopIteration:
                    break
                vocab = np.asarray(b.key_vocab)
                done.extend(zip(vocab[b.cols["key_id"]].tolist(), b.cols["value"].tolist()))


def test_group_kv_fast_path():
    outs = []
    for native in NATIVES:
        got = native.group_kv([("a", 1), ("b", 2), ("a", 3)])
        if got is None:
            pytest.skip("no toolchain for the host_ops extension")
        assert got == {"a": [1, 3], "b": [2]}
        # Non-tuple rows and non-str keys raise, so the driver falls
        # back to its permissive Python loop.
        with pytest.raises(TypeError):
            native.group_kv([("a", 1), ["b", 2]])
        with pytest.raises(TypeError):
            native.group_kv([(1, "a")])
        obj = object()
        assert native.group_kv([("k", obj)])["k"][0] is obj
        outs.append(got)
    assert outs[1] == outs[0]


def test_group_kv_matches_python_loop_in_dataflow(monkeypatch):
    """The host tier with the native grouping and with it stubbed off
    give the same running sums, in both packages alike."""
    inp = [(f"k{i % 7}", i) for i in range(500)]
    outs = []
    for pkg in PKGS:

        def build(out, pkg=pkg):
            flow = pkg["Dataflow"]("native_df")
            s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=64))
            s = pkg["op"].stateful_map("sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
            pkg["op"].output("out", s, pkg["Sink"](out))
            return flow

        fast = []
        pkg["run_main"](build(fast))
        with monkeypatch.context() as m:
            m.setattr(DRIVER[pkg["name"]], "_native_group_kv", lambda items: None)
            slow = []
            pkg["run_main"](build(slow))
        assert fast == slow, pkg["name"]
        outs.append(fast)
    assert outs[1] == outs[0]


def _encode(native, batches, ivals=False):
    """``kv_encode`` of each batch in turn into one id dict; returns
    each call's result with the filled columns."""
    iddict, got = {}, []
    for items in batches:
        n = len(items)
        ids = np.empty(n, dtype=np.int32)
        vals = np.empty(n, dtype=np.float64)
        extra = (np.empty(n, dtype=np.int64),) if ivals else ()
        res = native.kv_encode(items, iddict, ids, vals, *extra)
        if res is None:
            pytest.skip("no native toolchain")
        got.append((res, ids.tolist(), vals.tolist(), [e.tolist() for e in extra]))
    return iddict, got


def test_kv_encode_basic():
    outs = []
    for native in NATIVES:
        iddict, got = _encode(native, [[("a", 1), ("b", 2.5), ("a", 3)], [("b", 4), ("c", 5)]])
        (new_keys, all_int), ids, vals, _ = got[0]
        assert new_keys == ["a", "b"] and all_int == 0  # 2.5 is a float
        assert ids == [0, 1, 0] and vals == [1.0, 2.5, 3.0]
        (new2, all_int2), ids2, _vals2, _ = got[1]
        assert new2 == ["c"] and all_int2 == 1 and ids2 == [1, 2]
        assert iddict == {"a": 0, "b": 1, "c": 2}
        outs.append(got)
    assert outs[1] == outs[0]


def test_kv_encode_rolls_back_on_error():
    for native in NATIVES:
        iddict = {"pre": 0}
        try:
            res = native.kv_encode([], iddict, np.empty(0, np.int32), np.empty(0, np.float64))
        except TypeError:
            res = None
        if res is None:
            pytest.skip("no native toolchain")
        items = [("pre", 1), ("new1", 2), ("bad", "not-a-number")]
        with pytest.raises(TypeError):
            native.kv_encode(items, iddict, np.empty(3, np.int32), np.empty(3, np.float64))
        assert iddict == {"pre": 0}  # the keys added before the failure rolled back


def test_kv_encode_int64_exact_past_2_53():
    """Exact-int streams keep exact values past float64's 2^53 in the
    int64 lane, in both packages."""
    big = (1 << 53) + 1
    outs = []
    for native in NATIVES:
        _iddict, got = _encode(native, [[("a", big), ("a", 1), ("b", 7)]], ivals=True)
        (_new, all_int), _ids, vals, (ivals,) = got[0]
        assert all_int
        assert ivals == [big, 1, 7]
        assert int(vals[0]) != big  # the float lane rounds; the int lane is why
        outs.append(got)
    assert outs[1] == outs[0]


def test_kv_encode_int_overflow_falls_to_float():
    over = 1 << 70
    outs = []
    for native in NATIVES:
        _iddict, got = _encode(native, [[("a", over)]], ivals=True)
        (_new, all_int), _ids, vals, _ = got[0]
        assert not all_int
        assert vals[0] == float(over)
        outs.append(((_new, all_int), vals))
    assert outs[1] == outs[0]


def test_itemized_sums_through_kv_encode_match_reference(port_deliveries):
    """Itemized ``(str, int)`` rows promote onto the device tier
    through ``kv_encode`` (ints past 2^24 and negatives included) and
    sum exactly as in the JAX package."""
    rng = np.random.RandomState(3)
    inp = [(f"k{rng.randint(9)}", int(v)) for v in rng.randint(-(1 << 30), 1 << 30, size=600)]
    outs = []
    for pkg in PKGS:
        out = []
        flow = pkg["Dataflow"]("kv_sum")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=100))
        pkg["op"].output("out", pkg["op"].reduce_final("sum", s, pkg["xla"].SUM), pkg["Sink"](out))
        pkg["run_main"](flow, epoch_interval=timedelta(0))
        outs.append(sorted(out))
    sums = {}
    for k, v in inp:
        sums[k] = sums.get(k, 0) + v
    assert outs[0] == outs[1] == sorted(sums.items())
    assert port_deliveries  # folded on the device tier
