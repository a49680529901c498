"""Columnar ingest of the torch port held against the JAX package:
batch-native sources, chunked line decode with exact byte-offset
resume, the CSV reader's columnar fast path and its fall-backs, the
adaptive micro-batch coalescer (``engine/batching.py`` and the
driver's ``_InputRt._coalesce``), the lowering pass's
``_accel_bound`` annotation, stdin and the demo source.

Each case of ``tests/test_columnar_ingest.py`` runs the same input
through both packages and compares the outputs, counters and
snapshots.  A byte-offset snapshot that ``FileSource`` or ``CSVSource``
of one package takes at any chunk boundary resumes in the other.

The JAX package pads every device dispatch to a power-of-two ladder
and pins its compile count (``test_bucketed_padding_bounds_compiles``,
``test_pad_len_bucket_ladder``).  The port runs eagerly and has no
ladder; its counterparts hold what it promises instead: 100 seeded
random batch lengths up to 30,000 rows fold, one fold a batch with
exactly the batch's rows, to the JAX package's output.

Tolerances: integer sums, counts, keys, strings, byte offsets and
counters exactly; float values as each package parses them, exactly.
"""

import io
import os
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import bytewax_tpu.engine.driver as ref_driver
import bytewax_tpu_torch.engine.driver as port_driver
from bytewax_tpu.connectors import demo as ref_demo
from bytewax_tpu.connectors import files as ref_files
from bytewax_tpu.connectors import stdio as ref_stdio
from bytewax_tpu.engine import batching as ref_batching
from bytewax_tpu.engine import flight as ref_flight
from bytewax_tpu.ops import text as ref_text
from bytewax_tpu_torch.connectors import demo as port_demo
from bytewax_tpu_torch.connectors import files as port_files
from bytewax_tpu_torch.connectors import stdio as port_stdio
from bytewax_tpu_torch.engine import batching as port_batching
from bytewax_tpu_torch.engine import flight as port_flight
from bytewax_tpu_torch.ops import text as port_text
from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    PORT,
    REF,
    assert_same_error,
    entry,
    port_deliveries,
    port_folds,
    port_on_cpu,
    raised,
    recovery_config,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)

#: Each package's ingest modules, by the package's name.
INGEST = {
    REF["name"]: {
        "files": ref_files,
        "stdio": ref_stdio,
        "demo": ref_demo,
        "text": ref_text,
        "batching": ref_batching,
        "flight": ref_flight,
        "driver": ref_driver,
    },
    PORT["name"]: {
        "files": port_files,
        "stdio": port_stdio,
        "demo": port_demo,
        "text": port_text,
        "batching": port_batching,
        "flight": port_flight,
        "driver": port_driver,
    },
}
BY_NAME = {"jax": REF, "port": PORT}


def _ing(pkg):
    return INGEST[pkg["name"]]


def _counter(pkg, name):
    return _ing(pkg)["flight"].RECORDER.counters.get(name, 0)


def _columnar_source(pkg, batches):
    """``tests/test_columnar_ingest.py``'s ``_ColumnarSource`` over
    ``pkg``'s own classes: one partition of prebuilt batches with
    batch-index snapshots, honouring ``TestingSource.ABORT``
    sentinels between batches."""
    inputs = pkg["inputs"]

    class _Part(inputs.StatefulSourcePartition):
        def __init__(self, resume_state):
            self._idx = 0 if resume_state is None else resume_state

        def next_batch(self):
            if self._idx >= len(batches):
                raise StopIteration()
            b = batches[self._idx]
            if isinstance(b, pkg["Source"].ABORT):
                if b._triggered:
                    self._idx += 1
                    return []
                b._triggered = True
                raise inputs.AbortExecution()
            self._idx += 1
            return b

        def snapshot(self):
            return self._idx

    class _Source(inputs.FixedPartitionedSource):
        def list_parts(self):
            return ["batches"]

        def build_part(self, step_id, for_part, resume_state):
            return _Part(resume_state)

    return _Source()


def _kv_arrays(n_batches, rows, n_keys=8, seed=0):
    """``_kv_batches``'s columns: string keys and int64 values, every
    key recurring across batches."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        kids = rng.randint(0, n_keys, size=rows)
        out.append(
            (np.array([f"k{i}" for i in kids]), rng.randint(0, 100, size=rows).astype(np.int64))
        )
    return out


def _kv_batches(pkg, arrays):
    return [pkg["Batch"]({"key": k, "value": v}) for k, v in arrays]


def _sum_oracle(arrays):
    sums = {}
    for keys, vals in arrays:
        for k, v in zip(keys.tolist(), vals.tolist()):
            sums[k] = sums.get(k, 0) + v
    return sorted(sums.items())


def _sum_flow(pkg, flow_id, source, out):
    flow = pkg["Dataflow"](flow_id)
    s = pkg["op"].input("inp", flow, source)
    r = pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)
    pkg["op"].output("out", r, pkg["Sink"](out))
    return flow


def _flow_out(pkg, flow_id, source, **kwargs):
    """Run ``input -> output`` over ``source`` with ``pkg``'s
    ``run_main``; returns the items out."""
    out = []
    flow = pkg["Dataflow"](flow_id)
    s = pkg["op"].input("inp", flow, source)
    pkg["op"].output("out", s, pkg["Sink"](out))
    pkg["run_main"](flow, **kwargs)
    return out


# -- columnar sources end to end, all 3 entry points --------------------------


@pytest.mark.parametrize("entry_name", ENTRY_POINTS)
def test_columnar_source_matches_reference(entry_name):
    """``test_columnar_source_matches_host_oracle``: a batch-native
    source's sums on the device tier equal the oracle in both
    packages, and each counts every row as columnar ingest."""
    arrays = _kv_arrays(6, 50)
    outs = []
    for pkg in PKGS:
        c0 = _counter(pkg, "ingest_rows_columnar")
        out = []
        flow = _sum_flow(pkg, f"tcol_eq_{entry_name}", _columnar_source(pkg, _kv_batches(pkg, arrays)), out)
        entry(pkg, entry_name)(flow, epoch_interval=ZERO_TD)
        assert sorted(out) == _sum_oracle(arrays), pkg["name"]
        assert _counter(pkg, "ingest_rows_columnar") - c0 == 6 * 50, pkg["name"]
        outs.append(sorted(out))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("entry_name", ENTRY_POINTS)
@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_columnar_cross_tier_recovery(entry_name, first, second, monkeypatch, tmp_path):
    """``test_columnar_cross_tier_recovery``: a columnar run aborted
    mid-stream on the device tier resumes on the host tier exactly
    once, within the port and from each package's store in the
    other."""
    arrays = _kv_arrays(8, 25, seed=3)
    db = tmp_path / "db"
    flow_id = f"tcol_rec_{entry_name}"
    writer = BY_NAME[first]
    batches = _kv_batches(writer, arrays)
    inp = batches[:4] + [writer["Source"].ABORT()] + batches[4:]
    out1 = []
    entry(writer, entry_name)(
        _sum_flow(writer, flow_id, _columnar_source(writer, inp), out1),
        epoch_interval=ZERO_TD,
        recovery_config=recovery_config(writer, db),
    )
    assert out1 == []  # reduce_final emits at EOF, which the abort preempted
    reader = BY_NAME[second]
    spent = reader["Source"].ABORT()
    spent._triggered = True
    batches = _kv_batches(reader, arrays)
    out2 = []
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    entry(reader, entry_name)(
        _sum_flow(reader, flow_id, _columnar_source(reader, batches[:4] + [spent] + batches[4:]), out2),
        epoch_interval=ZERO_TD,
        recovery_config=reader["recovery"].RecoveryConfig(str(db)),
    )
    assert sorted(out2) == _sum_oracle(arrays)


# -- chunked line decode: exact resume at every boundary ----------------------


def _drain(part, col="line"):
    got = []
    while True:
        try:
            b = part.next_batch()
        except StopIteration:
            return got
        if isinstance(b, list):
            got.extend(b)
        elif len(b):
            got.extend(b.cols[col].tolist())


def _lines_file(tmp_path):
    lines = [f"line-{i}-{'x' * (i % 7)}" for i in range(40)]
    path = tmp_path / "lines.txt"
    path.write_text("\n".join(lines) + "\n")
    return path, lines


def test_chunked_line_resume_exact_at_every_boundary(tmp_path):
    """``test_chunked_line_resume_exact_at_every_boundary``: the port's
    columnar ``FileSource`` snapshotted after every poll resumes from
    each byte offset to exactly the rest of the file, and takes the
    JAX package's snapshots at the same polls."""
    path, lines = _lines_file(tmp_path)
    polls = {}
    for pkg in PKGS:
        src = _ing(pkg)["files"].FileSource(path, columnar=True, chunk_bytes=13)
        (part_name,) = src.list_parts()
        part = src.build_part("inp", part_name, None)
        prefix, snaps = [], []
        while True:
            snap = part.snapshot()
            snaps.append(snap)
            assert prefix + _drain(src.build_part("inp", part_name, snap)) == lines, snap
            try:
                b = part.next_batch()
            except StopIteration:
                break
            if len(b):
                prefix.extend(b.cols["line"].tolist())
        assert prefix == lines
        assert len(snaps) > 10  # chunk_bytes really did split the file up
        polls[pkg["name"]] = snaps
    assert polls[PORT["name"]] == polls[REF["name"]]


def _csv_file(tmp_path):
    rows = [f"r{i},{i * 3 % 17},{'q' * (i % 5)}" for i in range(40)]
    path = tmp_path / "rows.csv"
    path.write_text("name,val,pad\n" + "\n".join(rows) + "\n")
    return path


def _source_of(kind, pkg, path):
    files = _ing(pkg)["files"]
    if kind == "file":
        return files.FileSource(path, columnar=True, chunk_bytes=13)
    return files.CSVSource(path, columnar=True, chunk_bytes=17)


def _items_of(kind, part):
    """What a partition emits from here on, as plain items: lines, or
    CSV rows as dicts (columnar batches itemized)."""
    out = []
    while True:
        try:
            b = part.next_batch()
        except StopIteration:
            return out
        if isinstance(b, list):
            out.extend(b)
        elif kind == "file":
            out.extend(b.cols["line"].tolist())
        else:
            names = list(b.cols)
            cols = [b.cols[n].tolist() for n in names]
            out.extend(dict(zip(names, row)) for row in zip(*cols))


@pytest.mark.parametrize("kind", ["file", "csv"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_byte_offset_snapshots_resume_across_packages(kind, src, dst, tmp_path):
    """A ``FileSource`` or ``CSVSource`` byte-offset snapshot that one
    package takes after any poll (every chunk boundary, mid-line
    included) resumes in the other package's partition to exactly the
    items the snapshotting partition goes on to emit."""
    path = _lines_file(tmp_path)[0] if kind == "file" else _csv_file(tmp_path)
    writer, reader = BY_NAME[src], BY_NAME[dst]
    w_src, r_src = _source_of(kind, writer, path), _source_of(kind, reader, path)
    (part_name,) = w_src.list_parts()
    assert r_src.list_parts() == [part_name]
    whole = _items_of(kind, w_src.build_part("inp", part_name, None))
    assert whole == _items_of(kind, r_src.build_part("inp", part_name, None))
    part = w_src.build_part("inp", part_name, None)
    done, checked = [], 0
    while True:
        snap = part.snapshot()
        rest = _items_of(kind, r_src.build_part("inp", part_name, snap))
        assert done + rest == whole, snap
        checked += 1
        try:
            b = part.next_batch()
        except StopIteration:
            break
        done.extend(_items_of(kind, _OneBatch(b)))
    assert done == whole
    assert checked > 5


class _OneBatch:
    """A partition that emits one batch, then EOF (to itemize a batch
    with :func:`_items_of`)."""

    def __init__(self, batch):
        self._batch = batch

    def next_batch(self):
        if self._batch is None:
            raise StopIteration()
        b, self._batch = self._batch, None
        return b


def test_file_source_columnar_equals_itemized(tmp_path):
    """``test_file_source_columnar_equals_itemized``: the columnar
    reader split by ``split_fields`` and the itemized reader feed the
    same sums in both packages."""
    rng = np.random.RandomState(1)
    rows = [(f"s{rng.randint(6)}", int(rng.randint(0, 50))) for _ in range(300)]
    path = tmp_path / "kv.txt"
    path.write_text("".join(f"{k};{v}\n" for k, v in rows))
    oracle = {}
    for k, v in rows:
        oracle[k] = oracle.get(k, 0) + v

    def run(pkg, columnar):
        files, text = _ing(pkg)["files"], _ing(pkg)["text"]
        out = []
        flow = pkg["Dataflow"]("tfile_col_eq")
        if columnar:
            s = pkg["op"].input("inp", flow, files.FileSource(path, columnar=True, chunk_bytes=64))

            def parse(batch):
                cols = text.split_fields(batch.cols["line"], 2, ";")
                return pkg["Batch"]({"key": cols[0], "value": cols[1].astype(np.int64)})

            s = pkg["op"].flat_map_batch("parse", s, parse)
        else:
            s = pkg["op"].input("inp", flow, files.FileSource(path, batch_size=32))
            s = pkg["op"].map("parse", s, lambda ln: (ln.split(";")[0], int(ln.split(";")[1])))
        r = pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)
        pkg["op"].output("out", r, pkg["Sink"](out))
        pkg["run_main"](flow, epoch_interval=ZERO_TD)
        return sorted(out)

    for pkg in PKGS:
        assert run(pkg, True) == run(pkg, False) == sorted(oracle.items()), pkg["name"]


def _csv_run(pkg, path, flow_id, **kwargs):
    return _flow_out(pkg, flow_id, _ing(pkg)["files"].CSVSource(path, **kwargs))


def test_csv_source_columnar_fast_path_and_fallback(tmp_path):
    """``test_csv_source_columnar_fast_path_and_fallback``: plain CSV
    takes the column split with numeric columns cast; quoting falls
    back to ``csv.DictReader`` itemized, in both packages alike."""
    plain = tmp_path / "plain.csv"
    plain.write_text("name,score\na,1\nb,2\na,3\n")
    quoted = tmp_path / "quoted.csv"
    quoted.write_text('name,score\n"a,x",1\nb,2\n')
    for pkg in PKGS:
        assert _csv_run(pkg, plain, "tcsv_col", columnar=True) == [
            {"name": "a", "score": 1.0},
            {"name": "b", "score": 2.0},
            {"name": "a", "score": 3.0},
        ], pkg["name"]
        assert _csv_run(pkg, quoted, "tcsv_col_quoted", columnar=True) == [
            {"name": "a,x", "score": "1"},
            {"name": "b", "score": "2"},
        ], pkg["name"]


@pytest.mark.parametrize("chunk_bytes", [1 << 20, 8])
def test_csv_source_columnar_quoted_embedded_newlines(chunk_bytes, tmp_path):
    """``test_csv_source_columnar_quoted_embedded_newlines``: a quoted
    field holding newlines parses whole, in one chunk and across many
    8-byte chunk boundaries, in both packages."""
    path = tmp_path / "multiline.csv"
    path.write_text('name,note\na,"line one\nline two"\nb,plain\n')
    want = [{"name": "a", "note": "line one\nline two"}, {"name": "b", "note": "plain"}]
    for pkg in PKGS:
        got = _csv_run(pkg, path, f"tcsv_ml_{chunk_bytes}", columnar=True, chunk_bytes=chunk_bytes)
        assert got == want, pkg["name"]


def test_csv_source_columnar_refuses_parity_unsound_dialects(tmp_path):
    """``test_csv_source_columnar_refuses_parity_unsound_dialects``:
    ``escapechar`` and ``doublequote=False`` are refused up front with
    the JAX package's error; ``QUOTE_NONE`` chunks, columnar equal to
    itemized in both packages."""
    import csv as _csv

    path = tmp_path / "d.csv"
    path.write_text('h1,h2\na,"x"\n')
    for bad in ({"escapechar": "\\"}, {"doublequote": False}):
        errs = []
        for pkg in PKGS:
            src = _ing(pkg)["files"].CSVSource(path, columnar=True, **bad)
            errs.append(raised(lambda: src.build_part("s", src.list_parts()[0], None)))
        assert isinstance(errs[1], ValueError) and "quote parity" in str(errs[1])
        assert_same_error(errs[0], errs[1])

    qn = tmp_path / "qn.csv"
    qn.write_text('h1,h2\na,x"y\nb,z\n')
    outs = [
        _csv_run(pkg, qn, f"tcsv_qn_{columnar}", columnar=columnar, chunk_bytes=8,
                 quoting=_csv.QUOTE_NONE)
        for pkg in PKGS
        for columnar in (False, True)
    ]
    assert all(out == outs[0] for out in outs)


def test_csv_source_columnar_quoted_header_newline(tmp_path):
    """``test_csv_source_columnar_quoted_header_newline``."""
    path = tmp_path / "hdr.csv"
    path.write_text('a,"b\nc",d\n1,2,3\n')
    for pkg in PKGS:
        got = _csv_run(pkg, path, "tcsv_hdr_nl", columnar=True)
        assert got == [{"a": 1.0, "b\nc": 2.0, "d": 3.0}], pkg["name"]


def test_csv_source_columnar_sticky_column_types(tmp_path):
    """``test_csv_source_columnar_sticky_column_types``: the numeric
    cast is decided once a run, so a non-numeric cell sends only its
    own batch itemized as strings, in both packages."""
    path = tmp_path / "sticky.csv"
    path.write_text("k,v\n" + "a,1\n" * 5 + "b,x\n" + "c,2\n")
    outs = []
    for pkg in PKGS:
        out = _csv_run(pkg, path, "tcsv_sticky", columnar=True, chunk_bytes=12)
        by_key = {}
        for row in out:
            by_key.setdefault(row["k"], []).append(row["v"])
        assert by_key["a"] == [1.0, 1.0, 1.0, "1", "1"], pkg["name"]
        assert by_key["b"] == ["x"]
        assert by_key["c"] == [2.0]
        outs.append(out)
    assert outs[1] == outs[0]


def test_split_fields_byte_lines():
    """``test_split_fields_byte_lines``: ``encoding=None`` byte lines
    split and cast in the port as in the JAX package."""
    got = []
    for pkg in PKGS:
        text = _ing(pkg)["text"]
        lines = text.split_lines(b"a,1\nb,2\n", encoding=None)
        assert lines.dtype.kind == "S"
        cols = text.split_fields(lines, 2)
        assert cols is not None
        assert cols[0].tolist() == [b"a", b"b"]
        assert text.maybe_numeric(cols[1]).tolist() == [1.0, 2.0]
        assert text.maybe_numeric(np.array([b"007"])).tolist() == [b"007"]
        got.append((lines.tolist(), [c.tolist() for c in cols]))
    assert got[1] == got[0]


def test_demo_source_mode_mismatch_both_directions():
    """``test_demo_source_mode_mismatch_both_directions``: resuming a
    ``RandomMetricSource`` across modes fails both ways with the JAX
    package's errors, and each mode's snapshot crosses the packages
    within its mode."""
    errs = []
    for pkg in PKGS:
        demo = _ing(pkg)["demo"]
        poll = pkg["testing"].poll_next_batch
        batch_src = demo.RandomMetricSource("m", interval=ZERO_TD, count=8, seed=1, batch_size=4)
        part = batch_src.build_part("demo", "m", None)
        poll(part)
        batch_snap = part.snapshot()
        item_src = demo.RandomMetricSource("m", interval=ZERO_TD, count=8, seed=1)
        ex1 = raised(lambda: item_src.build_part("demo", "m", batch_snap))
        assert isinstance(ex1, ValueError) and "batch-native" in str(ex1)
        item_part = item_src.build_part("demo", "m", None)
        poll(item_part)
        item_snap = item_part.snapshot()
        ex2 = raised(lambda: batch_src.build_part("demo", "m", item_snap))
        assert isinstance(ex2, ValueError) and "itemized" in str(ex2)
        errs.append((ex1, ex2))
    for want, got in zip(errs[0], errs[1]):
        assert_same_error(want, got)


@pytest.mark.parametrize(
    "cells",
    [["1", "2.5", "-3"], ["00501", "10014"], ["1", "nan"], ["inf", "2"], ["a", "1"], ["0", "0.5"]],
)
def test_maybe_numeric_round_trip_guard(cells):
    """``test_maybe_numeric_round_trip_guard``: strings that round-trip
    as numbers cast to float64; leading zeros, nan and inf tokens and
    plain text stay strings; the port's column is the JAX package's."""
    want = ref_text.maybe_numeric(np.array(cells))
    got = port_text.maybe_numeric(np.array(cells))
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()
    if cells in (["1", "2.5", "-3"], ["0", "0.5"]):
        assert got.dtype == np.float64
    else:
        assert got.dtype.kind == "U" and got.tolist() == cells


def test_split_lines_ragged_chunk_object_fallback():
    """``test_split_lines_ragged_chunk_object_fallback``: one huge line
    among short ones degrades the chunk to an object-dtype split in
    both packages; ``split_fields`` declines it; uniform chunks stay
    fixed-width."""
    body = ("\n".join([*(["ab"] * 2000), "x" * 40_000]) + "\n").encode()
    outs = []
    for pkg in PKGS:
        text = _ing(pkg)["text"]
        lines = text.split_lines(body)
        assert lines.dtype == object
        assert len(lines) == 2001 and lines[-1] == "x" * 40_000 and lines[0] == "ab"
        assert text.split_fields(lines, 2) is None
        assert text.split_lines(b"ab\ncd\n").dtype.kind == "U"
        outs.append(lines.tolist())
    assert outs[1] == outs[0]


def test_stdin_source_itemized_drains_burst():
    """``test_stdin_source_itemized_drains_burst``: a burst written to
    a pipe is emitted whole by the poll that saw it, a partial line
    waits for EOF, in both packages."""
    for pkg in PKGS:
        r, w = os.pipe()
        stream = os.fdopen(r, "rb", buffering=0)
        try:
            part = _ing(pkg)["stdio"]._StdInPartition(False, 1 << 16, stream)
            os.write(w, b"a\nb\nc\n")
            assert part.next_batch() == ["a", "b", "c"]
            assert part.next_batch() == []  # quiet pipe: select not ready
            os.write(w, b"tail")
            os.close(w)
            assert part.next_batch() == []  # partial line carried
            assert part.next_batch() == ["tail"]  # EOF flush
            with pytest.raises(StopIteration):
                part.next_batch()
        finally:
            stream.close()
            try:
                os.close(w)
            except OSError:
                pass


def test_stdin_source_itemized_text_stream_fallback(monkeypatch):
    """``test_stdin_source_itemized_text_stream_fallback``: a replaced
    ``sys.stdin`` with no file descriptor reads in both packages."""
    for pkg in PKGS:
        monkeypatch.setattr("sys.stdin", io.StringIO("one\ntwo\nthree"))
        out = _flow_out(pkg, "tstdin_item_fallback", _ing(pkg)["stdio"].StdInSource())
        assert out == ["one", "two", "three"], pkg["name"]


def test_stdin_source_columnar(monkeypatch):
    """``test_stdin_source_columnar``: raw 4-byte chunks in, line
    batches out, the unterminated last line flushed at EOF."""
    for pkg in PKGS:
        fake = type("FakeStdin", (), {"buffer": io.BytesIO(b"alpha\nbeta\ngamma")})()
        monkeypatch.setattr("sys.stdin", fake)
        c0 = _counter(pkg, "ingest_rows_columnar")
        out = _flow_out(pkg, "tstdin_col", _ing(pkg)["stdio"].StdInSource(columnar=True, chunk_bytes=4))
        assert out == ["alpha", "beta", "gamma"], pkg["name"]
        assert _counter(pkg, "ingest_rows_columnar") - c0 == 3, pkg["name"]


def test_stdout_sink_writes_array_batches(capsys):
    """``StdOutSink.write_array_batch``: a columnar batch reaching the
    sink prints the same lines in both packages."""
    outs = []
    for pkg in PKGS:
        part = _ing(pkg)["stdio"].StdOutSink().build("out", 0, 1)
        batch = pkg["Batch"]({"key": np.array(["a", "b"]), "value": np.array([1.5, 2.0])})
        part.write_array_batch(batch)
        part.write_batch(["tail"])
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[1]


# -- no pad ladder in the port: random batch lengths ---------------------------


BATCH_LENS = np.random.RandomState(7).randint(1, 30_001, size=100)


def test_random_batch_lengths_fold_like_the_reference(monkeypatch, port_folds):
    """The counterpart of ``test_bucketed_padding_bounds_compiles``:
    100 seeded random batch lengths up to 30,000 rows, uncoalesced,
    each fold to the JAX package's (padded, laddered) output; the port
    folds each batch once with exactly its rows, no padding."""
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    rng = np.random.RandomState(1)
    key_names = np.array([f"k{i}" for i in range(8)])
    arrays = [
        (key_names[np.arange(n) % 8], rng.randint(0, 9, size=n).astype(np.int64)) for n in BATCH_LENS
    ]
    outs = []
    for pkg in PKGS:
        out = []
        pkg["run_main"](
            _sum_flow(pkg, "tpad_pin", _columnar_source(pkg, _kv_batches(pkg, arrays)), out),
            epoch_interval=ZERO_TD,
        )
        outs.append(sorted(out))
    assert outs[0] == _sum_oracle(arrays)
    assert outs[1] == outs[0]
    assert port_folds.rows == BATCH_LENS.tolist()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1024, 1025, 30_000])
def test_fold_takes_exact_rows_at_ladder_edges(n):
    """The counterpart of ``test_pad_len_bucket_ladder``: where the JAX
    package pads a dispatch to its ladder (``pad_len``), the port's
    state folds exactly ``n`` rows and its ``stats`` equal the JAX
    package's; the port has no ``pad_len``."""
    from bytewax_tpu.engine.xla import DeviceAggState as RefState
    from bytewax_tpu_torch.engine.xla import DeviceAggState as PortState

    assert ref_batching.pad_len(n) >= n
    assert not hasattr(port_batching, "pad_len")
    rng = np.random.RandomState(n)
    keys = np.array([f"s{k}" for k in rng.randint(0, 50, size=n)])
    vals = (rng.randn(n) * 10).round(1)
    ref, port = RefState("stats"), PortState("stats")
    rows = []
    scatter = port._scatter

    def counted(slot_ids, values):
        rows.append(len(slot_ids))
        return scatter(slot_ids, values)

    port._scatter = counted
    ref.update(keys, vals)
    port.update(keys, vals)
    assert rows == [n]
    got, want = sorted(port.finalize()), sorted(ref.finalize())
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, (gmn, gmean, gmx, gct)), (_k, (wmn, wmean, wmx, wct)) in zip(got, want):
        assert (gmn, gmx, gct) == (wmn, wmx, wct), k
        np.testing.assert_allclose(gmean, wmean, rtol=1e-5, atol=1e-5, err_msg=k)


# -- adaptive micro-batch coalescing ------------------------------------------


def _accel_bound(pkg, flow):
    plan = pkg["flatten"](flow)
    (inp,) = (o for o in plan.ops if o.name == "input")
    return inp.conf["_accel_bound"]


def test_flatten_annotates_accel_bound_inputs():
    """``test_flatten_annotates_accel_bound_inputs``: coalescing is
    armed exactly for inputs routed to a non-session device-tier step,
    in both packages (a session window never arms it)."""
    got = []
    for pkg in PKGS:
        out = []
        accel = _sum_flow(pkg, "tab_accel", pkg["Source"]([("a", 1)]), out)
        host = pkg["Dataflow"]("tab_host")
        s = pkg["op"].input("inp", host, pkg["Source"]([1]))
        pkg["op"].output("out", pkg["op"].map("x2", s, lambda x: x * 2), pkg["Sink"](out))
        win = pkg["win"]
        sess = pkg["Dataflow"]("tab_session")
        s = pkg["op"].input("inp", sess, pkg["Source"]([]))
        clock = win.EventClock(ts_getter=lambda item: item[0], wait_for_system_duration=ZERO_TD)
        wo = win.count_window(
            "count", s, clock, win.SessionWindower(gap=timedelta(seconds=10)), key=lambda item: item[1]
        )
        pkg["op"].output("out", wo.down, pkg["Sink"](out))
        tumbling = pkg["Dataflow"]("tab_tumbling")
        s = pkg["op"].input("inp", tumbling, pkg["Source"]([]))
        wo = win.count_window(
            "count", s, clock,
            win.TumblingWindower(length=timedelta(seconds=10), align_to=datetime(2024, 1, 1, tzinfo=timezone.utc)),
            key=lambda item: item[1],
        )
        pkg["op"].output("out", wo.down, pkg["Sink"](out))
        got.append([_accel_bound(pkg, f) for f in (accel, host, sess, tumbling)])
    assert got[0][:3] == [True, False, False]
    assert got[1] == got[0]


def test_coalescing_merges_trickle_batches(monkeypatch, port_deliveries):
    """``test_coalescing_merges_trickle_batches``: single rows are
    re-batched to the target at ingest in both packages: the same
    sums, the same coalesced polls, and far fewer folds than rows."""
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "64")
    inp = [(f"k{i % 5}", i) for i in range(400)]
    oracle = {}
    for k, v in inp:
        oracle[k] = oracle.get(k, 0) + v
    polls = []
    for pkg in PKGS:
        c0 = _counter(pkg, "ingest_coalesced_polls")
        out = []
        pkg["run_main"](
            _sum_flow(pkg, "tcoalesce_eq", pkg["Source"](inp, batch_size=1), out), epoch_interval=ZERO_TD
        )
        assert sorted(out) == sorted(oracle.items()), pkg["name"]
        polls.append(_counter(pkg, "ingest_coalesced_polls") - c0)
    assert polls[0] > 300
    assert polls[1] == polls[0]
    assert len(port_deliveries) == -(-400 // 64)  # one fold a target's worth of rows


@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_coalescing_defers_abort_until_rows_flow(first, second, monkeypatch, tmp_path):
    """``test_coalescing_defers_abort_until_rows_flow``: an abort met
    while coalescing re-raises at the next poll, after the rows before
    it flowed and were snapshotted; the resumed run (within the port,
    or in the other package) replays none of them."""
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "64")
    items, tail = list(range(20)), list(range(20, 30))
    db = tmp_path / "db"
    writer = BY_NAME[first]
    out1 = _flow_out(
        writer, "tcoalesce_abort",
        writer["Source"](items + [writer["Source"].ABORT()] + tail, batch_size=1),
        epoch_interval=ZERO_TD, recovery_config=recovery_config(writer, db),
    )
    assert out1 == items
    reader = BY_NAME[second]
    spent = reader["Source"].ABORT()
    spent._triggered = True
    out2 = _flow_out(
        reader, "tcoalesce_abort", reader["Source"](items + [spent] + tail, batch_size=1),
        epoch_interval=ZERO_TD, recovery_config=reader["recovery"].RecoveryConfig(str(db)),
    )
    assert out1 + out2 == items + tail


def test_coalescing_defers_eof_to_the_next_poll(monkeypatch):
    """The coalescer's ``StopIteration`` deferral: a source whose EOF
    lands inside a coalescing pass delivers the rows gathered first,
    with the same deliveries in both packages (one, for 10 rows under
    a target of 64)."""
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "64")
    got = []
    for pkg in PKGS:
        seen = []
        flow = pkg["Dataflow"]("tcoalesce_eof")
        s = pkg["op"].input("inp", flow, pkg["Source"](list(range(10)), batch_size=1))
        s = pkg["op"].key_on("k", s, lambda _x: "k")
        s = pkg["op"].flat_map_batch("seen", s, lambda b: seen.append(len(b)) or b)
        out = []
        pkg["op"].output("out", s, pkg["Sink"](out))
        pkg["run_main"](flow, epoch_interval=ZERO_TD)
        assert [v for _k, v in out] == list(range(10))
        got.append(seen)
    assert got[1] == got[0] == [10]


def test_coalesce_target_defaults(monkeypatch):
    """``test_coalesce_target_defaults``, in both packages: on for
    device-bound inputs, off for host ones, the variable wins, and a
    residency budget turns the default off."""
    for batching in (ref_batching, port_batching):
        monkeypatch.delenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", raising=False)
        monkeypatch.delenv("BYTEWAX_TPU_STATE_BUDGET", raising=False)
        assert batching.coalesce_target(True) == ref_batching.coalesce_target(True) > 0
        assert batching.coalesce_target(False) == 0
        monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "128")
        assert batching.coalesce_target(False) == 128
        monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
        assert batching.coalesce_target(True) == 0
        monkeypatch.delenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", raising=False)
        monkeypatch.setenv("BYTEWAX_TPU_STATE_BUDGET", "4")
        assert batching.coalesce_target(True) == 0
        monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "32")
        assert batching.coalesce_target(True) == 32


def _merge_cases(pkg):
    """Named consecutive-batch pairs covering each rule of
    ``can_merge``: lists, columns, value scale and vocabulary."""
    B = pkg["Batch"]
    vocab = np.array(["x", "y"])
    grown = np.array(["x", "y", "z"])
    a = B({"key": np.array(["a"]), "value": np.array([1.0])})
    b = B({"key": np.array(["b"]), "value": np.array([2.0])})

    def ids(i, v, **kw):
        return B({"key_id": np.array([i], dtype=np.int32), "value": np.array([v])}, **kw)

    return {
        "columns": (a, b),
        "lists": ([1], [2]),
        "list_and_batch": ([1], a),
        "other_columns": (a, B({"line": np.array(["x"])})),
        "same_vocab": (ids(0, 1.0, key_vocab=vocab), ids(1, 2.0, key_vocab=vocab)),
        "equal_vocab_copy": (ids(0, 1.0, key_vocab=vocab), ids(1, 2.0, key_vocab=vocab.copy())),
        "grown_vocab": (ids(0, 1.0, key_vocab=vocab), ids(2, 2.0, key_vocab=grown)),
        "vocab_and_none": (ids(0, 1.0, key_vocab=vocab), ids(1, 2.0)),
        "scale": (ids(0, 1.0, key_vocab=vocab, value_scale=0.1), ids(1, 2.0, key_vocab=vocab, value_scale=0.1)),
        "other_scale": (ids(0, 1.0, key_vocab=vocab, value_scale=0.1), ids(1, 2.0, key_vocab=vocab)),
    }


def test_merge_batches_rules():
    """``test_merge_batches_rules``, and ``_vocab_compatible``: each
    pair merges in the port exactly when it merges in the JAX package
    (a vocabulary merges only with itself), and a merge keeps the
    columns in order and the last batch's vocabulary and scale."""
    ref_cases, port_cases = _merge_cases(REF), _merge_cases(PORT)
    merges = {}
    for name in ref_cases:
        want = ref_batching.can_merge(*ref_cases[name])
        assert port_batching.can_merge(*port_cases[name]) == want, name
        merges[name] = want
    assert merges == {
        "columns": True,
        "lists": True,
        "list_and_batch": False,
        "other_columns": False,
        "same_vocab": True,
        "equal_vocab_copy": False,
        "grown_vocab": False,
        "vocab_and_none": False,
        "scale": True,
        "other_scale": False,
    }
    for name, ok in merges.items():
        if not ok:
            continue
        got = port_batching.merge_batches(list(port_cases[name]))
        want = ref_batching.merge_batches(list(ref_cases[name]))
        if isinstance(want, list):
            assert got == want
            continue
        assert list(got.cols) == list(want.cols)
        for col in want.cols:
            assert got.cols[col].tolist() == want.cols[col].tolist(), (name, col)
        assert got.value_scale == want.value_scale
        assert (got.key_vocab is None) == (want.key_vocab is None)
        if want.key_vocab is not None:
            assert got.key_vocab is port_cases[name][1].key_vocab


def test_coalesced_dictionary_batches_fold_like_the_reference(monkeypatch, port_deliveries):
    """Dictionary-encoded batches sharing one vocabulary (the 1BRC
    ``ArrayBatchSource`` feed) coalesce to the target in the port as in
    the JAX package: the same sums, and one fold a target's worth of
    rows; with the target at 0, one fold a batch."""
    vocab = np.array([f"station_{i:03d}" for i in range(97)])
    rng = np.random.RandomState(11)
    cols = [
        (rng.randint(0, 97, size=256).astype(np.int32), rng.randint(-99, 99, size=256).astype(np.int64))
        for _ in range(64)
    ]
    oracle = {}
    for ids, vals in cols:
        for i, v in zip(ids.tolist(), vals.tolist()):
            oracle[vocab[i]] = oracle.get(vocab[i], 0) + v
    for target, folds in (("2048", 8), ("0", 64)):
        monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", target)
        outs = []
        for pkg in PKGS:
            batches = [pkg["Batch"]({"key_id": i, "value": v}, key_vocab=vocab) for i, v in cols]
            out = []
            pkg["run_main"](_sum_flow(pkg, "tcoalesce_vocab", pkg["ArraySource"](batches), out))
            outs.append(sorted(out))
        assert outs[0] == sorted(oracle.items())
        assert outs[1] == outs[0]
        assert len(port_deliveries) == folds, target
        assert sum(port_deliveries) == 64 * 256
        port_deliveries.clear()


# -- source-lag accounting on the columnar path -------------------------------


def test_columnar_batch_event_lag():
    """``test_columnar_batch_event_lag``: the event lag of a columnar
    batch (datetime64 or µs columns, none without a ts column or with
    NaT) is the JAX package's."""
    now = datetime(2026, 1, 1, 0, 0, 10, tzinfo=timezone.utc)
    dt_col = np.array(["2026-01-01T00:00:00", "2026-01-01T00:00:07"], dtype="datetime64[us]")
    us_col = dt_col.astype("int64") - np.datetime64("1970-01-01", "us").astype("int64")
    for pkg in PKGS:
        lag_of = _ing(pkg)["driver"]._batch_event_lag_s
        B = pkg["Batch"]
        assert lag_of(B({"key": np.array(["a", "b"]), "ts": dt_col}), now) == pytest.approx(3.0)
        assert lag_of(B({"key": np.array(["a", "b"]), "ts": us_col}), now) == pytest.approx(3.0)
        assert lag_of(B({"value": np.array([1.0])}), now) is None
        assert lag_of(B({"ts": np.array(["NaT"], dtype="datetime64[us]")}), now) is None


# -- the demo source ----------------------------------------------------------


def _walk(part, poll):
    got = []
    while True:
        try:
            got.extend(poll(part).cols["value"].tolist())
        except StopIteration:
            return got


def test_demo_source_batch_native_resume():
    """``test_demo_source_batch_native_resume``: the batch-native walk
    emits key/ts/value columns, its snapshot resumes the walk without
    a repeat or a gap, and the port's walk is the JAX package's from
    the same seed."""
    walks = []
    for pkg in PKGS:
        demo = _ing(pkg)["demo"]
        poll = pkg["testing"].poll_next_batch
        src = demo.RandomMetricSource("cpu", interval=ZERO_TD, count=10, seed=42, batch_size=4)
        part = src.build_part("demo", "cpu", None)
        first = poll(part)
        assert sorted(first.cols) == ["key", "ts", "value"]
        assert first.cols["key"].tolist() == ["cpu"] * 4
        rest = _walk(src.build_part("demo", "cpu", part.snapshot()), poll)
        walk = _walk(src.build_part("demo", "cpu", None), poll)
        assert first.cols["value"].tolist() + rest == pytest.approx(walk)
        assert len(walk) == 10
        walks.append(walk)
    assert walks[1] == walks[0]


@pytest.mark.parametrize("batch_size", [None, 4])
def test_demo_snapshots_cross_the_packages(batch_size):
    """A ``RandomMetricSource`` snapshot of either package, itemized or
    batch-native, resumes the other package's walk where it left
    off."""
    kwargs = {} if batch_size is None else {"batch_size": batch_size}
    for src_pkg, dst_pkg in ((REF, PORT), (PORT, REF)):
        src = _ing(src_pkg)["demo"].RandomMetricSource("m", interval=ZERO_TD, count=12, seed=5, **kwargs)
        dst = _ing(dst_pkg)["demo"].RandomMetricSource("m", interval=ZERO_TD, count=12, seed=5, **kwargs)
        part = src.build_part("s", "m", None)
        head = src_pkg["testing"].poll_next_batch(part)
        resumed = dst.build_part("s", "m", part.snapshot())
        straight = src.build_part("s", "m", None)
        src_pkg["testing"].poll_next_batch(straight)
        if batch_size is None:
            assert len(head) == 1
            assert dst_pkg["testing"].poll_next_batch(resumed) == src_pkg["testing"].poll_next_batch(straight)
        else:
            want = src_pkg["testing"].poll_next_batch(straight).cols["value"].tolist()
            assert dst_pkg["testing"].poll_next_batch(resumed).cols["value"].tolist() == want
