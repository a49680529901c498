"""The port's ``ops/text.py`` against the JAX package's, on the same
inputs: the padded line gather (``_gather_pad``, on the host and, with
``BYTEWAX_TPU_TEXT_DEVICE=1``, in torch on the selected device against
the JAX package's jnp gather), line and field splitting, numeric
casting, the native ``WordTokenizer``, and the wordcount flow.

Everything here is exact: the outputs are strings, ids and counts.
"""

import os

import numpy as np
import pytest
import torch

import bytewax_tpu.ops.text as ref_text
import bytewax_tpu_torch.engine.sharded_state as port_sharded_state
import bytewax_tpu_torch.ops.text as port_text
from bytewax_tpu.models.wordcount import wordcount_flow as ref_wordcount_flow
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch.models.wordcount import wordcount_flow as port_wordcount_flow
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform

LINES = [
    "Hello, hello world!",
    "the quick Brown fox; the lazy dog.",
    'say "what" twice: what what',
    "numbers 123 do not 45 count",
    "héllo wörld the the",  # non-ASCII lines take the regex fallback
    "",
    "  spaced   out  words  ",
    "fs\x1cgs\x1drs\x1eus\x1fdone",  # \s control separators (ASCII path)
    "tab\tand\x0bvertical\x0cfeeds",
]


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _body(seed: int, n: int = 300, unicode: bool = False) -> bytes:
    rng = np.random.RandomState(seed)
    alphabet = list("abcdefghij;,. 0123456789") + (["é", "ß", "水"] if unicode else [])
    lines = []
    for i in range(n):
        width = int(rng.randint(0, 40)) if i % 50 else 0  # some empty lines
        line = "".join(rng.choice(alphabet, size=width))
        lines.append(line + ("\r" if i % 17 == 3 else ""))
    return ("\n".join(lines) + "\n").encode("utf-8")


@pytest.mark.parametrize("text_device", ["0", "1"])
@pytest.mark.parametrize("kind", ["bytes", "text"])
def test_gather_pad_matches_reference(monkeypatch, kind, text_device):
    monkeypatch.setenv("BYTEWAX_TPU_TEXT_DEVICE", text_device)
    body = _body(1, unicode=kind == "text")
    if kind == "bytes":
        buf = np.frombuffer(body, np.uint8)
    else:
        buf = np.frombuffer(body.decode("utf-8").encode("utf-32-le"), np.uint32)
    ends = np.flatnonzero(buf == 0x0A)
    starts = np.concatenate([[0], ends[:-1] + 1])
    lens = ends - starts
    width = int(lens.max())
    got = port_text._gather_pad(buf, starts, lens, width)
    want = np.asarray(ref_text._gather_pad(buf, starts, lens, width))
    assert got.shape == want.shape == (len(ends), width)
    assert got.dtype == buf.dtype
    np.testing.assert_array_equal(got, want.astype(buf.dtype))
    # And through the callers: the same line arrays.
    encoding = None if kind == "bytes" else "utf-8"
    got_lines = port_text.split_lines(body, encoding)
    want_lines = ref_text.split_lines(body, encoding)
    assert got_lines.dtype == want_lines.dtype
    assert got_lines.tolist() == want_lines.tolist()


def test_device_gather_does_not_fall_back_without_a_card(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_TEXT_DEVICE", "1")
    monkeypatch.delenv("BYTEWAX_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_text.split_lines(b"a;1\nb;2\n")


@pytest.mark.parametrize("on_error", ["raise", "dlq"])
def test_line_batcher_matches_reference(on_error):
    body = _body(2, unicode=True) + b"bad \xff line\nlast unterminated"
    outs = []
    for text in (ref_text, port_text):
        batcher = text.LineBatcher(on_error=on_error)
        lines = []
        try:
            for i in range(0, len(body), 37):
                batch = batcher.feed(body[i : i + 37])
                if batch is not None:
                    lines.extend(batch.cols["line"].tolist())
            batch = batcher.flush()
            if batch is not None:
                lines.extend(batch.cols["line"].tolist())
            outs.append((lines, batcher.dead, batcher.pending))
        except UnicodeDecodeError as ex:
            outs.append(type(ex).__name__)
    assert outs[0] == outs[1]
    assert (outs[1] == "UnicodeDecodeError") == (on_error == "raise")


def _random_rows(n_fields: int) -> list:
    rng = np.random.RandomState(n_fields)
    return [
        ";".join(f"f{j}{rng.randint(1000)}" for j in range(n_fields))
        for _ in range(200)
    ]


def _brc_rows() -> list:
    """1BRC-shaped rows: names of 1 to 100 code points (non-ASCII
    among them), an empty key, an empty value, interior NULs, and one
    row as wide as the array."""
    rng = np.random.RandomState(7)
    alphabet = list("abcdefghijklmnopqrstuvwxyz -'") + ["é", "ß", "水", "ø"]
    rows = []
    for width in list(range(1, 101)) + list(rng.randint(1, 40, size=300)):
        name = "".join(rng.choice(alphabet, size=int(width)))
        rows.append(f"{name};{rng.randint(-999, 1000) / 10:.1f}")
    rows += [";1.0", "a;", "a\x00b;2.5", "nul\x00;0.1", "x;\x00-3.0"]
    rows.append("W" * 100 + ";-99.9")  # the widest row sets the width
    return rows


def _lines(rows: list, raw: bool) -> np.ndarray:
    return np.array([r.encode() for r in rows]) if raw else np.array(rows)


# (id, rows, n_fields, delimiter, raw); the first four ids are the
# original cases of random rows.
_SPLIT_CASES = [
    ("text-2", _random_rows(2), 2, ";", False),
    ("text-3", _random_rows(3), 3, ";", False),
    ("bytes-2", _random_rows(2), 2, ";", True),
    ("bytes-3", _random_rows(3), 3, ";", True),
    ("text-4", _random_rows(4), 4, ";", False),
    ("bytes-4", _random_rows(4), 4, ";", True),
    ("brc-text", _brc_rows(), 2, ";", False),
    ("brc-bytes", _brc_rows(), 2, ";", True),
    ("brc-3-fields", [r + ";" + r[:3] for r in _brc_rows()], 3, ";", False),
    ("two-char-text", [r.replace(";", "::") for r in _brc_rows()], 2, "::", False),
    ("two-char-bytes", [r.replace(";", "::") for r in _random_rows(3)], 3, "::", True),
    ("wrong-count", _brc_rows() + ["a;b;1.0"], 2, ";", False),
    ("none-of-it", ["a", "b"], 2, ";", True),
    ("one-field", ["abc", "", "x\x00y"], 1, ";", False),
]


@pytest.mark.parametrize(
    "rows,n_fields,delimiter,raw",
    [pytest.param(*c[1:], id=c[0]) for c in _SPLIT_CASES],
)
def test_split_fields_matches_reference(rows, n_fields, delimiter, raw):
    lines = _lines(rows, raw)
    got = port_text.split_fields(lines, n_fields, delimiter)
    want = ref_text.split_fields(lines, n_fields, delimiter)
    assert (got is None) == (want is None)
    if want is not None:
        assert [c.dtype.kind for c in got] == [c.dtype.kind for c in want]
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
    # A row with the wrong delimiter count: both hand the batch back.
    extra = delimiter + "x"
    bad = np.concatenate([lines, lines[:1] + (extra.encode() if raw else extra)])
    assert port_text.split_fields(bad, n_fields, delimiter) is None
    assert ref_text.split_fields(bad, n_fields, delimiter) is None


@pytest.mark.parametrize("n_fields", [2, 3])
@pytest.mark.parametrize("dtype", ["U8", "S8", ">U8"])
def test_split_fields_empty_and_foreign_arrays(dtype, n_fields):
    """An empty array splits into empty columns (the JAX package's
    ``np.char.partition`` path raises ``IndexError`` there); an object
    array is refused by both; a big-endian array takes the fallback and
    gives the reference's values."""
    empty = np.empty(0, dtype=dtype)
    got = port_text.split_fields(empty, n_fields, ";")
    assert [c.tolist() for c in got] == [[]] * n_fields
    assert [c.dtype.kind for c in got] == [empty.dtype.kind] * n_fields
    with pytest.raises(IndexError):
        ref_text.split_fields(empty, n_fields, ";")
    rows = [r + ";z" * (n_fields - 2) for r in ["ab;1.5", "é;", ";-2.0"]]
    objs = np.array(rows, dtype=object)
    assert port_text.split_fields(objs, n_fields, ";") is None
    assert ref_text.split_fields(objs, n_fields, ";") is None
    lines = np.array([r.encode() for r in rows] if dtype[0] == "S" else rows, dtype=dtype)
    got = port_text.split_fields(lines, n_fields, ";")
    want = ref_text.split_fields(lines, n_fields, ";")
    assert [c.tolist() for c in got] == [c.tolist() for c in want]


@pytest.mark.parametrize(
    "rows,n_fields,delimiter,raw",
    [pytest.param(*c[1:], id=c[0]) for c in _SPLIT_CASES],
)
def test_split_fields_columns_no_wider_than_partition(rows, n_fields, delimiter, raw):
    """No column is wider than ``np.char.partition`` makes it, so the
    dispatch worker's key encode sees no wider key array."""
    lines = _lines(rows, raw)
    got = port_text.split_fields(lines, n_fields, delimiter)
    if got is None:
        return
    rest = lines
    for col in got[:-1]:
        parts = np.char.partition(rest, delimiter.encode() if raw else delimiter)
        assert col.itemsize <= parts.itemsize
        rest = np.ascontiguousarray(parts[:, 2])
    assert got[-1].itemsize <= rest.itemsize


def test_split_fields_key_column_as_wide_as_before():
    """On 1BRC rows the key column is exactly as wide as the reference's
    and the value column no wider than its longest reading."""
    lines = _lines(_brc_rows(), raw=False)
    key, value = port_text.split_fields(lines, 2, ";")
    ref_key, ref_value = ref_text.split_fields(lines, 2, ";")
    assert key.dtype == ref_key.dtype == np.dtype("<U100")
    assert value.dtype == np.dtype("<U5")  # "-99.9"; the reference's is <U100
    assert ref_value.dtype == np.dtype("<U100")


def test_split_fields_counts_rows_per_path():
    counters = port_text._flight.RECORDER.counters
    lines = _lines(_brc_rows(), raw=False)

    def deltas(fn):
        before = [counters.get(k, 0) for k in ("split_fields_rows", "split_fields_fallback_rows")]
        fn()
        after = [counters.get(k, 0) for k in ("split_fields_rows", "split_fields_fallback_rows")]
        return [a - b for a, b in zip(after, before)]

    assert deltas(lambda: port_text.split_fields(lines, 2, ";")) == [len(lines), 0]
    assert deltas(lambda: port_text.split_fields(_lines(_brc_rows(), raw=True), 2, ";")) == [len(lines), 0]
    two = np.char.replace(lines, ";", "::")
    assert deltas(lambda: port_text.split_fields(two, 2, "::")) == [0, len(lines)]
    # Refused batches count in neither, on either path.
    assert deltas(lambda: port_text.split_fields(lines, 3, ";")) == [0, 0]
    assert deltas(lambda: port_text.split_fields(two, 3, "::")) == [0, 0]


@pytest.mark.parametrize(
    "col",
    [
        ["1.5", "-2", "3e2"],
        ["1.5", "abc"],
        ["00501", "7"],
        ["nan", "1"],
        ["", "1"],
        [b"12.5", b"-0.5"],
    ],
)
def test_maybe_numeric_matches_reference(col):
    arr = np.array(col)
    got, want = port_text.maybe_numeric(arr), ref_text.maybe_numeric(arr)
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()


def test_word_tokenizer_matches_reference():
    if not port_text.native_tokenizer_available():
        pytest.skip("the native tokenizer library does not build here")
    ref_tok, port_tok = ref_text.WordTokenizer(), port_text.WordTokenizer()
    lowered = [line.lower() for line in LINES]
    for chunk in (lowered[:4], lowered[4:], ["alpha beta", "gamma alpha"]):
        got, want = port_tok(chunk), ref_tok(chunk)
        assert got.cols["key_id"].tolist() == want.cols["key_id"].tolist()
        assert got.cols["value"].tolist() == want.cols["value"].tolist()
        assert np.asarray(got.key_vocab).tolist() == np.asarray(want.key_vocab).tolist()


@pytest.mark.parametrize("tokenizer", ["native", "regex"])
def test_wordcount_matches_reference(monkeypatch, tokenizer):
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    made = []
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        made.append(make(kind, driver=driver))
        return made[-1]

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    rng = np.random.RandomState(3)
    words = np.array([f"w{chr(97 + i % 26)}{chr(97 + i // 26)}" for i in range(300)])
    lines = LINES + [" ".join(words[rng.randint(0, 300, size=10)]) for _ in range(300)]
    outs = []
    for flow_of, source, sink, run in (
        (ref_wordcount_flow, RefSource, RefSink, ref_run_main),
        (port_wordcount_flow, PortSource, PortSink, port_run_main),
    ):
        out = []
        kwargs = {} if tokenizer == "native" else {"tokenizer": port_text.TOKEN_RE.findall}
        run(flow_of(source(lines, batch_size=64), sink(out), **kwargs))
        outs.append(sorted(out))
    want, got = outs
    assert got == want
    assert dict(got)["the"] == 4
    assert all(type(c) is int for _w, c in got)
    assert [s.device.type for s in made] == ["cpu"]
