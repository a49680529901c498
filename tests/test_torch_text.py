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


@pytest.mark.parametrize("raw", [False, True], ids=["text", "bytes"])
@pytest.mark.parametrize("n_fields", [2, 3])
def test_split_fields_matches_reference(n_fields, raw):
    rng = np.random.RandomState(n_fields)
    rows = [
        ";".join(f"f{j}{rng.randint(1000)}" for j in range(n_fields))
        for _ in range(200)
    ]
    lines = np.array([r.encode() for r in rows]) if raw else np.array(rows)
    got = port_text.split_fields(lines, n_fields, ";")
    want = ref_text.split_fields(lines, n_fields, ";")
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    # A row with the wrong delimiter count: both hand the batch back.
    bad = np.concatenate([lines, lines[:1] + (b";x" if raw else ";x")])
    assert port_text.split_fields(bad, n_fields, ";") is None
    assert ref_text.split_fields(bad, n_fields, ";") is None


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
