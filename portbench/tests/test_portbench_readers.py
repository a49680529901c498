"""The readers of the program's own spans and counters: a number on a
tiny traced run of their cell, and nothing, without raising, where
the program keeps no such counter (as a program without the spans
does)."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests.tiny import ROOT, SECONDS, overrides

#: metric -> (its cell, the counter it reads)
READERS = {
    "vocab_share.card": ("brc-10k.columnar", "dispatch_vocab_seconds"),
    "copy_share.card": ("brc-10k.columnar", "dispatch_copy_seconds"),
    "mapper_share.rows": ("brc-10k.text", "mapper_seconds"),
    "decode_share.rows": ("brc-10k.text", "decode_seconds"),
}


def _reader(name):
    cell = run.find_cell(ROOT, READERS[name][0])
    return cell.module("metrics", name).read


def _ctx(counters, rows=1000, window_s=2.0):
    return SimpleNamespace(counters=counters, rows=rows, window_s=window_s)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_counter(name):
    counter = READERS[name][1]
    got = _reader(name)(_ctx({counter: 0.5, "other_seconds": 9.0}))
    assert got == pytest.approx(25.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_without_its_counter_a_reader_gives_nothing(name):
    read = _reader(name)
    assert read(_ctx({"other_seconds": 1.0})) is None
    assert read(_ctx(None)) is None


@pytest.mark.parametrize("cell", sorted({c for c, _ in READERS.values()}))
def test_the_readers_read_a_tiny_traced_run(cell, tmp_path):
    out = run.run_cell(ROOT, cell, 33, SECONDS, True, device="cpu", overrides=overrides(cell), tmp=tmp_path)
    metrics = out["result"]["metrics"]
    for name, (where, _counter) in READERS.items():
        if where == cell:
            assert metrics[name]["value"] > 0, name
