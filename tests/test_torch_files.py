"""File ingest through ``run_main`` of the JAX package and of the torch
port, on the same seeded files: 1BRC lines and wordcount text read by
``FileSource`` in columnar mode (raw chunks split by ``ops/text``) and
in itemized mode, ``CSVSource`` both ways, and ``DirSource`` into
``FileSink``.

Counts, min, max, strings and file contents must match exactly; the
float32 means of 1BRC to ``rtol=atol=1e-5``.
"""

import os

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu_torch.engine.sharded_state as port_sharded_state
import bytewax_tpu_torch.operators as port_op
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.connectors import files as ref_files
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
from bytewax_tpu.models.wordcount import wordcount_flow as ref_wordcount_flow
from bytewax_tpu.ops import text as ref_text
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.connectors import files as port_files
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.engine import flight as port_flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch as PortBatch
from bytewax_tpu_torch.models.wordcount import wordcount_flow as port_wordcount_flow
from bytewax_tpu_torch.ops import text as port_text
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform

REF = {
    "op": ref_op,
    "xla": ref_xla,
    "files": ref_files,
    "text": ref_text,
    "Batch": RefBatch,
    "Dataflow": RefDataflow,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "wordcount_flow": ref_wordcount_flow,
}
PORT = {
    "op": port_op,
    "xla": port_xla,
    "files": port_files,
    "text": port_text,
    "Batch": PortBatch,
    "Dataflow": PortDataflow,
    "Sink": PortSink,
    "run_main": port_run_main,
    "wordcount_flow": port_wordcount_flow,
}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.fixture
def device_states(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    made = []
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        made.append(make(kind, driver=driver))
        return made[-1]

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    return made


def _run_both(build):
    outs = []
    for pkg in (REF, PORT):
        out = []
        pkg["run_main"](build(pkg, out))
        outs.append(out)
    return outs


def _close(g, w):
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def _brc_file(path, n: int = 600, n_stations: int = 37, seed: int = 0):
    rng = np.random.RandomState(seed)
    stations = np.array([f"station_{i:03d}" for i in range(n_stations)])
    ids = rng.randint(0, n_stations, size=n)
    deci = rng.randint(-999, 1000, size=n)
    lines = [f"{stations[i]};{q / 10:.1f}" for i, q in zip(ids.tolist(), deci.tolist())]
    path.write_text("\n".join(lines) + "\n")
    return len(lines)


def _brc_flow(pkg, path, columnar: bool, out):
    def parse_batch(batch):
        cols = pkg["text"].split_fields(batch.cols["line"], 2, ";")
        return pkg["Batch"]({"key": cols[0], "value": cols[1].astype(np.float64)})

    def parse_line(line):
        station, temp = line.split(";")
        return station, float(temp)

    flow = pkg["Dataflow"]("brc_file")
    if columnar:
        source = pkg["files"].FileSource(path, columnar=True, chunk_bytes=512)
        s = pkg["op"].input("inp", flow, source)
        s = pkg["op"].flat_map_batch("parse", s, parse_batch)
    else:
        source = pkg["files"].FileSource(path, batch_size=64)
        s = pkg["op"].input("inp", flow, source)
        s = pkg["op"].map("parse", s, parse_line)
    s = pkg["xla"].stats_final("stats", s)
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "itemized"])
def test_brc_file_matches_reference(device_states, tmp_path, columnar):
    path = tmp_path / "measurements.txt"
    n = _brc_file(path)
    before = port_flight.RECORDER.counters.get("ingest_rows_columnar", 0)
    want, got = _run_both(lambda pkg, out: _brc_flow(pkg, path, columnar, out))
    after = port_flight.RECORDER.counters.get("ingest_rows_columnar", 0)
    assert sorted(k for k, _ in got) == sorted(k for k, _ in want)
    want = dict(want)
    for key, (mn, mean, mx, count) in got:
        wmn, wmean, wmx, wcount = want[key]
        assert (mn, mx, count) == (wmn, wmx, wcount), key
        assert _close(mean, wmean), (key, mean, wmean)
    assert sum(count for *_s, count in want.values()) == n
    assert [s.device.type for s in device_states] == ["cpu"]
    assert (after - before == n) if columnar else (after == before)


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "itemized"])
def test_wordcount_file_matches_reference(device_states, tmp_path, columnar):
    rng = np.random.RandomState(4)
    vocab = np.array([f"w{chr(97 + i % 26)}{chr(97 + i // 26 % 26)}" for i in range(200)])
    lines = [" ".join(vocab[rng.randint(0, 200, size=10)]).title() for _ in range(400)]
    path = tmp_path / "words.txt"
    path.write_text("\n".join(lines) + "\n")

    def build(pkg, out):
        kwargs = {"columnar": True, "chunk_bytes": 1024} if columnar else {}
        source = pkg["files"].FileSource(path, **kwargs)
        return pkg["wordcount_flow"](source, pkg["Sink"](out))

    want, got = _run_both(build)
    assert sorted(got) == sorted(want)
    assert sum(c for _w, c in got) == 4000
    assert len(device_states) == 1


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "itemized"])
@pytest.mark.parametrize("quoted", [False, True], ids=["plain", "quoted"])
def test_csv_source_matches_reference(tmp_path, columnar, quoted):
    rng = np.random.RandomState(5)
    rows = [(f"name{rng.randint(20)}", rng.randint(-50, 50)) for _ in range(150)]
    body = "name,score\n" + "".join(
        (f'"{n}, jr",{s}\n' if quoted and i % 7 == 0 else f"{n},{s}\n")
        for i, (n, s) in enumerate(rows)
    )
    path = tmp_path / "scores.csv"
    path.write_text(body)

    def build(pkg, out):
        flow = pkg["Dataflow"]("csv")
        kwargs = {"columnar": True, "chunk_bytes": 256} if columnar else {}
        s = pkg["op"].input("inp", flow, pkg["files"].CSVSource(path, **kwargs))
        pkg["op"].output("out", s, pkg["Sink"](out))
        return flow

    want, got = _run_both(build)
    assert got == want
    assert len(got) == len(rows)


def test_dir_source_into_file_sink_matches_reference(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.RandomState(6)
    for i in range(3):
        (src / f"part{i}.txt").write_text(
            "".join(f"r{i}-{rng.randint(1000)}\n" for _ in range(40))
        )
    written = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        dest = tmp_path / f"{name}.txt"
        flow = pkg["Dataflow"]("dir")
        s = pkg["op"].input("inp", flow, pkg["files"].DirSource(src))
        s = pkg["op"].map("upper", s, lambda line: ("all", line.upper()))
        pkg["op"].output("out", s, pkg["files"].FileSink(dest))
        pkg["run_main"](flow)
        written[name] = dest.read_text()
    assert written["port"] == written["ref"]
    assert len(written["port"].splitlines()) == 120
