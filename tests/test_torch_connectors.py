"""The file connectors and the demo source of the torch port held
against the JAX package: each case of ``tests/test_connectors.py``
runs the same flow on the same files through both packages
(``FileSource``, ``CSVSource`` snapshotted mid-file and with
``DictReader`` arguments, ``DirSource``, ``FileSink``'s truncation on
resume, ``DirSink``'s routing, ``RandomMetricSource``'s resumed
walk).  A ``FileSink`` resume also crosses the packages both ways:
the store and the file one package left resume in the other.

File contents, items and walks must be equal.
"""

from datetime import timedelta

import pytest

from bytewax_tpu.connectors import demo as ref_demo
from bytewax_tpu.connectors import files as ref_files
from bytewax_tpu_torch.connectors import demo as port_demo
from bytewax_tpu_torch.connectors import files as port_files
from tests.torch_entry_points import (  # noqa: F401
    PKGS,
    PORT,
    REF,
    port_on_cpu,
    recovery_config,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)
FILES = {REF["name"]: ref_files, PORT["name"]: port_files}
DEMO = {REF["name"]: ref_demo, PORT["name"]: port_demo}
BY_NAME = {"jax": REF, "port": PORT}


def _through(pkg, source, sink=None, **kwargs):
    """``input -> output`` over ``source`` with ``pkg``'s ``run_main``;
    returns the items out (into ``sink`` when one is given)."""
    out = []
    flow = pkg["Dataflow"]("test_df")
    s = pkg["op"].input("inp", flow, source)
    pkg["op"].output("out", s, sink if sink is not None else pkg["Sink"](out))
    pkg["run_main"](flow, **kwargs)
    return out


def _both(make_source, **kwargs):
    """Each package's items out of ``make_source(files module)``; the
    port's must equal the JAX package's."""
    outs = [_through(pkg, make_source(FILES[pkg["name"]]), **kwargs) for pkg in PKGS]
    assert outs[1] == outs[0]
    return outs[1]


def test_file_source(tmp_path):
    path = tmp_path / "in.txt"
    path.write_text("a\nb\nc\n")
    assert _both(lambda files: files.FileSource(path)) == ["a", "b", "c"]


def test_csv_source_snapshot_mid_file(tmp_path):
    """``batch_size=1`` snapshots after every row (``tell()`` stays
    usable) in both packages, into a store of each package's own."""
    path = tmp_path / "in.csv"
    path.write_text("name,val\n" + "".join(f"r{i},v{i}\n" for i in range(10)))
    outs = []
    for pkg in PKGS:
        rc = recovery_config(pkg, tmp_path / f"db_{pkg['name']}")
        out = _through(
            pkg, FILES[pkg["name"]].CSVSource(path, batch_size=1), epoch_interval=ZERO_TD, recovery_config=rc
        )
        assert len(out) == 10 and out[0] == {"name": "r0", "val": "v0"}
        outs.append(out)
    assert outs[1] == outs[0]


def test_dir_source(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    (d / "one.txt").write_text("1\n2\n")
    (d / "two.txt").write_text("3\n")
    outs = [
        sorted(_through(pkg, FILES[pkg["name"]].DirSource(d, glob_pat="*.txt"))) for pkg in PKGS
    ]
    assert outs[0] == outs[1] == ["1", "2", "3"]


def _keyed_sink_flow(pkg, inp, out_path):
    flow = pkg["Dataflow"]("test_df")
    s = pkg["op"].input("inp", flow, pkg["Source"](inp))
    s = pkg["op"].key_on("key", s, lambda _x: "k")
    pkg["op"].output("out", s, FILES[pkg["name"]].FileSink(out_path))
    return flow


@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_file_sink_truncate_on_resume(first, second, tmp_path):
    """``test_file_sink_truncate_on_resume``: a run stopped by an EOF
    sentinel wrote ``a``, ``b``; the resumed run (in the port, or in
    the other package from the first one's store and file) truncates
    to the snapshot's byte offset and appends ``c`` once."""
    out_path = tmp_path / "out.txt"
    db = tmp_path / "db"
    writer, reader = BY_NAME[first], BY_NAME[second]
    inp = ["a", "b", writer["Source"].EOF(), "c"]
    writer["run_main"](
        _keyed_sink_flow(writer, inp, out_path), epoch_interval=ZERO_TD,
        recovery_config=recovery_config(writer, db),
    )
    assert out_path.read_text() == "a\nb\n"
    inp = ["a", "b", reader["Source"].EOF(), "c"]
    reader["run_main"](
        _keyed_sink_flow(reader, inp, out_path), epoch_interval=ZERO_TD,
        recovery_config=reader["recovery"].RecoveryConfig(str(db)),
    )
    assert out_path.read_text() == "a\nb\nc\n"


def _dir_sink_contents(pkg, root, inp, file_count, assign_file):
    d = root / pkg["name"]
    d.mkdir()
    _through(pkg, pkg["Source"](inp), FILES[pkg["name"]].DirSink(d, file_count=file_count, assign_file=assign_file))
    return {p.name: p.read_text() for p in sorted(d.iterdir())}


def test_dir_sink_routes_by_key(tmp_path):
    inp = [("a", "1"), ("b", "2")]
    outs = [
        _dir_sink_contents(pkg, tmp_path, inp, 2, lambda k: 0 if k == "a" else 1) for pkg in PKGS
    ]
    assert outs[0] == outs[1] == {"part_0": "1\n", "part_1": "2\n"}


def test_dir_sink_ten_plus_files(tmp_path):
    """Twelve files: the assigned index names the file of that index,
    whatever the names' lexicographic order."""
    inp = [(str(i), f"v{i}") for i in range(12)]
    outs = [_dir_sink_contents(pkg, tmp_path, inp, 12, int) for pkg in PKGS]
    assert outs[0] == outs[1] == {f"part_{i}": f"v{i}\n" for i in range(12)}


def test_demo_source_resume_continues_rng():
    """A snapshot mid-stream continues the walk as an uninterrupted
    run does, in each package; the port's walk is the JAX package's,
    and a snapshot of one package resumes in the other."""
    walks = []
    for pkg in PKGS:
        src = DEMO[pkg["name"]].RandomMetricSource("m", interval=ZERO_TD, count=6, seed=123)
        full_part = src.build_part("s", "m", None)
        full = [full_part.next_batch()[0][1] for _ in range(6)]
        part = src.build_part("s", "m", None)
        first_half = [part.next_batch()[0][1] for _ in range(3)]
        snap = part.snapshot()
        resumed = src.build_part("s", "m", snap)
        assert first_half + [resumed.next_batch()[0][1] for _ in range(3)] == full
        other = BY_NAME["port" if pkg is REF else "jax"]
        crossed = DEMO[other["name"]].RandomMetricSource("m", interval=ZERO_TD, count=6, seed=123)
        part = crossed.build_part("s", "m", snap)
        assert [part.next_batch()[0][1] for _ in range(3)] == full[3:]
        walks.append(full)
    assert walks[1] == walks[0]


def test_csv_source_dictreader_kwargs(tmp_path):
    path = tmp_path / "in.csv"
    path.write_text("a,b\n1,2,3\n")
    got = _both(lambda files: files.CSVSource(path, restkey="extra", restval=""))
    assert got == [{"a": "1", "b": "2", "extra": ["3"]}]
