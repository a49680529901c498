"""The repo's examples through the torch port.

Each example that ``tests/test_examples.py`` runs end to end runs here
twice, in this process: the untouched file under the JAX package's
``run_main``, and a copy under ``tmp_path`` whose ``import`` and
``from`` lines name ``bytewax_tpu_torch`` instead of ``bytewax_tpu``
under the port's ``run_main`` (its device tier on the CPU).  Each is
loaded with ``runpy`` and its standard output captured; ``examples/``
itself is never written.

Deterministic examples must print the same lines (``join.py`` and
``orderbook.py`` among them; ``events_to_parquet.py`` prints nothing
and must write the same rows).  Those whose output depends on the wall
clock only need to run without error, in ``WALL_CLOCK``:

- ``periodic_input.py`` prints each tick's wall time;
- ``wikistream.py`` folds over ``SystemClock`` windows, whose ids and
  contents follow the wall clock.

Every example builds and flattens through the port
(``bytewax_tpu_torch.engine.flatten.flatten``), as
``tests/test_examples.py`` builds them: the two Kafka examples of
``KAFKA_INMEM`` against the port's in-process broker, and the two that
need a schema registry not at all (skipped, as the reference's are).
``wordcount.py`` also
runs from the repo root, as ``test_examples.py`` runs it.  Last, the
windowing benchmark of ``BASELINE.json``'s configs
(``examples/benchmark_windowing.py`` over ``models/windowing_bench.py``)
runs through both packages at ``make_input(1_000, 3)``, with the same
empty output.
"""

import contextlib
import io
import re
import runpy
from pathlib import Path

import pytest

from tests.torch_entry_points import PKGS, PORT, REF, port_on_cpu, unsharded  # noqa: F401

ROOT = Path(__file__).parent.parent
EXAMPLES = ROOT / "examples"

KAFKA_GATED = {
    # Need confluent_kafka (transport) and/or a live broker and registry.
    "simple_kafka_in_and_out.py",
    "confluent_serde.py",
    "redpanda_serde.py",
    "redpanda_anomaly_detection.py",
}

BUILD_ONLY = KAFKA_GATED | {
    "brc.py",  # needs a measurements file
    "wordcount.py",  # a path relative to the repo root: runs below
    "benchmark_windowing.py",  # 1M items: runs below at a smaller input
}

# Build through the port's in-process broker (installed as
# ``confluent_kafka`` for the block); the other two need a registry.
KAFKA_INMEM = {"simple_kafka_in_and_out.py", "redpanda_anomaly_detection.py"}

RUNNABLE = sorted(p.name for p in EXAMPLES.glob("*.py") if p.name not in BUILD_ONLY)

WALL_CLOCK = {"periodic_input.py", "wikistream.py"}

_IMPORT = re.compile(r"^(\s*(?:from|import)\s.*)$", re.M)
_NAME = re.compile(r"\bbytewax_tpu\b(?!_torch)")


def port_copy(src: Path, tmp_path: Path) -> Path:
    """``src`` with the package named on its import lines swapped for
    the port, written under ``tmp_path``."""
    text = _IMPORT.sub(lambda m: _NAME.sub("bytewax_tpu_torch", m.group(1)), src.read_text())
    dst = tmp_path / src.name
    dst.write_text(text)
    return dst


@contextlib.contextmanager
def _own_metrics():
    """Unregisters the Prometheus collectors a run registered in the
    process-wide registry (``custom_metrics.py`` registers one; the
    second package's run would otherwise find the name taken)."""
    from prometheus_client import REGISTRY

    before = set(REGISTRY._collector_to_names)
    try:
        yield
    finally:
        for collector in set(REGISTRY._collector_to_names) - before:
            REGISTRY.unregister(collector)


def run_example(pkg, path: Path) -> str:
    """Loads ``path`` with ``runpy`` and runs its ``flow`` under
    ``pkg``'s ``run_main``; returns what it printed."""
    printed = io.StringIO()
    with _own_metrics(), contextlib.redirect_stdout(printed):
        mod = runpy.run_path(str(path))
        pkg["run_main"](mod["flow"])
    return printed.getvalue()


def _both(name, tmp_path, monkeypatch):
    """Runs the example and the port's copy of it from the repo root;
    returns the JAX package's and the port's printed lines (each run's
    own output directory printed as ``<out>``)."""
    monkeypatch.chdir(ROOT)
    copy = port_copy(EXAMPLES / name, tmp_path)
    out = []
    for pkg, path in ((REF, EXAMPLES / name), (PORT, copy)):
        out_dir = str(tmp_path / f"out_{pkg['name']}")
        monkeypatch.setenv("PARQUET_DEMO_OUT", out_dir)
        out.append(run_example(pkg, path).replace(out_dir, "<out>").splitlines())
    return out


def test_copy_imports_only_the_port(tmp_path):
    for name in sorted(p.name for p in EXAMPLES.glob("*.py")):
        text = port_copy(EXAMPLES / name, tmp_path).read_text()
        imports = _IMPORT.findall(text)
        assert not any(_NAME.search(line) for line in imports), name
        # Nothing but the import lines changed.
        original = (EXAMPLES / name).read_text()
        assert _IMPORT.sub("", text) == _IMPORT.sub("", original), name


@pytest.mark.parametrize("name", RUNNABLE)
def test_example_runs_through_the_port(name, tmp_path, monkeypatch):
    want, got = _both(name, tmp_path, monkeypatch)
    if name in WALL_CLOCK:
        assert got and want
        return
    assert got == want
    if name == "events_to_parquet.py":
        from pyarrow import parquet

        tables = [
            parquet.read_table(str(tmp_path / f"out_{pkg['name']}")).to_pylist() for pkg in PKGS
        ]
        assert len(tables[1]) == 500
        assert sorted(map(repr, tables[1])) == sorted(map(repr, tables[0]))
    else:
        assert got, f"{name} printed nothing"


def test_join_and_orderbook_print_what_the_reference_prints(tmp_path, monkeypatch):
    # Spelled out: the two examples of BASELINE.json's configs.
    for name, lines in (
        ("join.py", ["('1', ('Ada', 'ada@eng'))", "('2', ('Grace', 'grace@navy'))"]),
        ("orderbook.py", ["('BTC', (100.0, None, None))", "('ETH', (10.0, 10.2, 0.1999999999999993))"]),
    ):
        want, got = _both(name, tmp_path, monkeypatch)
        assert got == want
        assert set(lines) <= set(got)


def test_wordcount_example_runs_from_repo_root(tmp_path, monkeypatch):
    want, got = _both("wordcount.py", tmp_path, monkeypatch)
    assert sorted(got) == sorted(want)
    assert any(line.startswith("('the',") for line in got)


@pytest.mark.parametrize("name", sorted(p.name for p in EXAMPLES.glob("*.py")))
def test_example_builds_through_the_port(name, tmp_path, monkeypatch):
    from bytewax_tpu_torch.connectors.kafka import inmem
    from bytewax_tpu_torch.engine.flatten import flatten

    if name in KAFKA_GATED - KAFKA_INMEM:
        pytest.skip("needs a schema registry (and fastavro for the Avro serde)")
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("BRC_PATH", "examples/sample_data/tiny_brc.txt")
    copy = port_copy(EXAMPLES / name, tmp_path)
    broker = inmem.installed() if name in KAFKA_INMEM else contextlib.nullcontext()
    with _own_metrics(), broker:
        mod = runpy.run_path(str(copy))
        plan = flatten(mod["flow"])
    assert plan.ops
    assert all(type(o).__module__.startswith("bytewax_tpu_torch.") for o in plan.ops)
    modules = {getattr(v, "__module__", None) or "" for v in mod.values()}
    assert not {m for m in modules if m == "bytewax_tpu" or m.startswith("bytewax_tpu.")}


def test_windowing_benchmark_through_the_port(tmp_path, monkeypatch):
    """``BASELINE.json``'s windowing config: the example builds and
    flattens through the port, and its flow runs at a thousand items a
    batch over three batches with the reference's (empty) output."""
    monkeypatch.chdir(ROOT)
    printed = []
    for pkg, path in (
        (REF, EXAMPLES / "benchmark_windowing.py"),
        (PORT, port_copy(EXAMPLES / "benchmark_windowing.py", tmp_path)),
    ):
        bench = __import__(f"{pkg['name']}.models.windowing_bench", fromlist=["make_input"])
        mod = runpy.run_path(str(path))
        assert mod["flow"].flow_id == "bench"
        pkg["flatten"](mod["flow"])
        out = []
        flow = bench.windowing_bench_flow(
            pkg["Source"](bench.make_input(1_000, 3), 3), pkg["Sink"](out)
        )
        with contextlib.redirect_stdout(io.StringIO()) as stdout:
            pkg["run_main"](flow)
        printed.append((out, stdout.getvalue()))
    assert printed[1] == printed[0] == ([], "")
