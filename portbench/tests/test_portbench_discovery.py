"""A configuration, a traffic mix with a feed of its own, a cell and a
per-layer metric added as new files, in a copy of the benchmark, are
found and run with no existing file edited: a 1BRC variant, and a
configuration of another kind of data with its own generator, feed,
reference, flow and metric (the files under ``tests/ticks/``).  A cell
whose files do not fit together is refused before set-up."""

import json
import shutil

import pytest

from portbench import run
from portbench.tests.tiny import ROOT, SECONDS, overrides
from portbench.tools import control

#: A configuration that is not 1BRC, laid out as the files a change
#: would add to ``portbench/``.
TICKS = ROOT / "portbench" / "tests" / "ticks"

#: A new feed: every other block of the ring, handed as fast as the
#: engine pulls them.
_FEED = '''
import time

from bytewax_tpu_torch.engine.arrays import ArrayBatch
from portbench.sources import Part, Source

GENERATOR = "brc"
KEYS = ("batch_rows", "ring", "stride")


class Feed:
    def __init__(self, stream, traffic, workdir):
        self.stream, self.stride = stream, int(traffic["stride"])

    def source(self, handed, seconds, max_blocks=None):
        stream, stride = self.stream, self.stride

        def make():
            state = {"k": 0}

            def nxt():
                t0 = handed.start()
                k = state["k"]
                if (max_blocks is not None and k >= max_blocks) or (k and time.perf_counter() - t0 >= seconds):
                    raise StopIteration()
                b = k * stride
                handed.add(b, stream.batch_rows)
                state["k"] = k + 1
                return ArrayBatch(stream.columns(b), key_vocab=stream.stations.names, value_scale=0.1)

            return Part(nxt)

        return Source(make)

    def close(self):
        pass
'''


def _checkout(tmp_path):
    """A copy of the benchmark; returns its root and its files' bytes."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}


def _changed(root, before) -> set:
    """The files of ``before`` whose bytes differ now, as strings."""
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    return {str(p) for p in before if after.get(p) != before[p]}


def test_new_files_alone_make_a_new_cell(tmp_path):
    root, before = _checkout(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "brc-10k.json").read_text())
    cfg.update(name="brc-64z", stations=64, station_draw={"zipf": 1.1})
    (pb / "configs" / "brc-64z.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "reference" / "brc-10k.py", pb / "reference" / "brc-64z.py")
    (pb / "feeds" / "strided.py").write_text(_FEED)
    traffic = {"feed": "strided", "batch_rows": 1024, "ring": 4, "stride": 2}
    (pb / "traffic" / "strided_small.json").write_text(json.dumps(traffic))
    spec = json.loads((pb / "cells" / "brc-10k.columnar.json").read_text())
    (pb / "cells" / "brc-64z.strided_small.json").write_text(json.dumps(spec))
    (pb / "metrics" / "rows_per_call.py").write_text(
        "def read(ctx):\n    return ctx.rows / 1024\n"
    )
    # The new entries of BENCHMARK.json: the only change to a file
    # that was there.
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "brc-64z", "source": "https://github.com/gunnarmorling/1brc",
                             "file": "portbench/configs/brc-64z.json", "reduced": ["stations"],
                             "why": "a test"})
    bench["workloads"].append({"name": "brc-64z.strided_small", "config": "brc-64z",
                               "traffic": "strided_small", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "rows_per_call", "unit": "rows", "better": "higher",
                               "source": "host_clock", "layer": "source and ingest",
                               "moves": "rows_per_s", "workloads": ["brc-64z.strided_small"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "rows_per_s":
            m["workloads"].append("brc-64z.strided_small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = run.find_cell(root, "brc-64z.strided_small")
    assert cell.cfg["stations"] == 64 and cell.traffic["stride"] == 2
    assert [m["name"] for m in cell.metrics("per_layer")] == ["rows_per_call"]
    plain = run.run_cell(root, "brc-64z.strided_small", 4, SECONDS, False, device="cpu", tmp=tmp_path)
    assert plain["result"]["correct"]
    assert set(plain["result"]["metrics"]) == {"rows_per_s", "setup_s"}
    traced = run.run_cell(root, "brc-64z.strided_small", 4, SECONDS, True, device="cpu", tmp=tmp_path)
    assert traced["result"]["correct"]
    assert traced["result"]["metrics"]["rows_per_call"]["value"] == traced["context"].rows / 1024
    # No file that was there changed, but BENCHMARK.json.
    assert _changed(root, before) == {"BENCHMARK.json"}
    # The shipped cells are untouched by the copy's additions.
    assert run.find_cell(ROOT, "brc-10k.columnar", overrides("brc-10k.columnar")).cfg["stations"] == 40


def _add_ticks(root):
    """Every file of ``tests/ticks/`` as a new file of the copy's
    benchmark, and its entries in the copy's ``BENCHMARK.json``."""
    pb = root / "portbench"
    for src in sorted(TICKS.rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            dest = pb / src.relative_to(TICKS)
            assert not dest.exists(), dest
            shutil.copy(src, dest)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ticks-64", "source": "a test of the harness",
                             "file": "portbench/configs/ticks-64.json", "reduced": [],
                             "why": "rising keys"})
    bench["workloads"].append({"name": "ticks-64.ticks_small", "config": "ticks-64",
                               "traffic": "ticks_small", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window_fanout", "unit": "windows/row", "better": "lower",
                               "source": "program_counter", "layer": "windows",
                               "moves": "rows_per_s", "workloads": ["ticks-64.ticks_small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append("ticks-64.ticks_small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_configuration_of_other_data_is_new_files_alone(tmp_path):
    root, before = _checkout(tmp_path)
    _add_ticks(root)
    cell = run.find_cell(root, "ticks-64.ticks_small")
    assert cell.cfg["generator"] == "ticks" and "stations" not in cell.cfg
    plain = run.run_cell(root, cell.name, 2**31 + 9, SECONDS, False, device="cpu", tmp=tmp_path)
    result = plain["result"]
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == ["missing", "count_err"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"rows_per_s", "setup_s"}
    traced = run.run_cell(root, cell.name, 5, SECONDS, True, device="cpu", tmp=tmp_path)
    assert traced["result"]["correct"], traced["result"]["checks"]
    # A 1 s window every 0.25 s: each event is counted in 4 windows.
    assert traced["result"]["metrics"]["window_fanout"]["value"] == 4.0
    # The reference names its own control: counts in bfloat16 go wrong
    # past 256, in float32 they stay exact.
    low = control.read(cell.name, 7, 6, "cpu", root=root)
    assert low["dtype"] == "bfloat16" and not low["correct"]
    assert low["checks"]["count_err"]["value"] > 0
    assert control.read(cell.name, 7, 6, "cpu", "float32", root=root)["correct"]
    assert _changed(root, before) == {"BENCHMARK.json"}


def _no_generator(pb):
    cfg = json.loads((pb / "configs" / "brc-10k.json").read_text())
    del cfg["generator"]
    (pb / "configs" / "brc-10k.json").write_text(json.dumps(cfg))


def _absent_generator(pb):
    cfg = json.loads((pb / "configs" / "brc-10k.json").read_text())
    (pb / "configs" / "brc-10k.json").write_text(json.dumps(dict(cfg, generator="nexmark")))


def _another_generator(pb):
    # The same rows under another generator's name: the feed, written
    # for "brc", may not read them.
    shutil.copy(pb / "generators" / "brc.py", pb / "generators" / "brc_copy.py")
    cfg = json.loads((pb / "configs" / "brc-10k.json").read_text())
    (pb / "configs" / "brc-10k.json").write_text(json.dumps(dict(cfg, generator="brc_copy")))


def _no_judge(pb):
    path = pb / "reference" / "brc-10k.py"
    path.write_text(path.read_text() + "\ndel judge\n")


@pytest.mark.parametrize("breach,message", [
    (_no_generator, "names no generator"),
    (_absent_generator, "generators/nexmark.py is missing"),
    (_another_generator, "feed 'columnar' reads generator 'brc'; configuration 'brc-10k' names 'brc_copy'"),
    (_no_judge, "reference 'brc-10k' has no judge"),
], ids=["no_generator", "absent_generator", "feed_of_another_generator", "reference_without_judge"])
def test_a_cell_whose_files_do_not_fit_is_refused_before_set_up(breach, message, tmp_path):
    root, _before = _checkout(tmp_path)
    breach(root / "portbench")
    with pytest.raises(run.BenchError, match=message) as got:
        run.run_cell(root, "brc-10k.columnar", 3, SECONDS, False, device="cpu",
                     overrides=overrides("brc-10k.columnar"), tmp=tmp_path)
    assert "\n" not in str(got.value)
