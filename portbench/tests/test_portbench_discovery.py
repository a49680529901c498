"""A configuration, a traffic mix with a feed of its own, a cell and a
per-layer metric added as new files, in a copy of the benchmark, are
found and run with no existing file edited."""

import json
import shutil

from portbench import run
from portbench.tests.tiny import ROOT, SECONDS, overrides

#: A new feed: every other block of the ring, handed as fast as the
#: engine pulls them.
_FEED = '''
import time

from bytewax_tpu_torch.engine.arrays import ArrayBatch
from portbench.sources import Part, Source

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


def test_new_files_alone_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
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
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    changed = {p for p in before if after.get(p) != before[p]}
    assert {str(p) for p in changed} == {"BENCHMARK.json"}
    # The shipped cells are untouched by the copy's additions.
    assert run.find_cell(ROOT, "brc-10k.columnar", overrides("brc-10k.columnar")).cfg["stations"] == 40
