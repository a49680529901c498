"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
in it has its files."""

import json
import re

from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds"} | set(KEYS)
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"] and len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["portbench"]
    for part, keys in KEYS.items():
        for entry in BENCH[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
            assert NAME.match(entry["name"]), entry["name"]
    for part in KEYS:
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_budget_and_bounds():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_name_has_its_files():
    pb = ROOT / "portbench"
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert (pb / "reference" / f"{c['name']}.py").is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (pb / "generators" / f"{cfg['generator']}.py").is_file()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
        assert (pb / "feeds" / f"{traffic['feed']}.py").is_file()
        spec = json.loads((pb / "cells" / f"{w['name']}.json").read_text())
        assert (pb / "flows" / f"{spec['flow']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in ws for name, ws in e2e.items() if name != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
        assert _line(m["layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
