"""Tier-1 wrapper around the port's engine-contract analyzer: the
port's tree must be clean, through the API and through
``python -m bytewax_tpu_torch.analysis``, and the port's catalog must
agree with the docs."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bytewax_tpu_torch.analysis import analyze_tree
from bytewax_tpu_torch.analysis.contracts import KNOBS
from bytewax_tpu_torch.analysis.diagnostics import format_diagnostics
from bytewax_tpu_torch.analysis.rules import ALL_RULES

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures_torch"

#: Knobs of the JAX package's docs/configuration.md that the port
#: does not read (it runs its kernels eagerly: no Pallas switch, no
#: compile cache, no pad ladder).
NOT_IN_THE_PORT = {
    "BYTEWAX_TPU_PALLAS",
    "BYTEWAX_TPU_COMPILE_CACHE",
    "BYTEWAX_TPU_PAD_MIN_POW",
    "BYTEWAX_TPU_PAD_MAX_POW",
}

_KNOB_ROW = re.compile(
    r"^\|\s*`(BYTEWAX_TPU_[A-Z0-9_]+)`\s*\|\s*(?:`([^`|]*)`)?\s*\|",
    re.MULTILINE,
)


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=timeout,
    )


def _readme_port_section():
    text = (REPO / "README.md").read_text()
    return text.split("## The PyTorch/CUDA port", 1)[1].split("\n## ", 1)[0]


def test_tree_is_clean():
    timings = {}
    t0 = time.perf_counter()
    diags, suppressed, project = analyze_tree(timings=timings)
    wall = time.perf_counter() - t0
    assert not diags, (
        "the port's tree violates an engine contract (see "
        "docs/contracts.md):\n" + format_diagnostics(diags)
    )
    assert suppressed == 0
    # The scan covered the engine and the one script that drives it.
    assert "bytewax_tpu_torch.engine.driver" in project.modules
    assert project.modules["chip_smoke"].is_script
    assert not any(m.startswith(("examples.", "bytewax_tpu.")) for m in project.modules)
    assert set(timings) == set(ALL_RULES) | {"<call-graph>"}
    assert wall < 30, f"analyzer took {wall:.1f}s on the tree"


def test_rule_registry_is_complete():
    from bytewax_tpu.analysis.rules import ALL_RULES as REFERENCE_RULES

    assert list(ALL_RULES) == list(REFERENCE_RULES)
    assert set(ALL_RULES) == {
        "BTX-SEND",
        "BTX-GSYNC",
        "BTX-FRAMES",
        "BTX-FAULT",
        "BTX-SNAPSHOT",
        "BTX-BACKEND",
        "BTX-DRAIN",
        "BTX-THREAD",
        "BTX-KNOB",
        "BTX-LANE",
        "BTX-RACE",
    }


def test_docs_rule_catalog_matches_registry():
    text = (REPO / "docs" / "contracts.md").read_text()
    catalog = text.split("## Rule catalog", 1)[1].split("##", 1)[0]
    documented = set(
        re.findall(r"^\|\s*`(BTX-[A-Z]+)`", catalog, re.MULTILINE)
    )
    assert documented == set(ALL_RULES)


def test_docs_knob_table_matches_catalog():
    """The port's catalog is docs/configuration.md's table less the
    knobs the port does not read, plus the README port section's table,
    names and defaults alike; each knob anchors to the page that
    documents it."""
    shared = dict(_KNOB_ROW.findall((REPO / "docs" / "configuration.md").read_text()))
    own = dict(_KNOB_ROW.findall(_readme_port_section()))
    assert own, "the README's port section lists no knob"
    assert not set(own) & set(shared)
    assert NOT_IN_THE_PORT <= set(shared)
    assert set(KNOBS) == (set(shared) - NOT_IN_THE_PORT) | set(own)
    rows = {**shared, **own}
    for name, (default, doc) in KNOBS.items():
        assert rows[name] == default, (name, rows[name], default)
        assert (doc == "README.md") == (name in own), (name, doc)


#: Metric families of docs/observability.md that only the JAX package
#: registers: the port compiles no XLA programs.
METRICS_NOT_IN_THE_PORT = {"bytewax_xla_compile_count", "bytewax_xla_compile_seconds"}


def test_docs_metrics_inventory_matches_registry():
    """docs/observability.md's metrics inventory lists exactly the
    families the port's ``_metrics.py`` registers, and the XLA compile
    families the port has no use for."""
    from prometheus_client import Counter, Gauge, Histogram

    import bytewax_tpu_torch._metrics as _metrics

    registered = {
        m._name
        for m in vars(_metrics).values()
        if isinstance(m, (Counter, Gauge, Histogram))
    }
    registered |= {h._name for h in _metrics.DURATION_HISTOGRAMS.values()}
    text = (REPO / "docs" / "observability.md").read_text()
    inventory = text.split("## Metrics inventory", 1)[1].split("\n## ", 1)[0]
    documented = set(re.findall(r"`(bytewax_[a-z0-9_]+)`", inventory))
    assert METRICS_NOT_IN_THE_PORT <= documented
    documented -= METRICS_NOT_IN_THE_PORT
    assert documented == registered, (
        f"doc-only {sorted(documented - registered)}, "
        f"undocumented {sorted(registered - documented)}"
    )


def test_cli_exits_zero_on_shipped_tree():
    res = _cli()
    assert res.returncode == 0, res.stdout + res.stderr
    assert "bytewax_tpu_torch.analysis: 11 rule(s), clean" in res.stderr


def test_cli_sarif_full_tree_smoke():
    res = _cli("--output", "sarif")
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    (run,) = doc["runs"]
    assert run["tool"]["driver"]["name"] == "bytewax_tpu_torch.analysis"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == set(ALL_RULES)
    assert run["results"] == []


def test_cli_exits_nonzero_on_positive_fixture():
    res = _cli(str(FIXTURES / "fixture_send_alias.py"))
    assert res.returncode == 1, res.stdout + res.stderr
    assert "BTX-SEND" in res.stdout


#: Each positive fixture and the rule it breaks (the script fixtures
#: are analyzed with ``--scripts``).
FIXTURE_RULES = {
    "fixture_backend_cuda.py": "BTX-BACKEND",
    "fixture_backend_script.py": "BTX-BACKEND",
    "fixture_drain_per_batch.py": "BTX-DRAIN",
    "fixture_fault_site.py": "BTX-FAULT",
    "fixture_frames_rogue.py": "BTX-FRAMES",
    "fixture_gsync_all_to_all_procs.py": "BTX-GSYNC",
    "fixture_gsync_c10d_import.py": "BTX-GSYNC",
    "fixture_gsync_per_batch.py": "BTX-GSYNC",
    "fixture_gsync_torch_collective.py": "BTX-GSYNC",
    "fixture_infer_gsync.py": "BTX-GSYNC",
    "fixture_infer_snapshot.py": "BTX-SNAPSHOT",
    "fixture_knob_uncataloged.py": "BTX-KNOB",
    "fixture_lane_phase.py": "BTX-LANE",
    "fixture_lane_uncataloged.py": "BTX-LANE",
    "fixture_lane_unfenced.py": "BTX-LANE",
    "fixture_race_alias.py": "BTX-RACE",
    "fixture_residency_missing.py": "BTX-SNAPSHOT",
    "fixture_send_alias.py": "BTX-SEND",
    "fixture_snapshot_missing.py": "BTX-SNAPSHOT",
    "fixture_thread_site_waiver.py": "BTX-THREAD",
    "fixture_thread_worker_send.py": "BTX-THREAD",
}


def test_cli_exits_nonzero_on_each_fixture():
    on_disk = {p.name for p in FIXTURES.glob("fixture_*.py")}
    assert on_disk == set(FIXTURE_RULES) | {"fixture_waived.py"}
    for name, rule in FIXTURE_RULES.items():
        extra = ["--scripts"] if "backend" in name else []
        res = _cli("--rule", rule, *extra, str(FIXTURES / name))
        assert res.returncode == 1, (name, res.stdout, res.stderr)
        assert rule in res.stdout, (name, res.stdout)
    res = _cli(str(FIXTURES / "fixture_waived.py"))
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_rule_filter_json_and_timings():
    res = _cli("--rule", "BTX-KNOB", "--json", "--timings", str(FIXTURES / "fixture_knob_uncataloged.py"))
    assert res.returncode == 1, res.stdout + res.stderr
    records = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert records and all(r["rule"] == "BTX-KNOB" for r in records)
    timing_lines = [json.loads(line) for line in res.stderr.splitlines() if line.startswith("{")]
    assert timing_lines and "BTX-KNOB" in timing_lines[0]["timings_s"]
    assert "BTX-SEND" not in timing_lines[0]["timings_s"]


@pytest.mark.parametrize("write_baseline", [False, True], ids=["report", "write-baseline"])
def test_cli_sarif_output(tmp_path, write_baseline):
    """``--output sarif`` emits one SARIF 2.1.0 document, composes with
    ``--rule`` (the inventory is what ran) and with ``--write-baseline``
    (the document is still emitted, the baseline written, exit 0)."""
    fixture = FIXTURES / "fixture_race_alias.py"
    args = ["--rule", "BTX-RACE", "--output", "sarif"]
    baseline = tmp_path / "BASELINE"
    if write_baseline:
        args += ["--write-baseline", "--baseline", str(baseline)]
    res = _cli(*args, str(fixture))
    assert res.returncode == (0 if write_baseline else 1), res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "bytewax_tpu_torch.analysis"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == ["BTX-RACE"]
    (result,) = run["results"]
    assert result["ruleId"] == "BTX-RACE"
    assert result["level"] == "error"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("fixture_race_alias.py")
    assert loc["region"]["startLine"] > 0
    assert baseline.exists() == write_baseline
