"""The port's analyzer (``bytewax_tpu_torch.analysis``): the reference's
positive fixtures renamed to the port, one per rule, the alias shapes a
regex scan misses, inline waivers and the baseline file; the same
(rule, line) findings as the JAX package's analyzer on every original
fixture; and the port's own fixtures: ``torch.distributed`` collectives
on per-batch paths, a CUDA context bound before the platform is
chosen, and BTX-THREAD's site waiver."""

import re
from pathlib import Path

import pytest

from bytewax_tpu_torch.analysis import analyze_paths, contracts
from bytewax_tpu_torch.analysis.api import default_roots, discover_files
from bytewax_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    Waivers,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from bytewax_tpu_torch.analysis.resolver import Project
from bytewax_tpu_torch.analysis.rules import run_rules

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures_torch"
REFERENCE_FIXTURES = FIXTURES.parent / "analysis_fixtures"
REPO = FIXTURES.parent.parent
REFERENCE_NAMES = sorted(p.name for p in REFERENCE_FIXTURES.glob("fixture_*.py"))


def _diags(name, rules=None, scripts=False):
    diags, _suppressed, _project = analyze_paths(
        [FIXTURES / name],
        scripts=scripts,
        rule_ids=rules,
        rel_root=REPO,
    )
    return diags


def _code_lines(source):
    return "\n".join(
        line
        for line in source.splitlines()
        if not line.lstrip().startswith(("#", '"', "'"))
    )


# -- the reference's fixtures, renamed to the port ---------------------------


def test_reference_fixtures_are_all_ported():
    assert len(REFERENCE_NAMES) == 17
    assert all((FIXTURES / name).is_file() for name in REFERENCE_NAMES)


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_fixture_is_the_reference_renamed(name):
    """Each ported fixture is its original with ``bytewax_tpu`` renamed
    to ``bytewax_tpu_torch`` and nothing else, so an edit to the
    reference's fixture shows up here."""
    original = (REFERENCE_FIXTURES / name).read_text()
    assert (FIXTURES / name).read_text() == original.replace(
        "bytewax_tpu", "bytewax_tpu_torch"
    )


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_findings_match_the_reference_analyzer(name):
    """The port's analyzer on the renamed fixture reports the same
    (rule, line) pairs as the JAX package's analyzer on the original,
    every rule run; the backend fixture as a script through both."""
    from bytewax_tpu.analysis import analyze_paths as reference_analyze_paths

    scripts = name == "fixture_backend_script.py"
    ref, _s, _p = reference_analyze_paths(
        [REFERENCE_FIXTURES / name], scripts=scripts, rel_root=REPO
    )
    port = _diags(name, scripts=scripts)
    assert {(d.rule, d.lineno) for d in port} == {
        (d.rule, d.lineno) for d in ref
    }
    if name != "fixture_waived.py":
        assert port, name


def test_send_rule_flags_alias_smuggled_raw_send():
    diags = _diags("fixture_send_alias.py", ["BTX-SEND"])
    assert [d.rule for d in diags] == ["BTX-SEND"]
    assert "raw cluster send" in diags[0].message
    old_regex = re.compile(
        r"(?:\bcomm\s*\.\s*(?:send|broadcast)\s*\()"
        r"|(?:self\s*\.\s*comm\s*\.\s*(?:send|broadcast)\s*\()"
    )
    source = (FIXTURES / "fixture_send_alias.py").read_text()
    assert not old_regex.search(source)


def test_gsync_rule_flags_per_batch_reachability():
    diags = _diags("fixture_gsync_per_batch.py", ["BTX-GSYNC"])
    reach = [d for d in diags if "per-batch path" in d.message]
    assert reach, diags
    assert "EagerExchange.process" in reach[0].message
    assert "_sync_now" in reach[0].message  # witness chain
    source = (FIXTURES / "fixture_gsync_per_batch.py").read_text()
    assert not re.search(r"global_sync\s*\(", _code_lines(source))


def test_frames_rule_flags_rogue_kind():
    diags = _diags("fixture_frames_rogue.py", ["BTX-FRAMES"])
    msgs = "\n".join(d.message for d in diags)
    assert "rogue_frame" in msgs
    assert any("inventory drifted" in d.message for d in diags)
    assert any("sent in" in d.message for d in diags)


def test_fault_rule_flags_unknown_site_and_late_fire():
    diags = _diags("fixture_fault_site.py", ["BTX-FAULT"])
    msgs = "\n".join(d.message for d in diags)
    assert "device_dispatchx" in msgs
    assert "before firing" in msgs
    assert "_spin_helper" in msgs
    assert "_process_device" in msgs


def test_snapshot_rule_flags_missing_demotion_method():
    diags = _diags("fixture_snapshot_missing.py", ["BTX-SNAPSHOT"])
    assert [d.rule for d in diags] == ["BTX-SNAPSHOT"]
    assert "OrphanDeviceState" in diags[0].message


def test_snapshot_rule_flags_residency_pairing():
    diags = _diags("fixture_residency_missing.py", ["BTX-SNAPSHOT"])
    msgs = "\n".join(d.message for d in diags)
    assert "HalfResidentState" in msgs
    assert "inject_keys" in msgs
    assert "EvictingGlobalState" in msgs
    assert any(
        "global_exchange" in d.message and "residency" in d.message
        for d in diags
    )


def test_snapshot_rule_flags_infer_broadcast_state():
    diags = _diags("fixture_infer_snapshot.py", ["BTX-SNAPSHOT"])
    assert [d.rule for d in diags] == ["BTX-SNAPSHOT"]
    assert "BroadcastParamsState" in diags[0].message
    assert "EagerInferSpec.make_state" in diags[0].message
    assert "demotion_snapshots" in diags[0].message


def test_gsync_rule_flags_per_batch_swap_agreement():
    diags = _diags("fixture_infer_gsync.py", ["BTX-GSYNC"])
    reach = [d for d in diags if "per-batch path" in d.message]
    assert reach, diags
    assert "EagerSwapInfer.update" in reach[0].message
    assert "_agree_swap" in reach[0].message
    source = (FIXTURES / "fixture_infer_gsync.py").read_text()
    assert not re.search(r"global_sync\s*\(", _code_lines(source))


def test_thread_rule_flags_worker_lane_alias_send():
    diags = _diags("fixture_thread_worker_send.py", ["BTX-THREAD"])
    assert [d.rule for d in diags] == ["BTX-THREAD"]
    msg = diags[0].message
    assert "LeakyStep.process.<locals>.task" in msg
    assert "alias of a raw cluster send" in msg
    source = (FIXTURES / "fixture_thread_worker_send.py").read_text()
    assert not re.search(r"comm\s*\.\s*send\s*\(", source)
    assert "self._pipe.push(task, finalize)" in source.splitlines()[
        diags[0].lineno - 1
    ]


def test_drain_rule_flags_per_batch_eviction_and_flush():
    diags = _diags("fixture_drain_per_batch.py", ["BTX-DRAIN"])
    msgs = "\n".join(d.message for d in diags)
    assert "evict_to_budget" in msgs
    assert "EagerStep.process -> EagerStep._maybe_trim" in msgs
    assert "DevicePipeline.flush" in msgs
    assert "without first flushing" in msgs
    assert {d.rule for d in diags} == {"BTX-DRAIN"}


def test_knob_rule_flags_uncataloged_and_computed_reads():
    diags = _diags("fixture_knob_uncataloged.py", ["BTX-KNOB"])
    msgs = "\n".join(d.message for d in diags)
    assert "uncataloged knob BYTEWAX_TPU_TURBO" in msgs
    assert "computed BYTEWAX_TPU_* knob name" in msgs
    assert "BYTEWAX_TPU_SECRET_MODE" in msgs
    assert "BYTEWAX_TPU_STEALTH_MODE" in msgs
    assert len(diags) == 4


def test_lane_rule_flags_uncataloged_construction():
    diags = _diags("fixture_lane_uncataloged.py", ["BTX-LANE"])
    assert [d.rule for d in diags] == ["BTX-LANE"]
    assert "un-cataloged lane" in diags[0].message
    assert "SneakyStep.__init__" in diags[0].message
    source = (FIXTURES / "fixture_lane_uncataloged.py").read_text()
    assert "DevicePipeline(" in source.splitlines()[diags[0].lineno - 1]


def test_lane_rule_flags_unfenced_module():
    diags = _diags("fixture_lane_unfenced.py", ["BTX-LANE"])
    msgs = "\n".join(d.message for d in diags)
    unfenced = [d for d in diags if "un-fenced lane" in d.message]
    assert unfenced, diags
    assert ".shutdown()/.drop_pending()" in unfenced[0].message
    assert ".flush()" not in unfenced[0].message
    assert "un-cataloged lane" in msgs


def test_lane_rule_flags_unknown_ledger_phase():
    diags = _diags("fixture_lane_phase.py", ["BTX-LANE"])
    phase = [d for d in diags if "unknown ledger phase" in d.message]
    assert phase, diags
    assert "'turbo_lane'" in phase[0].message
    assert "ledger bucket" in phase[0].message


def test_race_rule_flags_alias_smuggled_write():
    diags = _diags("fixture_race_alias.py", ["BTX-RACE"])
    assert [d.rule for d in diags] == ["BTX-RACE"]
    msg = diags[0].message
    assert "RacyStep._tally" in msg
    assert "RacyStep.process.<locals>.task -> RacyStep._bump" in msg
    assert "(via RacyStep.process" in msg
    source = (FIXTURES / "fixture_race_alias.py").read_text()
    task = source[source.index("def task") : source.index("def finalize")]
    assert "self._tally" not in task
    assert "def _bump" in source.splitlines()[diags[0].lineno - 1]


def test_new_rule_waiver_round_trip(tmp_path):
    """Each rule's finding is suppressed by an inline waiver on the
    flagged line and reappears when the waiver is removed."""
    cases = {
        "fixture_thread_worker_send.py": "BTX-THREAD",
        "fixture_drain_per_batch.py": "BTX-DRAIN",
        "fixture_knob_uncataloged.py": "BTX-KNOB",
        "fixture_lane_uncataloged.py": "BTX-LANE",
        "fixture_race_alias.py": "BTX-RACE",
        "fixture_infer_snapshot.py": "BTX-SNAPSHOT",
        "fixture_infer_gsync.py": "BTX-GSYNC",
        "fixture_gsync_torch_collective.py": "BTX-GSYNC",
        "fixture_gsync_all_to_all_procs.py": "BTX-GSYNC",
        "fixture_gsync_c10d_import.py": "BTX-GSYNC",
    }
    for name, rule in cases.items():
        diags = _diags(name, [rule])
        assert diags, name
        lines = (FIXTURES / name).read_text().splitlines()
        for d in diags:
            lines[d.lineno - 1] += f"  # bytewax: allow[{rule}]"
        waived = tmp_path / name
        waived.write_text("\n".join(lines) + "\n")
        after, _s, _p = analyze_paths(
            [waived], rule_ids=[rule], rel_root=tmp_path
        )
        assert not after, (name, after)


def test_backend_rule_flags_unforced_script():
    diags = _diags(
        "fixture_backend_script.py", ["BTX-BACKEND"], scripts=True
    )
    assert [d.rule for d in diags] == ["BTX-BACKEND"]
    assert "run entry point" in diags[0].message
    assert not _diags("fixture_backend_script.py", ["BTX-BACKEND"])


def test_inline_waiver_suppresses_finding():
    assert not _diags("fixture_waived.py")


def test_waiver_parsing_is_comment_token_based():
    w = Waivers.parse(
        'x = "# bytewax: allow[BTX-SEND]"\n'
        "y = 1  # bytewax: allow[BTX-FRAMES]\n"
    )
    assert not w.waives(1, "BTX-SEND")
    assert w.waives(2, "BTX-FRAMES")
    w2 = Waivers.parse("# bytewax: allow[BTX-A,BTX-B]\ncall()\n")
    assert w2.waives(2, "BTX-A") and w2.waives(2, "BTX-B")
    assert not w2.waives(2, "BTX-C")


def test_string_literal_hash_does_not_hide_calls(tmp_path):
    source = (FIXTURES / "fixture_waived.py").read_text()
    probe = tmp_path / "_probe_unwaived.py"
    probe.write_text(source.replace("# bytewax: allow", "# waiver removed "))
    diags, _s, _p = analyze_paths(
        [probe], rule_ids=["BTX-SEND"], rel_root=tmp_path
    )
    assert len(diags) == 2  # both sends, incl. the '#'-string one


def test_baseline_round_trip(tmp_path):
    diags = _diags("fixture_send_alias.py", ["BTX-SEND"])
    assert diags
    baseline = tmp_path / "BASELINE"
    write_baseline(baseline, diags)
    remaining, suppressed = apply_baseline(diags, load_baseline(baseline))
    assert not remaining
    assert suppressed == len(diags)
    diags2, suppressed2, _p = analyze_paths(
        [FIXTURES / "fixture_send_alias.py"],
        rule_ids=["BTX-SEND"],
        baseline=baseline,
        rel_root=REPO,
    )
    assert not diags2
    assert suppressed2 == len(diags)


def test_baseline_is_line_number_free(tmp_path):
    d1 = Diagnostic("BTX-X", "a.py", 10, "msg")
    d2 = Diagnostic("BTX-X", "a.py", 99, "msg")
    baseline = tmp_path / "BASELINE"
    write_baseline(baseline, [d1])
    remaining, suppressed = apply_baseline([d2], load_baseline(baseline))
    assert not remaining and suppressed == 1


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(tmp_path / "nope") == set()
    assert load_baseline(None) == set()


def test_unknown_rule_id_raises():
    with pytest.raises(KeyError):
        _diags("fixture_send_alias.py", ["BTX-NOPE"])


# -- the port's own fixtures --------------------------------------------------


def test_gsync_rule_flags_torch_collective_through_both_imports():
    """``all_to_all_single`` reached from ``process`` through the
    module-level ``import torch.distributed as dist`` and from
    ``on_batch`` through an import inside the helper: two findings,
    each with its chain."""
    diags = _diags("fixture_gsync_torch_collective.py", ["BTX-GSYNC"])
    assert len(diags) == 2, diags
    by_root = {d.message.split()[2]: d for d in diags}
    assert set(by_root) == {"EagerShuffle.process", "LazyShuffle.on_batch"}
    assert "EagerShuffle.process -> EagerShuffle._swap" in by_root[
        "EagerShuffle.process"
    ].message
    assert "LazyShuffle.on_batch -> LazyShuffle._swap_lazily" in by_root[
        "LazyShuffle.on_batch"
    ].message
    for d in diags:
        assert "torch.distributed.all_to_all_single" in d.message
    source = (FIXTURES / "fixture_gsync_torch_collective.py").read_text()
    assert "torch.distributed.all_to_all_single(" not in source


def test_gsync_rule_flags_collectives_from_the_defining_submodule():
    """``all_to_all_single`` bound by a from-import of
    ``torch.distributed.distributed_c10d`` and ``barrier`` through that
    module imported under an alias: both resolve outside the cataloged
    paths and are flagged by name within ``torch.distributed``."""
    diags = _diags("fixture_gsync_c10d_import.py", ["BTX-GSYNC"])
    assert len(diags) == 2, diags
    by_root = {d.message.split()[2]: d.message for d in diags}
    assert set(by_root) == {"FromImportShuffle.process", "ModuleShuffle.on_batch"}
    assert "torch.distributed.distributed_c10d.all_to_all_single" in by_root[
        "FromImportShuffle.process"
    ]
    assert "torch.distributed.distributed_c10d.barrier" in by_root[
        "ModuleShuffle.on_batch"
    ]
    for dotted in (
        "torch.distributed.distributed_c10d.all_to_all_single",
        "torch.distributed.distributed_c10d.barrier",
    ):
        assert dotted not in contracts.TORCH_COLLECTIVES


def test_gsync_rule_flags_all_to_all_procs_alone():
    """A lone file (no ``parallel/`` in the scan) that calls the
    exchange's ``all_to_all_procs`` from ``process``: the call seeds by
    its resolved path."""
    diags = _diags("fixture_gsync_all_to_all_procs.py", ["BTX-GSYNC"])
    assert len(diags) == 1, diags
    msg = diags[0].message
    assert "RogueGlobalStep.process -> RogueGlobalStep._ship_now" in msg
    assert "bytewax_tpu_torch.parallel.exchange.all_to_all_procs" in msg


def test_gsync_rule_reaches_all_to_all_procs_through_the_tree(monkeypatch):
    """With the port's package in the scan and the entry table emptied,
    the same fixture is flagged through the call graph into
    ``parallel/exchange.py``'s own ``all_to_all_single`` calls: the
    module is no longer exempt as local."""
    monkeypatch.setattr(contracts, "CLUSTER_COLLECTIVE_ENTRIES", frozenset())
    pkg_dir, _scripts = default_roots()
    files = discover_files(pkg_dir, [])
    files.append(
        ("fixture_gsync_all_to_all_procs", FIXTURES / "fixture_gsync_all_to_all_procs.py", False)
    )
    project = Project.load(files, REPO)
    diags = run_rules(project, ["BTX-GSYNC"])
    assert len(diags) == 1, diags
    msg = diags[0].message
    assert diags[0].path.endswith("fixture_gsync_all_to_all_procs.py")
    assert "torch.distributed.all_to_all_single" in msg
    assert "bytewax_tpu_torch/parallel/exchange.py" in msg
    assert msg.split(" via ", 1)[1].startswith(
        "RogueGlobalStep.process -> RogueGlobalStep._ship_now -> all_to_all_procs"
    )


def test_backend_rule_flags_cuda_context_before_the_platform(tmp_path):
    """``torch.cuda.set_device`` before the script pops
    ``BYTEWAX_TPU_PLATFORM`` is a finding; the ``is_available`` probe is
    not; popping first makes the script clean."""
    diags = _diags("fixture_backend_cuda.py", ["BTX-BACKEND"], scripts=True)
    assert [d.rule for d in diags] == ["BTX-BACKEND"]
    assert "torch.cuda.set_device" in diags[0].message
    source = (FIXTURES / "fixture_backend_cuda.py").read_text()
    assert "torch.cuda.set_device(0)" in source.splitlines()[diags[0].lineno - 1]
    assert not _diags("fixture_backend_cuda.py", ["BTX-BACKEND"])
    lines = source.splitlines()
    pop = next(i for i, ln in enumerate(lines) if ln.strip().startswith("os.environ.pop"))
    guard = next(i for i, ln in enumerate(lines) if ln.strip().startswith("if torch.cuda.is_available"))
    lines.insert(guard, lines.pop(pop))
    fixed = tmp_path / "popped_first.py"
    fixed.write_text("\n".join(lines) + "\n")
    after, _s, _p = analyze_paths(
        [fixed], scripts=True, rule_ids=["BTX-BACKEND"], rel_root=tmp_path
    )
    assert not after, after


@pytest.mark.parametrize(
    "starter",
    [
        "torch.cuda.synchronize()",
        "torch.cuda.get_device_name(0)",
        'torch.distributed.init_process_group("gloo", rank=0, world_size=1)',
    ],
)
def test_backend_rule_starters(tmp_path, starter):
    """A ``torch.cuda`` call other than the two probes, or joining the
    ``torch.distributed`` world, starts the runtime."""
    script = tmp_path / "starter.py"
    script.write_text(
        "import torch\nimport torch.distributed\n\n"
        "torch.cuda.device_count()\n"
        f"{starter}\n"
    )
    diags, _s, _p = analyze_paths(
        [script], scripts=True, rule_ids=["BTX-BACKEND"], rel_root=tmp_path
    )
    assert [d.lineno for d in diags] == [5], diags


def test_thread_rule_honors_a_site_waiver(tmp_path):
    """A waiver on the touch's own line clears that touch for every
    lane: QuietStep is clean, LoudStep is flagged at the real surface
    past its waived call, and without the waivers both are flagged at
    ``emit``."""
    diags = _diags("fixture_thread_site_waiver.py", ["BTX-THREAD"])
    assert len(diags) == 1, diags
    assert "LoudStep.process.<locals>.task" in diags[0].message
    assert "surface ship_flush" in diags[0].message
    source = (FIXTURES / "fixture_thread_site_waiver.py").read_text()
    bare = tmp_path / "unwaived.py"
    bare.write_text(source.replace("# bytewax: allow[BTX-THREAD]", "# no waiver"))
    after, _s, _p = analyze_paths(
        [bare], rule_ids=["BTX-THREAD"], rel_root=tmp_path
    )
    assert sorted(d.message.split()[2] for d in after) == [
        "LoudStep.process.<locals>.task",
        "QuietStep.process.<locals>.task",
    ]
    assert all("surface emit" in d.message for d in after)
