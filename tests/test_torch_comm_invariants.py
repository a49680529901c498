"""The port's contract catalog, pinned (``bytewax_tpu_torch/analysis/
contracts.py``).

Each inventory the rules consume is hardcoded here with the port's
module names, so editing the catalog alone cannot silently relax a
contract; each is also held against the JAX package's catalog with the
names mapped, so an edit to the reference's catalog that the port does
not follow fails here instead of drifting.  The two catalogs differ
only where the port does (``PORT_ONLY_DIFFERENCES``)."""

import functools
import json
import subprocess
import sys

import pytest

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.api import default_roots, discover_files
from bytewax_tpu_torch.analysis.diagnostics import (
    Waivers,
    apply_waivers,
    format_diagnostics,
)
from bytewax_tpu_torch.analysis.resolver import Project
from bytewax_tpu_torch.analysis.rules import run_rules

DRIVER = "bytewax_tpu_torch.engine.driver"
SHARDED = "bytewax_tpu_torch.engine.sharded_state"


@functools.lru_cache(maxsize=1)
def _project():
    pkg_dir, scripts = default_roots()
    return Project.load(discover_files(pkg_dir, scripts), pkg_dir.parent)


def _check(rule_ids):
    """Run rules with the inline waivers honored, as
    ``python -m bytewax_tpu_torch.analysis`` does."""
    project = _project()
    diags = run_rules(project, rule_ids)
    waivers = {mod.rel: Waivers.parse(mod.source) for mod in project.modules.values()}
    return apply_waivers(diags, waivers)


def _forbidden_calls():
    return contracts.RAW_SEND_METHODS | contracts.SHIP_METHODS | contracts.GSYNC_PRIMITIVES


def _assert_process_local(modules, prefixes=(), at_least=1):
    allowlisted = set().union(*contracts.SEND_ALLOWED.values()) | contracts.GSYNC_CALLER_MODULES
    assert not (modules & allowlisted)
    if prefixes:
        assert not any(m.startswith(prefixes) for m in allowlisted)
    checked = 0
    for qual, fn in _project().functions.items():
        mod = qual.split(":", 1)[0]
        if mod in modules or (prefixes and mod.startswith(prefixes)):
            checked += 1
            comm_calls = [c.name for c in fn.calls if c.name in _forbidden_calls()]
            assert not comm_calls, f"{qual} calls {comm_calls}"
    assert checked >= at_least


# -- the port against the reference ------------------------------------------

#: Tables that differ from the JAX package's catalog, and why: the
#: collectives are ``torch.distributed``'s and the port's own entry
#: points into them (no ``jax.lax``, no ``shard_map``, no module exempt
#: as local); the knobs lose the JAX-only four and gain the port's
#: own; BTX-BACKEND's forcing keys and starters are the port's.
PORT_ONLY_DIFFERENCES = {
    "JAX_COLLECTIVES": "reference only",
    "COLLECTIVE_WRAPPERS": "reference only",
    "FORCE_JAX_FLAGS": "reference only",
    "TORCH_COLLECTIVES": "port only",
    "CLUSTER_COLLECTIVE_ENTRIES": "port only",
    "RUNTIME_STARTERS": "port only",
    "TORCH_CUDA_PREFIX": "port only",
    "TORCH_CUDA_PROBES": "port only",
    "LOCAL_COLLECTIVE_MODULES": "both",
    "KNOBS": "both",
    "FORCE_ENV_KEYS": "both",
}


def _mapped(value):
    """A reference catalog value with the JAX package's module names
    mapped onto the port's."""
    if isinstance(value, str):
        return value.replace("bytewax_tpu", "bytewax_tpu_torch")
    if isinstance(value, tuple):
        return tuple(_mapped(v) for v in value)
    if isinstance(value, frozenset):
        return frozenset(_mapped(v) for v in value)
    if isinstance(value, dict):
        return {_mapped(k): _mapped(v) for k, v in value.items()}
    return value


def _tables(module):
    return {name: getattr(module, name) for name in dir(module) if name.isupper()}


def test_catalog_is_the_reference_mapped_except_where_the_port_differs():
    from bytewax_tpu.analysis import contracts as reference

    ref = {name: _mapped(v) for name, v in _tables(reference).items()}
    port = _tables(contracts)
    differ = {
        name
        for name in set(ref) | set(port)
        if name not in ref or name not in port or ref[name] != port[name]
    }
    assert differ == set(PORT_ONLY_DIFFERENCES)
    for name, where in PORT_ONLY_DIFFERENCES.items():
        assert (name in ref, name in port) == {
            "reference only": (True, False),
            "port only": (False, True),
            "both": (True, True),
        }[where], name
    # The differences themselves, exactly.
    assert port["LOCAL_COLLECTIVE_MODULES"] == frozenset()
    assert ref["LOCAL_COLLECTIVE_MODULES"] == {
        "bytewax_tpu_torch.ops.sharded",
        "bytewax_tpu_torch.parallel.exchange",
        "bytewax_tpu_torch.parallel.mesh",
    }
    assert port["FORCE_ENV_KEYS"] == ref["FORCE_ENV_KEYS"] - {"JAX_PLATFORMS"}
    dropped = set(ref["KNOBS"]) - set(port["KNOBS"])
    added = set(port["KNOBS"]) - set(ref["KNOBS"])
    assert dropped == {
        "BYTEWAX_TPU_PALLAS",
        "BYTEWAX_TPU_COMPILE_CACHE",
        "BYTEWAX_TPU_PAD_MIN_POW",
        "BYTEWAX_TPU_PAD_MAX_POW",
    }
    assert added == {"BYTEWAX_TPU_VIRTUAL_DEVICES"}
    assert all(port["KNOBS"][k] == ref["KNOBS"][k] for k in set(port["KNOBS"]) & set(ref["KNOBS"]))


def test_catalog_names_exist_in_the_port():
    """Every module, function and ``module:qualname`` the port's catalog
    names exists in the port's tree (run entry points re-exported by
    ``testing`` resolve through its imports)."""
    project = _project()

    def exists(dotted):
        if dotted in project.modules or project.lookup(dotted) is not None:
            return True
        mod, _, attr = dotted.rpartition(".")
        bound = project.modules[mod].bindings.get(attr) if mod in project.modules else None
        return bound is not None and project.lookup(bound) is not None

    checked = 0
    for name, value in _tables(contracts).items():
        items = value.items() if isinstance(value, dict) else [(value, None)]
        for key, val in items:
            for entry in (key, val):
                for leaf in _leaves(entry):
                    if isinstance(leaf, tuple):
                        assert f"{leaf[0]}:{leaf[1]}" in project.functions, (name, leaf)
                    elif ":" in leaf and leaf.startswith("bytewax_tpu_torch."):
                        mod = leaf.split(":", 1)[0]
                        assert mod in project.modules, (name, leaf)
                        if "<globals>" not in leaf and "." not in leaf.split(":", 1)[1]:
                            assert leaf in project.functions, (name, leaf)
                    elif leaf.startswith("bytewax_tpu_torch."):
                        assert exists(leaf), (name, leaf)
                    else:
                        continue
                    checked += 1
    assert checked > 60


def _leaves(entry):
    if isinstance(entry, tuple) and len(entry) == 2 and all(isinstance(e, str) for e in entry):
        if entry[0].startswith("bytewax_tpu_torch."):
            yield entry
            return
    if isinstance(entry, (tuple, frozenset, set, list)):
        for e in entry:
            yield from _leaves(e)
    elif isinstance(entry, dict):
        for k, v in entry.items():
            yield from _leaves(k)
            yield from _leaves(v)
    elif isinstance(entry, str):
        yield entry


# -- the pinned inventories ---------------------------------------------------


def test_no_raw_sends_outside_comm_and_driver():
    diags = _check(["BTX-SEND"])
    assert not diags, format_diagnostics(diags)


def test_collectives_only_at_ordered_points():
    """The tree is clean under BTX-GSYNC, and the seeds it is clean
    against are really there: the exchange's ``all_to_all_single``
    calls and the world join's three collectives."""
    diags = _check(["BTX-GSYNC"])
    assert not diags, format_diagnostics(diags)
    from bytewax_tpu_torch.analysis.rules.gsync import _seed_calls

    project = _project()
    seeds = {
        fn.id: sorted({what for _line, what in _seed_calls(project, fn)})
        for fn in project.iter_functions()
        if fn.module.startswith("bytewax_tpu_torch.parallel")
    }
    seeds = {k: v for k, v in seeds.items() if v}
    assert seeds == {
        "bytewax_tpu_torch.parallel.exchange:all_to_all_procs": ["torch.distributed.all_to_all_single"],
        "bytewax_tpu_torch.parallel.exchange:exchange_procs": [
            "bytewax_tpu_torch.parallel.exchange.all_to_all_procs"
        ],
        "bytewax_tpu_torch.parallel.mesh:init_world": [
            "torch.distributed.all_gather_object",
            "torch.distributed.init_process_group",
            "torch.distributed.new_group",
        ],
    }


def test_collective_catalog_is_pinned():
    assert contracts.TORCH_COLLECTIVES == {
        f"torch.distributed.{name}"
        for name in (
            "all_to_all_single",
            "all_to_all",
            "all_gather_object",
            "all_gather",
            "all_gather_into_tensor",
            "all_reduce",
            "reduce",
            "reduce_scatter",
            "reduce_scatter_tensor",
            "broadcast",
            "broadcast_object_list",
            "gather",
            "gather_object",
            "scatter",
            "scatter_object_list",
            "barrier",
            "monitored_barrier",
            "send",
            "recv",
            "isend",
            "irecv",
            "batch_isend_irecv",
            "init_process_group",
            "new_group",
        )
    }
    assert contracts.LOCAL_COLLECTIVE_MODULES == frozenset()
    assert contracts.CLUSTER_COLLECTIVE_ENTRIES == {
        "bytewax_tpu_torch.parallel.exchange.all_to_all_procs",
        "bytewax_tpu_torch.parallel.exchange.exchange_procs",
        "bytewax_tpu_torch.parallel.mesh.init_world",
    }
    # Each entry is a function of the tree that itself reaches a
    # torch.distributed collective over the call graph.
    from bytewax_tpu_torch.analysis.rules.gsync import _seed_calls

    project = _project()
    for dotted in contracts.CLUSTER_COLLECTIVE_ENTRIES:
        kind, fid = project.lookup(dotted)
        assert kind == "func", dotted
        todo, seen, found = [fid], set(), False
        while todo and not found:
            cur = todo.pop()
            if cur in seen:
                continue
            seen.add(cur)
            fn = project.functions[cur]
            found = any(w in contracts.TORCH_COLLECTIVES for _l, w in _seed_calls(project, fn))
            todo.extend(t for c in fn.calls for t in c.targets)
        assert found, dotted


def test_control_frame_inventory_is_pinned():
    assert contracts.CONTROL_FRAMES == {
        "deliver",
        "route",
        "report_msg",
        "hold",
        "eof_step",
        "close_epoch",
        "gsync",
        "abort",
    }
    diags = _check(["BTX-FRAMES"])
    assert not diags, format_diagnostics(diags)


def test_fault_site_inventory_is_pinned():
    assert contracts.FAULT_SITES == (
        "comm.send",
        "comm.recv",
        "device_dispatch",
        "residency_restore",
        "source_poll",
        "sink_write",
        "snapshot.write",
        "snapshot.commit",
        "snapshot_seal",
        "rescale_migrate",
        "params_swap",
        "barrier",
    )
    assert contracts.FAULT_DEVICE_SITES == {"device_dispatch", "residency_restore"}
    diags = _check(["BTX-FAULT"])
    assert not diags, format_diagnostics(diags)


def test_send_surface_allowlist_is_pinned():
    assert contracts.SEND_ALLOWED == {
        "comm_construct": {"bytewax_tpu_torch.engine.comm", DRIVER},
        "raw_send": {"bytewax_tpu_torch.engine.comm", DRIVER},
        "ship": {DRIVER},
    }
    assert contracts.SHIP_METHODS == {"ship_deliver", "ship_route", "ship_flush"}
    assert contracts.WIRE_MODULE == "bytewax_tpu_torch.engine.wire"
    assert contracts.WIRE_ALLOWED_MODULES == {
        "bytewax_tpu_torch.engine.comm",
        DRIVER,
        SHARDED,
        "bytewax_tpu_torch.engine.wire",
    }
    assert contracts.GSYNC_CALLER_MODULES == {DRIVER, SHARDED}


def test_allowlist_is_not_stale():
    project = _project()
    for fn in ("ship_deliver", "ship_route", "ship_flush", "global_sync"):
        assert f"{DRIVER}:_Driver.{fn}" in project.functions
    flush = project.functions[f"{SHARDED}:GlobalAggState.flush"]
    assert any(call.name in contracts.GSYNC_PRIMITIVES for call in flush.calls)
    pre_close = project.functions[f"{DRIVER}:_StatefulBatchRt.pre_close"]
    assert any(
        "GlobalAggState.flush" in t for call in pre_close.calls for t in call.targets
    ), "call graph lost the pre_close -> global flush edge"


def test_connector_edge_resilience_is_process_local():
    _assert_process_local(
        {"bytewax_tpu_torch.engine.backoff", "bytewax_tpu_torch.engine.dlq"}, at_least=8
    )


def test_drain_point_inventory_is_pinned():
    assert contracts.DRAIN_ONLY_METHODS == {
        "evict_to_budget",
        "prepare",
        "prepare_entries",
        "extract_keys",
        "inject_keys",
        "demotion_snapshots",
        "pipeline_flush",
        "pipeline_shutdown",
        "_pipe_shutdown",
        "_close_epoch",
        "_close_epoch_inner",
        "ship_flush",
        "_ckpt_seal",
        "_ckpt_fence",
        "_ckpt_shutdown",
        "_apply_params_swap",
        "install_params",
    }
    assert contracts.PIPELINE_DRAIN_METHODS == {"flush", "shutdown", "drop_pending"}
    assert contracts.DRAIN_POINTS == {
        (DRIVER, "_StatefulBatchRt.advance"),
        (DRIVER, "_StatefulBatchRt._demote"),
        (DRIVER, "_InferRt._demote"),
        (DRIVER, "_Driver._close_epoch"),
        (DRIVER, "_Driver._close_epoch_inner"),
        (DRIVER, "_Driver._drain_pipelines"),
        (DRIVER, "_Driver._apply_eof_step"),
        (DRIVER, "_Driver._startup_rescale"),
        (DRIVER, "_Driver.run"),
    }
    assert contracts.DRAIN_POINT_METHOD_NAMES == {
        "pre_close",
        "on_upstream_eof",
        "epoch_snaps",
        "on_notify",
        "on_eof",
    }
    assert contracts.GSYNC_PREFLUSHED == {
        (SHARDED, "GlobalAggState.flush"),
        (DRIVER, "_Driver.run"),
        (DRIVER, "_Driver._startup_rescale"),
    }
    project = _project()
    for module, qualname in contracts.DRAIN_POINTS:
        assert f"{module}:{qualname}" in project.functions, qualname
    diags = _check(["BTX-DRAIN"])
    assert not diags, format_diagnostics(diags)


def test_worker_lane_inventory_is_pinned():
    """The worker-lane roots traced out of the pipeline submissions:
    the three device-tier tasks, the collective lane's two sealed tasks
    (pushed by name, so the analyzer sees them), the committer task and
    the inference task."""
    from bytewax_tpu_torch.analysis.rules.thread import worker_lane_roots

    roots = worker_lane_roots(_project())
    assert set(roots) == {
        f"{DRIVER}:_StatefulBatchRt._push_window_task.<locals>.task",
        f"{DRIVER}:_StatefulBatchRt._push_scan_task.<locals>.task",
        f"{DRIVER}:_StatefulBatchRt._process_accel.<locals>.<lambda>",
        f"{SHARDED}:GlobalAggState.flush.<locals>.exchange_task",
        f"{SHARDED}:GlobalAggState.flush.<locals>.merge_task",
        f"{DRIVER}:_Driver._ckpt_seal.<locals>.commit_task",
        f"{DRIVER}:_InferRt._push_infer_task.<locals>.task",
    }
    assert contracts.SNAPSHOT_LANE_ROOTS == {f"{DRIVER}:_Driver._ckpt_seal.<locals>.commit_task"}
    assert contracts.SNAPSHOT_LANE_MODULE == "bytewax_tpu_torch.engine.recovery_store"
    assert contracts.SNAPSHOT_LANE_SAFE == {"write_epoch"}
    for name in (
        "ship_deliver",
        "ship_route",
        "ship_flush",
        "send",
        "broadcast",
        "global_sync",
        "next_gsync_tag",
        "emit",
        "route",
        "write_epoch",
        "evict_to_budget",
        "inject_keys",
        "demotion_snapshots",
        "pipeline_flush",
        "flush",
        "push",
        "submit",
        "_close_epoch",
        "_ckpt_shutdown",
    ):
        assert name in contracts.MAIN_ONLY, name
    assert contracts.MAIN_ONLY_MODULES == {
        "bytewax_tpu_torch.engine.comm",
        "bytewax_tpu_torch.engine.recovery_store",
        "bytewax_tpu_torch.engine.residency",
        "bytewax_tpu_torch.engine.dlq",
        "bytewax_tpu_torch.engine.webserver",
    }
    assert contracts.WORKER_SAFE == {
        "note_phase",
        "note_source_lag",
        "note_pipeline_stall",
        "note_flush_depth",
        "record",
        "count",
    }
    assert contracts.PIPELINE_SUBMIT_METHODS == {"push", "submit"}
    assert contracts.PIPELINE_CLASS == "bytewax_tpu_torch.engine.pipeline.DevicePipeline"
    diags = _check(["BTX-THREAD"])
    assert not diags, format_diagnostics(diags)


def test_scan_emit_waiver_is_the_only_thread_waiver():
    """The one BTX-THREAD waiver of the tree sits on ``ScanKind.emit``'s
    call in the plain scan body, and without it the dispatch lane's
    fold task reaches that call."""
    from bytewax_tpu_torch.analysis.rules import thread

    project = _project()
    sites = [
        (mod.rel, line)
        for mod in project.modules.values()
        for line, ids in Waivers.parse(mod.source).by_line.items()
        if "BTX-THREAD" in ids
    ]
    assert len(sites) == 1, sites
    rel, line = sites[0]
    assert rel == "bytewax_tpu_torch/ops/scan.py"
    source = project.modules["bytewax_tpu_torch.ops.scan"].source.splitlines()
    assert source[line].strip() == "outs = kind.emit(pre, post, values)"
    unwaived = thread._site_waived
    try:
        thread._site_waived = lambda *a: False
        diags = run_rules(project, ["BTX-THREAD"])
    finally:
        thread._site_waived = unwaived
    assert len(diags) == 1, diags
    assert f"surface emit (bytewax_tpu_torch/ops/scan.py:{line + 1})" in diags[0].message


def test_lane_catalog_is_pinned():
    assert contracts.LANES == {
        "dispatch": {
            "constructor": (DRIVER, "_StatefulBatchRt.__init__"),
            "phase": "device",
            "depth": None,
            "fence": (DRIVER, "_StatefulBatchRt.pipeline_flush"),
            "shutdown": (DRIVER, "_StatefulBatchRt._pipe_shutdown"),
        },
        "collective": {
            "constructor": (SHARDED, "GlobalAggState.__init__"),
            "phase": "collective_lane",
            "depth": None,
            "fence": (SHARDED, "GlobalAggState.fence"),
            "shutdown": (SHARDED, "GlobalAggState.lane_shutdown"),
        },
        "checkpoint": {
            "constructor": (DRIVER, "_Driver.__init__"),
            "phase": "snapshot_lane",
            "depth": 2,
            "fence": (DRIVER, "_Driver._ckpt_fence"),
            "shutdown": (DRIVER, "_Driver._ckpt_shutdown"),
        },
    }
    assert contracts.LANE_TEARDOWN_ROOTS == {
        (DRIVER, "_Driver.run"),
        (DRIVER, "_Driver._close_epoch_inner"),
        (DRIVER, "_StatefulBatchRt._demote"),
        (DRIVER, "_InferRt._demote"),
    }
    import pathlib

    obs = (pathlib.Path(__file__).resolve().parent.parent / "docs" / "observability.md").read_text()
    for name, info in contracts.LANES.items():
        assert f"`{info['phase']}`" in obs, name
    diags = _check(["BTX-LANE"])
    assert not diags, format_diagnostics(diags)


def test_shared_state_inventory_is_pinned():
    assert set(contracts.SHARED_STATE) == {
        "bytewax_tpu_torch.engine.arrays:KeyEncoder._ids",
        "bytewax_tpu_torch.engine.arrays:KeyEncoder._sorted",
        f"{DRIVER}:_OpRt._m_timers",
        "bytewax_tpu_torch.engine.flight:FlightRecorder._ring",
        "bytewax_tpu_torch.engine.flight:FlightRecorder.counters",
    }
    for key, why in contracts.SHARED_STATE.items():
        assert why.strip(), key
    assert contracts.SEALED_CAPTURE_SAFE == {}
    assert contracts.RACE_WORKER_CARVEOUTS == {
        "bytewax_tpu_torch.engine.window_accel:DeviceWindowAggState._ingest.<locals>.device_phase",
        f"{DRIVER}:_StatefulBatchRt._scan_batch.<locals>.batch_phase",
        f"{DRIVER}:_InferRt._infer_batch.<locals>.batch_phase",
    }
    project = _project()
    for fid in contracts.RACE_WORKER_CARVEOUTS:
        assert fid in project.functions, fid
    diags = _check(["BTX-RACE"])
    assert not diags, format_diagnostics(diags)


def test_knob_catalog_is_pinned():
    """The port's 56 knobs: the JAX package's 59 less the four it does
    not read, plus ``BYTEWAX_TPU_VIRTUAL_DEVICES``, anchored to the
    README's port section."""
    assert sorted(contracts.KNOBS) == [
        "BYTEWAX_TPU_ACCEL",
        "BYTEWAX_TPU_ALLOW_REMOTE_STOP",
        "BYTEWAX_TPU_AUTOSCALE_COOLDOWN_S",
        "BYTEWAX_TPU_AUTOSCALE_HYSTERESIS",
        "BYTEWAX_TPU_AUTOSCALE_LIVE",
        "BYTEWAX_TPU_AUTOSCALE_POLL_S",
        "BYTEWAX_TPU_AUTOSCALE_STOP_TIMEOUT_S",
        "BYTEWAX_TPU_CKPT_ASYNC",
        "BYTEWAX_TPU_CKPT_COMPACT_EVERY",
        "BYTEWAX_TPU_CKPT_DELTA",
        "BYTEWAX_TPU_COORDINATOR",
        "BYTEWAX_TPU_DEMOTE_AFTER",
        "BYTEWAX_TPU_DIAL_TIMEOUT_S",
        "BYTEWAX_TPU_DISTRIBUTED",
        "BYTEWAX_TPU_DLQ_DIR",
        "BYTEWAX_TPU_EPOCH_STALL_S",
        "BYTEWAX_TPU_FAULTS",
        "BYTEWAX_TPU_FAULTS_KINDS",
        "BYTEWAX_TPU_FAULTS_MIN_GAP_S",
        "BYTEWAX_TPU_FAULTS_RATE",
        "BYTEWAX_TPU_FAULTS_SEED",
        "BYTEWAX_TPU_FAULTS_SITES",
        "BYTEWAX_TPU_FAULT_DELAY_S",
        "BYTEWAX_TPU_GC",
        "BYTEWAX_TPU_GLOBAL_EXCHANGE",
        "BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG",
        "BYTEWAX_TPU_GSYNC_BASELINE_EVERY",
        "BYTEWAX_TPU_GSYNC_DEPTH",
        "BYTEWAX_TPU_GSYNC_OVERLAP",
        "BYTEWAX_TPU_GSYNC_QUANT",
        "BYTEWAX_TPU_HB_S",
        "BYTEWAX_TPU_HEARTBEAT_S",
        "BYTEWAX_TPU_HOST_STATE_BUDGET",
        "BYTEWAX_TPU_INFER_DEVICE",
        "BYTEWAX_TPU_INGEST_TARGET_ROWS",
        "BYTEWAX_TPU_IO_BACKOFF_CAP_S",
        "BYTEWAX_TPU_IO_BACKOFF_S",
        "BYTEWAX_TPU_IO_RETRIES",
        "BYTEWAX_TPU_MAX_RESTARTS",
        "BYTEWAX_TPU_PIPELINE_DEPTH",
        "BYTEWAX_TPU_PLATFORM",
        "BYTEWAX_TPU_POSTMORTEM_DIR",
        "BYTEWAX_TPU_QUARANTINE",
        "BYTEWAX_TPU_QUARANTINE_REPROBE_S",
        "BYTEWAX_TPU_RESCALE",
        "BYTEWAX_TPU_RESTART_BACKOFF_S",
        "BYTEWAX_TPU_RESTART_RESET_S",
        "BYTEWAX_TPU_REUSEPORT",
        "BYTEWAX_TPU_RX_BUFFER_CAP",
        "BYTEWAX_TPU_SHARD",
        "BYTEWAX_TPU_SPILL_DIR",
        "BYTEWAX_TPU_STATE_BUDGET",
        "BYTEWAX_TPU_TEXT_DEVICE",
        "BYTEWAX_TPU_TRACE_DIR",
        "BYTEWAX_TPU_VIRTUAL_DEVICES",
        "BYTEWAX_TPU_WIRE",
    ]
    assert len(contracts.KNOBS) == 56
    for name, (default, doc) in contracts.KNOBS.items():
        assert isinstance(default, str), name
        if name == "BYTEWAX_TPU_VIRTUAL_DEVICES":
            assert doc == "README.md"
        else:
            assert doc.startswith("docs/") and doc.endswith(".md"), name
    diags = _check(["BTX-KNOB"])
    assert not diags, format_diagnostics(diags)


def test_knob_rule_sees_the_virtual_devices_read(monkeypatch):
    """``parallel/mesh.py`` reads ``BYTEWAX_TPU_VIRTUAL_DEVICES`` through
    the constant ``utils.VIRTUAL_DEVICES_ENV``: taken out of the catalog,
    the knob is a finding at that read."""
    knobs = dict(contracts.KNOBS)
    del knobs["BYTEWAX_TPU_VIRTUAL_DEVICES"]
    monkeypatch.setattr(contracts, "KNOBS", knobs)
    diags = _check(["BTX-KNOB"])
    mesh = _project().modules["bytewax_tpu_torch.parallel.mesh"]
    line = 1 + next(
        i for i, ln in enumerate(mesh.source.splitlines()) if "os.environ.get(VIRTUAL_DEVICES_ENV" in ln
    )
    assert [(d.path, d.lineno) for d in diags] == [("bytewax_tpu_torch/parallel/mesh.py", line)], diags
    assert "uncataloged knob BYTEWAX_TPU_VIRTUAL_DEVICES read in local_devices" in diags[0].message


def test_supervisor_is_process_local():
    assert "bytewax_tpu_torch.supervise" in _project().modules
    _assert_process_local({"bytewax_tpu_torch.supervise"}, at_least=10)


def test_wire_codec_is_pure_and_allowlisted():
    project = _project()
    assert contracts.WIRE_MODULE in project.modules
    checked = 0
    for qual, fn in project.functions.items():
        if qual.split(":", 1)[0] != contracts.WIRE_MODULE:
            continue
        checked += 1
        comm_calls = [c.name for c in fn.calls if c.name in _forbidden_calls()]
        assert not comm_calls, f"{qual} calls {comm_calls}"
        assert not [c.name for c in fn.calls if c.dotted == contracts.COMM_CLASS], qual
    assert checked >= 10
    flush = project.functions[f"{DRIVER}:_Driver.ship_flush"]
    assert any(c.name in contracts.RAW_SEND_METHODS for c in flush.calls)


def test_ingest_batching_is_process_local():
    assert "bytewax_tpu_torch.engine.batching" in _project().modules
    _assert_process_local(
        {"bytewax_tpu_torch.engine.batching"},
        prefixes=("bytewax_tpu_torch.connectors",),
        at_least=11,
    )


@pytest.mark.parametrize("entry", ["import", "cli"])
def test_analyzer_loads_nothing_heavy(entry):
    """Importing the analyzer, or running it over the tree, loads none of
    torch, numpy, jax or the JAX package."""
    run = (
        "from bytewax_tpu_torch.analysis.__main__ import main\nassert main([]) == 0\n"
        if entry == "cli"
        else ""
    )
    code = (
        "import json, sys\nimport bytewax_tpu_torch.analysis\n" + run +
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "bytewax_tpu_torch" in loaded
    assert not loaded & {"torch", "numpy", "jax", "jaxlib", "bytewax_tpu"}, loaded
