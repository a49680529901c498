"""BTX-LANE — every off-main-thread lane is cataloged, fenced at
teardown, truthfully phased, and sealed.

The engine's ordered lanes are all :class:`DevicePipeline` instances:
the per-step dispatch pipeline, the collective exchange lane, and the
checkpoint committer lane.  Each one is an explicit concurrency
surface, and the contracts that keep it safe — *who fences it, when,
and what its worker may capture* — were prose until now.  This rule
proves them over the pinned ``contracts.LANES`` catalog:

a. **Catalog closure, both ways** — every ``DevicePipeline(...)``
   construction site in the package must be cataloged (a new lane
   cannot appear silently), and every cataloged lane must still
   construct (the catalog cannot rot).

b. **Fenced teardown** — each lane's ``fence`` and ``shutdown``
   functions must be call-graph-reachable from the pinned run-ending
   closes (``contracts.LANE_TEARDOWN_ROOTS``: the run loop's
   clean-exit/finally paths, the stop/reconfigure agreed close, and
   demotion).  The teardown paths dispatch through
   ``getattr(obj, "name", None)`` probes and class-body method
   aliases, so the walk adds getattr-literal edges (resolved through
   class-body aliases like ``pipeline_shutdown = _pipe_shutdown``)
   on top of the shared call graph.  Additionally — and on fixtures
   too — a module that constructs a lane must itself drain it:
   somewhere in that module both ``.flush()`` and
   ``.shutdown()``/``.drop_pending()`` must be called on a
   pipeline-denoting receiver (tuple-unpack swaps like
   ``lane, self._lane = self._lane, None`` are followed).

c. **Truthful phase** — the ``phase=`` literal at the construction
   site must match the catalog (and be a literal at all): the phase
   string decides which ledger bucket the lane's seconds land in,
   and ``derive_rescale_hint``'s fraction signals are only as honest
   as those buckets.

d. **Sealed-task purity** — a callable submitted to a lane runs off
   the main thread against state sealed at submit; it must not
   transitively READ attributes that per-batch main-thread code
   writes (the seconds between seal and fence are exactly when such
   a read tears).  Pure reads of main-written attributes must appear
   in ``contracts.SEALED_CAPTURE_SAFE`` with the seal that makes
   them safe, or in ``contracts.SHARED_STATE``.  (Worker *writes*
   are BTX-RACE's half — the two rules partition the conflict space
   and never double-report one attribute.)
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import FunctionInfo, Module, Project
from bytewax_tpu_torch.analysis.rules import race
from bytewax_tpu_torch.analysis.rules._util import (
    is_pipeline_expr,
    pipeline_aliases,
)

RULE_ID = "BTX-LANE"

#: Catalog staleness and teardown reachability only make sense on the
#: real tree (fixtures never contain the engine driver).
_TREE_SENTINEL = "bytewax_tpu_torch.engine.driver"


# -- construction sites --------------------------------------------------


def construction_sites(project: Project):
    """Yield ``(fn, call)`` for every ``DevicePipeline(...)``
    construction in the project."""
    for fn in project.iter_functions(include_nested=True):
        for call in fn.calls:
            if call.dotted == contracts.PIPELINE_CLASS:
                yield fn, call


def _phase_literal(call: ast.Call) -> Tuple[Optional[str], bool]:
    """``(phase, is_literal)`` from the construction call's ``phase=``
    keyword; absent means the ``"device"`` default."""
    for kw in call.keywords:
        if kw.arg == "phase":
            if isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, str
            ):
                return kw.value.value, True
            return None, False
    return "device", True


def _depth_literal(call: ast.Call) -> Optional[int]:
    """The ``depth=`` keyword when it is an integer literal; None for
    absent or knob-driven (a non-literal expression)."""
    for kw in call.keywords:
        if kw.arg == "depth":
            if isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, int
            ):
                return kw.value.value
            return None
    return None


# -- module-local drain presence (component b, fixture-able half) --------


def _tuple_unpack_aliases(
    project: Project, mod: Module, fn: FunctionInfo, names: Set[str]
) -> Set[str]:
    """Extend pipeline aliases with pairwise tuple-unpack targets:
    ``lane, self._lane = self._lane, None`` aliases ``lane``."""
    out = set(names)
    for targets, value in fn.assigns:
        for tgt in targets:
            if (
                isinstance(tgt, ast.Tuple)
                and isinstance(value, ast.Tuple)
                and len(tgt.elts) == len(value.elts)
            ):
                for t_el, v_el in zip(tgt.elts, value.elts):
                    if isinstance(t_el, ast.Name) and is_pipeline_expr(
                        project, mod, fn, v_el, out
                    ):
                        out.add(t_el.id)
    return out


def _module_drain_calls(
    project: Project, mod: Module
) -> Tuple[bool, bool]:
    """Does this module call ``.flush()`` / a teardown method on a
    pipeline-denoting receiver anywhere?"""
    has_flush = False
    has_shutdown = False
    for fn in mod.functions.values():
        aliases: Optional[Set[str]] = None
        for call in fn.calls:
            callee = call.node.func
            if not isinstance(callee, ast.Attribute):
                continue
            if callee.attr not in contracts.PIPELINE_DRAIN_METHODS:
                continue
            if aliases is None:
                aliases = _tuple_unpack_aliases(
                    project, mod, fn, pipeline_aliases(project, mod, fn)
                )
            if not is_pipeline_expr(
                project, mod, fn, callee.value, aliases
            ):
                continue
            if callee.attr == "flush":
                has_flush = True
            else:
                has_shutdown = True
            if has_flush and has_shutdown:
                return True, True
    return has_flush, has_shutdown


# -- teardown reachability (component b, tree half) ----------------------


def _class_body_aliases(project: Project) -> Dict[str, Set[str]]:
    """``alias name -> method function ids`` for class-body method
    aliases (``pipeline_shutdown = _pipe_shutdown``), project-wide."""
    cached = getattr(project, "_lane_class_aliases_cache", None)
    if cached is not None:
        return cached
    out: Dict[str, Set[str]] = {}
    for ci in project.classes.values():
        for stmt in ci.node.body:
            if not isinstance(stmt, ast.Assign):
                continue
            if not isinstance(stmt.value, ast.Name):
                continue
            target_fn = project.class_method(ci.id, stmt.value.id)
            if target_fn is None:
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, set()).add(target_fn.id)
    project._lane_class_aliases_cache = out
    return out


def _getattr_edges(project: Project, fn: FunctionInfo) -> Set[str]:
    """Dispatch edges through ``getattr(obj, "name", ...)`` literals:
    the teardown paths probe optional lane surfaces this way, so the
    plain call graph never sees the edge."""
    out: Set[str] = set()
    aliases = _class_body_aliases(project)
    for call in fn.calls:
        if call.name != "getattr":
            continue
        node = call.node
        if len(node.args) < 2:
            continue
        arg = node.args[1]
        if not (
            isinstance(arg, ast.Constant) and isinstance(arg.value, str)
        ):
            continue
        name = arg.value
        for target in project.functions_named(name):
            out.add(target.id)
        out.update(aliases.get(name, ()))
    return out


def _teardown_reachable(project: Project) -> Set[str]:
    """Function ids reachable from the pinned run-ending closes over
    the call graph plus getattr-literal edges."""
    adjacency = project.adjacency()
    seen: Set[str] = set()
    queue: List[str] = []
    for module, qualname in contracts.LANE_TEARDOWN_ROOTS:
        fid = f"{module}:{qualname}"
        if fid in project.functions and fid not in seen:
            seen.add(fid)
            queue.append(fid)
    while queue:
        fid = queue.pop(0)
        fn = project.functions[fid]
        targets = set(adjacency.get(fid, ()))
        targets.update(_getattr_edges(project, fn))
        for target in targets:
            if target not in seen and target in project.functions:
                seen.add(target)
                queue.append(target)
    return seen


# -- the rule ------------------------------------------------------------


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    on_tree = _TREE_SENTINEL in project.modules
    catalog_by_ctor = {
        info["constructor"]: (name, info)
        for name, info in contracts.LANES.items()
    }
    lane_phases = {info["phase"] for info in contracts.LANES.values()}

    sites_by_ctor: Dict[Tuple[str, str], int] = {}
    site_modules: Dict[str, Module] = {}
    for fn, call in construction_sites(project):
        mod = project.modules[fn.module]
        site_modules.setdefault(fn.module, mod)
        ctor = (fn.module, fn.qualname)
        sites_by_ctor[ctor] = sites_by_ctor.get(ctor, 0) + 1
        entry = catalog_by_ctor.get(ctor)
        phase, literal = _phase_literal(call.node)
        if entry is None:
            out.append(
                Diagnostic(
                    RULE_ID,
                    mod.rel,
                    call.lineno,
                    f"un-cataloged lane: {fn.qualname} constructs a "
                    "DevicePipeline but no contracts.LANES entry "
                    "names this constructor — every ordered "
                    "off-main-thread lane must be cataloged (phase, "
                    "depth bound, fence + shutdown) and pinned in "
                    "tests/test_torch_comm_invariants.py",
                )
            )
            if literal and phase not in lane_phases:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        call.lineno,
                        f"unknown ledger phase {phase!r} at a lane "
                        "construction site: the phase string decides "
                        "which ledger bucket the lane's seconds land "
                        "in (docs/observability.md) — use a "
                        "cataloged phase or extend contracts.LANES",
                    )
                )
        else:
            lane_name, info = entry
            if not literal:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        call.lineno,
                        f"lane {lane_name!r}: phase= at the "
                        "construction site is not a string literal — "
                        "a computed phase evades the catalog and the "
                        "ledger-bucket check",
                    )
                )
            elif phase != info["phase"]:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        call.lineno,
                        f"lane {lane_name!r} constructs with phase="
                        f"{phase!r} but contracts.LANES pins "
                        f"{info['phase']!r}; a mis-bucketed phase "
                        "silently skews derive_rescale_hint's "
                        "fraction signals",
                    )
                )
            if _depth_literal(call.node) != info["depth"]:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        call.lineno,
                        f"lane {lane_name!r}: depth at the "
                        "construction site does not match the "
                        f"cataloged max-in-flight bound "
                        f"{info['depth']!r} (None = knob-driven)",
                    )
                )

    # Module-local drain presence: a module that constructs a lane
    # must also drain it (fixture-able half of component b).
    for mod_name in sorted(site_modules):
        mod = site_modules[mod_name]
        has_flush, has_shutdown = _module_drain_calls(project, mod)
        if not (has_flush and has_shutdown):
            missing = []
            if not has_flush:
                missing.append(".flush()")
            if not has_shutdown:
                missing.append(".shutdown()/.drop_pending()")
            out.append(
                Diagnostic(
                    RULE_ID,
                    mod.rel,
                    1,
                    f"un-fenced lane: {mod.rel} constructs a "
                    f"DevicePipeline but never calls "
                    f"{' or '.join(missing)} on one — a lane nobody "
                    "drains loses its in-flight work at teardown",
                )
            )

    if on_tree:
        reachable = _teardown_reachable(project)
        for lane_name in sorted(contracts.LANES):
            info = contracts.LANES[lane_name]
            ctor = info["constructor"]
            if ctor not in sites_by_ctor:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        "bytewax_tpu_torch/analysis/contracts.py",
                        1,
                        f"stale LANES entry {lane_name!r}: "
                        f"{ctor[1]} ({ctor[0]}) no longer constructs "
                        "a DevicePipeline — remove or update the "
                        "catalog entry (and the pinning test)",
                    )
                )
            for role in ("fence", "shutdown"):
                module, qualname = info[role]
                fid = f"{module}:{qualname}"
                if fid not in project.functions:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            "bytewax_tpu_torch/analysis/contracts.py",
                            1,
                            f"stale LANES entry {lane_name!r}: "
                            f"{role} function {qualname} ({module}) "
                            "does not exist",
                        )
                    )
                elif fid not in reachable:
                    fn = project.functions[fid]
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            project.modules[fn.module].rel,
                            fn.node.lineno,
                            f"lane {lane_name!r}: {role} "
                            f"{qualname} is not reachable from any "
                            "pinned run-ending close "
                            "(contracts.LANE_TEARDOWN_ROOTS) — a "
                            "stop/reconfigure/demotion could retire "
                            "the runtime with this lane still "
                            "holding work",
                        )
                    )

    # Sealed-task purity (component d): pure worker READS of
    # main-written attributes, minus the pinned seals.
    fp = race.footprints(project)
    pure_reads = set(fp.worker_reads) - set(fp.worker_writes)
    for key in sorted(pure_reads & set(fp.main_writes)):
        if key in contracts.SEALED_CAPTURE_SAFE:
            continue
        if key in contracts.SHARED_STATE:
            continue
        rfid = fp.worker_reads[key]
        wfid = fp.main_writes[key]
        rel, lineno = race._site(project, rfid)
        rchain = race.chain(project, fp.worker_parent, rfid)
        wchain = race.chain(project, fp.main_parent, wfid)
        out.append(
            Diagnostic(
                RULE_ID,
                rel,
                lineno,
                f"sealed-task purity: a lane task reads {key} (via "
                f"{rchain}) while per-batch main-thread code writes "
                f"it (via {wchain}); seal the value into the task at "
                "submit, or pin the attribute in "
                "contracts.SEALED_CAPTURE_SAFE with the seal that "
                "makes the read safe",
            )
        )
    if on_tree:
        for key in sorted(contracts.SEALED_CAPTURE_SAFE):
            if key in fp.worker_reads and key in fp.main_writes:
                continue
            out.append(
                Diagnostic(
                    RULE_ID,
                    "bytewax_tpu_torch/analysis/contracts.py",
                    1,
                    f"stale SEALED_CAPTURE_SAFE entry {key}: no "
                    "longer a worker-lane read of a main-written "
                    "attribute — remove it (and update the pinning "
                    "test)",
                )
            )
    return out
