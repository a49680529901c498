"""BTX-DRAIN — drain-only operations happen only at drain points.

The async dispatch pipeline (docs/performance.md) moved every host
readback to explicit drain points: window close/notify, epoch close,
snapshot, the EOF ladder, demotion, and the gsync-bearing startup
paths.  Tiered residency (docs/state-residency.md) rides the same
discipline — evictions and restores run ONLY where the pipeline has
been quiesced, or a deferred fold on the worker could reference a
reclaimed slot.  These are single-schedule concurrency contracts a
2-core CI box will essentially never falsify dynamically, so they are
proved over the call graph instead:

1. **Drain-only reachability** — from every per-batch root (the same
   root set as BTX-GSYNC), never descending into the pinned drain
   points (``contracts.DRAIN_POINTS`` + the close/EOF hook names),
   no path may reach a drain-only operation: residency
   ``evict_to_budget``/``prepare``/``prepare_entries``/
   ``extract_keys``/``inject_keys``, ``demotion_snapshots``,
   residency-managed ``snapshots_for``, the driver's
   ``pipeline_flush``/``pipeline_shutdown`` wrappers, raw
   ``flush``/``shutdown``/``drop_pending`` on a pipeline-denoting
   receiver, or epoch-close entry.  Findings are reported at the
   drain-op call site with a witness chain (like BTX-GSYNC), so a
   deliberate exception is waived exactly where it happens.

2. **Flush-before-sync** — every function that calls a gsync
   primitive directly must, lexically before the sync, make a call
   that transitively flushes the pipelines (``pipeline_flush`` /
   ``_drain_pipelines`` / a pipeline-receiver ``flush``), unless it
   is pinned in ``contracts.GSYNC_PREFLUSHED`` with its reason.  A
   gsync round entered with a pipeline still holding work would
   stall the whole cluster behind one process's device phase — and a
   worker-raised fault inside the round would tear the ordered
   sequence apart.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import (
    MODULE_QUAL,
    FunctionInfo,
    Project,
)
from bytewax_tpu_torch.analysis.rules._util import (
    is_pipeline_expr,
    local_aliases,
    pipeline_aliases,
)

RULE_ID = "BTX-DRAIN"


def _is_drain_point(fn: FunctionInfo) -> bool:
    if (fn.module, fn.qualname) in contracts.DRAIN_POINTS:
        return True
    return fn.name in contracts.DRAIN_POINT_METHOD_NAMES


def _drain_seed_calls(
    project: Project, fn: FunctionInfo
) -> List[Tuple[int, str]]:
    """(lineno, what) for every drain-only operation ``fn`` calls."""
    mod = project.modules[fn.module]
    aliases: Optional[Set[str]] = None
    seeds: List[Tuple[int, str]] = []
    for call in fn.calls:
        if call.name in contracts.DRAIN_ONLY_METHODS:
            seeds.append((call.lineno, call.name))
            continue
        if call.name in contracts.DRAIN_RESIDENCY_SCOPED:
            # Counts only when the call may land in the residency
            # manager (resolved into engine/residency.py, or not
            # resolved at all — fail loud on a possible edge).
            if not call.targets or any(
                t.split(":", 1)[0] == contracts.RESIDENCY_MODULE
                for t in call.targets
            ):
                seeds.append((call.lineno, call.name))
            continue
        if call.name in contracts.PIPELINE_DRAIN_METHODS and isinstance(
            call.node.func, ast.Attribute
        ):
            if aliases is None:
                aliases = pipeline_aliases(project, mod, fn)
            if is_pipeline_expr(
                project, mod, fn, call.node.func.value, aliases
            ):
                seeds.append(
                    (call.lineno, f"DevicePipeline.{call.name}")
                )
    return seeds


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    out.extend(_check_reachability(project))
    out.extend(_check_flush_before_sync(project))
    return out


# -- component 1: drain-only reachability ------------------------------------


def _check_reachability(project: Project) -> List[Diagnostic]:
    adj = project.adjacency()
    roots = [
        fn
        for fn in project.iter_functions()
        if fn.qualname != MODULE_QUAL
        and fn.name in contracts.PER_BATCH_METHOD_NAMES
        and not _is_drain_point(fn)
        and fn.name not in contracts.DRAIN_ONLY_METHODS
    ]
    # Multi-source BFS with parent pointers: one witness chain per
    # reachable function, one diagnostic per drain-op call site.
    parent: Dict[str, Optional[str]] = {}
    queue: List[str] = []
    for root in roots:
        if root.id not in parent:
            parent[root.id] = None
            queue.append(root.id)
    reachable: List[str] = []
    while queue:
        fid = queue.pop(0)
        fn = project.functions[fid]
        if parent[fid] is not None and (
            _is_drain_point(fn)
            or fn.name in contracts.DRAIN_ONLY_METHODS
            or fn.module == contracts.RESIDENCY_MODULE
        ):
            # Sanctioned: do not look inside drain machinery (the
            # whole residency manager included — calls INTO it are
            # the seeds).
            continue
        reachable.append(fid)
        for target in sorted(adj.get(fid, ())):
            if target not in parent:
                parent[target] = fid
                queue.append(target)

    out: List[Diagnostic] = []
    for fid in reachable:
        fn = project.functions[fid]
        seeds = _drain_seed_calls(project, fn)
        if not seeds:
            continue
        chain: List[FunctionInfo] = []
        cur: Optional[str] = fid
        while cur is not None:
            chain.append(project.functions[cur])
            cur = parent[cur]
        chain.reverse()
        via = " -> ".join(f.qualname for f in chain)
        mod = project.modules[fn.module]
        for lineno, what in seeds:
            out.append(
                Diagnostic(
                    RULE_ID,
                    mod.rel,
                    lineno,
                    f"drain-only operation {what} reachable from "
                    f"per-batch path {chain[0].qualname} via {via}; "
                    "readbacks, evictions/restores, demotion "
                    "snapshots and pipeline teardown are legal only "
                    "at the pinned drain points (window close/"
                    "notify, epoch close, snapshot, EOF ladder, "
                    "demotion, gsync-bearing startup)",
                )
            )
    return out


# -- component 2: flush-before-sync ------------------------------------------


def _reaches_flush(
    project: Project,
    call,
    aliases_fn: FunctionInfo,
    depth: int,
) -> bool:
    """Does this call (or anything it transitively invokes within
    ``depth`` edges) flush the pipelines?"""
    if call.name in contracts.PIPELINE_FLUSH_NAMES:
        return True
    mod = project.modules[aliases_fn.module]
    if call.name in contracts.PIPELINE_DRAIN_METHODS and isinstance(
        call.node.func, ast.Attribute
    ):
        if is_pipeline_expr(
            project,
            mod,
            aliases_fn,
            call.node.func.value,
            pipeline_aliases(project, mod, aliases_fn),
        ):
            return True
    adj = project.adjacency()
    seen: Set[str] = set()
    frontier = list(call.targets)
    for _ in range(depth):
        nxt: List[str] = []
        for fid in frontier:
            if fid in seen:
                continue
            seen.add(fid)
            fn = project.functions.get(fid)
            if fn is None:
                continue
            for sub in fn.calls:
                if sub.name in contracts.PIPELINE_FLUSH_NAMES:
                    return True
            nxt.extend(adj.get(fid, ()))
        frontier = nxt
        if not frontier:
            break
    return False


def _gsync_positions(fn: FunctionInfo) -> List[Tuple[int, int]]:
    """Positions of direct gsync-primitive calls in ``fn`` — through
    any bound-method alias (``gs = self.global_sync; gs(...)``), the
    same alias machinery BTX-GSYNC's seed scan uses."""
    aliases = None
    out: List[Tuple[int, int]] = []
    for call in fn.calls:
        if call.name in contracts.GSYNC_PRIMITIVES:
            out.append((call.lineno, call.col))
            continue
        if isinstance(call.node.func, ast.Name) and fn.assigns:
            if aliases is None:
                aliases = local_aliases(
                    fn,
                    lambda expr: isinstance(expr, ast.Attribute)
                    and expr.attr in contracts.GSYNC_PRIMITIVES,
                )
            if call.name in aliases:
                out.append((call.lineno, call.col))
    return out


def _check_flush_before_sync(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for fn in project.iter_functions():
        # The primitives' own definitions are not gsync *callers*.
        if fn.name in contracts.GSYNC_PRIMITIVES:
            continue
        positions = _gsync_positions(fn)
        if not positions:
            continue
        if (fn.module, fn.qualname) in contracts.GSYNC_PREFLUSHED:
            continue
        first_sync = min(positions)
        flushed = any(
            (call.lineno, call.col) < first_sync
            and _reaches_flush(
                project, call, fn, contracts.DRAIN_REACH_DEPTH
            )
            for call in fn.calls
        )
        if not flushed:
            mod = project.modules[fn.module]
            out.append(
                Diagnostic(
                    RULE_ID,
                    mod.rel,
                    first_sync[0],
                    f"{fn.qualname} enters a gsync round without "
                    "first flushing the dispatch pipelines; every "
                    "gsync-bearing path must drain in-flight device "
                    "phases before syncing (add a pipeline_flush/"
                    "_drain_pipelines call before the round, or pin "
                    "the function in contracts.GSYNC_PREFLUSHED with "
                    "its reason)",
                )
            )
    return out
