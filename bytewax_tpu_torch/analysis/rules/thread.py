"""BTX-THREAD — the pipeline worker lane never touches main-only state.

The dispatch pipeline (docs/performance.md) runs each delivery's
device phase on a single worker thread; everything that must stay
ordered with the rest of the dataflow — cluster sends, sync rounds,
downstream emission, vocab/split caches, recovery-store writes,
residency tier movement — belongs to the main thread.  A worker task
that reaches one of those is a data race (or, for sends and sync
rounds, a cluster-protocol violation) that no single-schedule test
reliably catches.  This rule is a static thread-ownership race
detector:

1. **Worker-lane roots** — the resolver traces the callable argument
   of every ``DevicePipeline.push``/``submit`` call (a lambda, a
   nested ``def``, an alias of one, or a bound method) to the
   functions that will execute on the worker thread.

2. **Reachability** — from each root, walk the shared call graph; a
   call to anything named in ``contracts.MAIN_ONLY``, any function
   defined in a ``contracts.MAIN_ONLY_MODULES`` module, a raw comm
   send (through any receiver or bound-method alias), or a gsync
   primitive is a finding, reported at the submit site with a
   witness chain.  ``contracts.WORKER_SAFE`` waives the
   deliberately-shared flight-ring/ledger append paths.

3. **Site waivers** — an inline ``# bytewax: allow[BTX-THREAD]`` on
   the line of the touch itself (or the line above it) clears that
   one touch for every lane: a call whose name matches a main-only
   surface but does something else (``ScanKind.emit`` computes a
   scan's output columns and sends nothing) is waived once, where it
   is written, with its reason.  The walk goes on past it, so a real
   touch further down the same chain is still reported.

Targets owned by a ``global_exchange = True`` class are excluded
from the walk: the collective tier never enters the per-delivery
dispatch pipeline (its flush is a cluster-ordered collective; the
driver's dispatch path returns before ``push`` when the aggregation
is global), so the name-fallback edge into it is a known
over-approximation.  The tier's OWN overlapped exchange lane
(docs/performance.md "Overlapped collectives") submits sealed tasks
(``GlobalAggState.flush.<locals>.exchange_task``/``merge_task``) —
those roots ARE traced (their direct calls must stay clean), while
their edges back into the owning class fall under the same
exclusion: the lane is fenced at the ordered points, and everything
it touches (``_fields``/``_host_fields``/``_dev_fields``) is
lane-owned between seal and fence by construction.

The asynchronous-checkpoint committer lane gets a root-scoped
carve-out (``contracts.SNAPSHOT_LANE_ROOTS``; docs/recovery.md
"Asynchronous incremental checkpoints"): ONLY the pinned committer
task may reach the recovery store, ONLY through the method names in
``contracts.SNAPSHOT_LANE_SAFE`` and ONLY into
``contracts.SNAPSHOT_LANE_MODULE`` — the main thread seals and
freezes the delta before handoff and the next close fences the
previous commit, so the store handle never sees two threads.  Every
other MAIN_ONLY name/module still applies to that root, and every
other root still sees the store as main-only.
"""

import ast
from typing import Dict, List, Optional, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic, Waivers
from bytewax_tpu_torch.analysis.resolver import FunctionInfo, Project
from bytewax_tpu_torch.analysis.rules._util import (
    is_comm_expr,
    local_aliases,
    pipeline_submit_sites,
)

RULE_ID = "BTX-THREAD"


def worker_lane_roots(
    project: Project,
) -> Dict[str, List[Tuple[str, int]]]:
    """Worker-lane root function ids -> the ``(file, line)`` submit
    sites that hand them to the worker thread.  Shared with the
    pinning test in ``tests/test_torch_comm_invariants.py``."""
    roots: Dict[str, List[Tuple[str, int]]] = {}
    for fn in project.iter_functions(include_nested=True):
        mod = project.modules[fn.module]
        for call, targets in pipeline_submit_sites(project, mod, fn):
            for target in sorted(targets):
                roots.setdefault(target, []).append(
                    (mod.rel, call.lineno)
                )
    return roots


def _global_exchange_owned(project: Project, fid: str) -> bool:
    """Is this function a method of a ``global_exchange = True``
    class (the never-pipelining collective tier)?"""
    fn = project.functions.get(fid)
    if fn is None or fn.cls is None or fn.nested:
        return False
    return (
        project.class_attr(f"{fn.module}:{fn.cls}", "global_exchange")
        is True
    )


def _main_only_hits(
    project: Project,
    fn: FunctionInfo,
    snapshot_lane: bool = False,
) -> List[Tuple[int, str]]:
    """(lineno, what) for every main-thread-only touch in ``fn``.

    ``snapshot_lane=True`` applies the committer-lane carve-out:
    calls named in ``contracts.SNAPSHOT_LANE_SAFE`` and calls
    resolving into ``contracts.SNAPSHOT_LANE_MODULE`` are exempt for
    that root only (see the module docstring)."""
    mod = project.modules[fn.module]
    hits: List[Tuple[int, str]] = []
    # Bound-method aliases of a raw send: s = self.comm.send; s(...).
    send_aliases = local_aliases(
        fn,
        lambda expr: isinstance(expr, ast.Attribute)
        and expr.attr in contracts.RAW_SEND_METHODS
        and is_comm_expr(project, mod, fn, expr.value),
    )
    for call in fn.calls:
        if call.name in send_aliases:
            hits.append(
                (
                    call.lineno,
                    f"{call.name} (alias of a raw cluster send)",
                )
            )
            continue
        if (
            call.fallback
            and call.name in contracts.FALLBACK_BENIGN_METHODS
        ):
            # dict.get / list.append mis-bound to a project method by
            # the name fallback — not a worker-lane touch.
            continue
        if (
            call.name in contracts.MAIN_ONLY
            and call.name not in contracts.WORKER_SAFE
            and not (
                snapshot_lane
                and call.name in contracts.SNAPSHOT_LANE_SAFE
            )
        ):
            # A send/broadcast name only counts on a comm-denoting
            # receiver (sockets aside, .send is too common a name);
            # every other MAIN_ONLY name counts as-is.
            if call.name in contracts.RAW_SEND_METHODS:
                callee = call.node.func
                if not (
                    isinstance(callee, ast.Attribute)
                    and is_comm_expr(
                        project, mod, fn, callee.value, send_aliases
                    )
                ):
                    continue
            hits.append((call.lineno, call.name))
            continue
        for target in call.targets:
            t_mod = target.split(":", 1)[0]
            if (
                t_mod in contracts.MAIN_ONLY_MODULES
                and not _global_exchange_owned(project, target)
                and not (
                    snapshot_lane
                    and t_mod == contracts.SNAPSHOT_LANE_MODULE
                )
            ):
                hits.append(
                    (
                        call.lineno,
                        f"{call.name} (defined in main-only module "
                        f"{t_mod})",
                    )
                )
                break
    return hits


def _lane_edges(fn: FunctionInfo):
    """Callees the worker lane actually follows: every resolved
    target except benign-name fallback bindings (see
    ``contracts.FALLBACK_BENIGN_METHODS``)."""
    for call in fn.calls:
        if (
            call.fallback
            and call.name in contracts.FALLBACK_BENIGN_METHODS
        ):
            continue
        yield from call.targets


def _site_waived(
    project: Project,
    fn: FunctionInfo,
    lineno: int,
    cache: Dict[str, Waivers],
) -> bool:
    """Is the touch at ``lineno`` of ``fn``'s module waived in place?"""
    mod = project.modules[fn.module]
    waivers = cache.get(mod.name)
    if waivers is None:
        waivers = cache[mod.name] = Waivers.parse(mod.source)
    return waivers.waives(lineno, RULE_ID)


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    waiver_cache: Dict[str, Waivers] = {}
    for root_id, sites in sorted(worker_lane_roots(project).items()):
        root = project.functions.get(root_id)
        if root is None:
            continue
        # The committer-lane carve-out is keyed on the ROOT, not the
        # visited function: a device-phase task that somehow reached
        # write_epoch would still be flagged.
        lane_exempt = root_id in contracts.SNAPSHOT_LANE_ROOTS
        # BFS over the worker lane, excluding the collective tier.
        parent: Dict[str, Optional[str]] = {root_id: None}
        queue = [root_id]
        while queue:
            fid = queue.pop(0)
            fn = project.functions[fid]
            hits = [
                hit
                for hit in _main_only_hits(
                    project, fn, snapshot_lane=lane_exempt
                )
                if not _site_waived(project, fn, hit[0], waiver_cache)
            ]
            if hits:
                chain: List[FunctionInfo] = []
                cur: Optional[str] = fid
                while cur is not None:
                    chain.append(project.functions[cur])
                    cur = parent[cur]
                chain.reverse()
                via = " -> ".join(f.qualname for f in chain)
                site_mod = project.modules[fn.module]
                lineno, what = hits[0]
                for rel, submit_line in sites:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            rel,
                            submit_line,
                            f"worker-lane task {root.qualname} "
                            f"reaches main-thread-only surface "
                            f"{what} ({site_mod.rel}:{lineno}) via "
                            f"{via}; the pipeline worker may only "
                            "run device phases — sends, sync "
                            "rounds, emission, recovery-store and "
                            "residency state belong to the main "
                            "thread",
                        )
                    )
                break  # one finding per root is enough
            for target in sorted(set(_lane_edges(fn))):
                if target in parent:
                    continue
                if _global_exchange_owned(project, target):
                    continue  # the collective tier never pipelines
                parent[target] = fid
                queue.append(target)
    return out
