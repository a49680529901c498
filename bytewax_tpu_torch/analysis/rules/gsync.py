"""BTX-GSYNC — collectives only at globally-ordered points.

``global_sync``/``next_gsync_tag`` (the control-plane sync rounds)
and cross-process ``torch.distributed`` collectives are legal ONLY
where every process performs the same sequence of rounds: run
startup, epoch close, and the EOF ladder.  A collective reachable
from a per-batch / per-key path deadlocks the mesh — peers that did
not receive the same delivery never enter it (the DrJAX
mis-placed-collective class of bug).

Checks, on the resolved call graph:

1. **Reachability** — starting from every per-batch root (any
   function DEFINITION named in ``contracts.PER_BATCH_METHOD_NAMES``)
   walk callees, never descending into the globally-ordered entry
   points; reaching a collective seed is a finding, reported with a
   witness chain.  Seeds are calls (through any alias) to the gsync
   primitives, and direct ``torch.distributed`` collective calls
   (``contracts.TORCH_COLLECTIVES``, through a module-level or a
   function-level import alike, and by the same name from any
   submodule of ``torch.distributed``) or to this package's own entry points
   into them (``contracts.CLUSTER_COLLECTIVE_ENTRIES``:
   ``all_to_all_procs``, ``exchange_procs``, ``init_world``) outside
   the sanctioned local-mesh modules
   (``contracts.LOCAL_COLLECTIVE_MODULES`` — collectives over only
   this process's devices cannot deadlock cluster peers).

2. **Caller allowlist** — direct gsync-primitive calls appear only in
   ``contracts.GSYNC_CALLER_MODULES``; a new collective tier is added
   there deliberately, after re-checking the ordering contract.
"""

import ast
from typing import Dict, List, Optional, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import (
    MODULE_QUAL,
    FunctionInfo,
    Project,
)
from bytewax_tpu_torch.analysis.rules._util import local_aliases

RULE_ID = "BTX-GSYNC"


def _is_gsync_source(expr: ast.expr) -> bool:
    """``helper = self.driver.global_sync`` style alias sources."""
    return (
        isinstance(expr, ast.Attribute)
        and expr.attr in contracts.GSYNC_PRIMITIVES
    )


def _seed_calls(
    project: Project, fn: FunctionInfo
) -> List[Tuple[int, str]]:
    """(lineno, what) for every collective seed in this function.
    Iterates the resolver's pre-resolved call list; aliases are
    computed lazily from the pre-collected assignment list."""
    aliases = None
    seeds: List[Tuple[int, str]] = []
    for call in fn.calls:
        name = call.name
        if name in contracts.GSYNC_PRIMITIVES:
            seeds.append((call.lineno, name))
            continue
        if isinstance(call.node.func, ast.Name):
            if aliases is None:
                aliases = (
                    local_aliases(fn, _is_gsync_source)
                    if fn.assigns
                    else set()
                )
            if name in aliases:
                seeds.append(
                    (
                        call.lineno,
                        f"{name} (alias of a gsync primitive)",
                    )
                )
                continue
        if fn.module in contracts.LOCAL_COLLECTIVE_MODULES:
            continue
        dotted = call.dotted or ""
        if (
            _is_torch_collective(dotted)
            or dotted in contracts.CLUSTER_COLLECTIVE_ENTRIES
        ):
            seeds.append((call.lineno, dotted))
    return seeds


def _is_torch_collective(dotted: str) -> bool:
    """A cataloged collective, or a call by one of their names anywhere
    in ``torch.distributed``'s namespace: the same function imported
    from its defining submodule (``distributed_c10d``) resolves to a
    longer path."""
    if dotted in contracts.TORCH_COLLECTIVES:
        return True
    if not dotted.startswith("torch.distributed."):
        return False
    name = dotted.rsplit(".", 1)[1]
    return f"torch.distributed.{name}" in contracts.TORCH_COLLECTIVES


def _is_ordered(fn: FunctionInfo) -> bool:
    if (fn.module, fn.qualname) in contracts.ORDERED_ENTRY_POINTS:
        return True
    return fn.name in contracts.ORDERED_METHOD_NAMES


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []

    # Per-function seed table (and the caller-allowlist check).
    seeds: Dict[str, List[Tuple[int, str]]] = {}
    for fn in project.iter_functions():
        found = _seed_calls(project, fn)
        if found:
            seeds[fn.id] = found
        mod = project.modules[fn.module]
        for lineno, what in found:
            primitive = (
                what in contracts.GSYNC_PRIMITIVES
                or "gsync primitive" in what
            )
            if (
                primitive
                and fn.module not in contracts.GSYNC_CALLER_MODULES
            ):
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        lineno,
                        f"{what} called in {fn.qualname} outside the "
                        "sanctioned modules "
                        f"{sorted(contracts.GSYNC_CALLER_MODULES)}; a "
                        "new collective tier must be added to "
                        "contracts.GSYNC_CALLER_MODULES after "
                        "re-checking the ordering contract",
                    )
                )

    # Reachability from per-batch roots, never entering ordered
    # points.  BFS with parent pointers for a witness chain.
    roots = [
        fn
        for fn in project.iter_functions()
        if fn.qualname != MODULE_QUAL
        and fn.name in contracts.PER_BATCH_METHOD_NAMES
        and not _is_ordered(fn)
    ]
    for root in roots:
        witness = _reach_seed(project, root, seeds)
        if witness is None:
            continue
        chain, (lineno, what) = witness
        mod = project.modules[root.module]
        via = " -> ".join(f.qualname for f in chain)
        site = project.modules[chain[-1].module]
        out.append(
            Diagnostic(
                RULE_ID,
                mod.rel,
                root.node.lineno,
                f"per-batch path {root.qualname} reaches collective "
                f"{what} ({site.rel}:{lineno}) via {via}; collectives "
                "are legal only at globally-ordered points (run "
                "startup, epoch close / the EOF ladder)",
            )
        )
    return out


def _reach_seed(
    project: Project,
    root: FunctionInfo,
    seeds: Dict[str, List[Tuple[int, str]]],
) -> Optional[Tuple[List[FunctionInfo], Tuple[int, str]]]:
    """BFS from ``root``; returns (chain, seed) for the first seed
    found, or None."""
    parent: Dict[str, Optional[str]] = {root.id: None}
    queue = [root.id]
    while queue:
        fid = queue.pop(0)
        fn = project.functions[fid]
        if fid != root.id and _is_ordered(fn):
            continue  # sanctioned: do not look inside ordered points
        if fid in seeds:
            chain: List[FunctionInfo] = []
            cur: Optional[str] = fid
            while cur is not None:
                chain.append(project.functions[cur])
                cur = parent[cur]
            chain.reverse()
            return chain, seeds[fid][0]
        for call in fn.calls:
            for target in call.targets:
                if target not in parent:
                    parent[target] = fid
                    queue.append(target)
    return None
