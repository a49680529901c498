"""BTX-RACE — worker/main shared-state discipline, attribute by
attribute.

The engine now runs three ordered off-main-thread lanes (the dispatch
pipeline, the collective exchange lane, the checkpoint committer
lane).  BTX-THREAD proves the worker lane never *calls* main-only
surfaces; this rule proves the finer-grained invariant underneath it:
the worker lane and the per-batch main-thread code must not touch the
same *state* — ``self.X`` instance attributes and mutated module
globals — unless the sharing is pinned, with its synchronization
justification, in ``contracts.SHARED_STATE``.

Mechanics (all from the resolver's one scan pass — no AST re-walk):

1. **Effect sets** — each function carries scope-pruned
   ``self.X`` read/write sets plus its ``global`` declarations and
   bare-name loads (:class:`resolver.FunctionInfo`).  Effects are
   keyed ``module:Class.attr`` (``module:<globals>.name`` for module
   globals); attribute names that are methods of the owning class's
   MRO are dropped (a bound-method read is a call edge, not state).
   ``__init__`` effects are construction-time — the object is not
   yet visible to any other thread — and are dropped too.

2. **Worker footprint** — BFS over *resolved* call edges from the
   pipeline-submit roots (``rules/thread.worker_lane_roots``) plus
   the pinned sealed device phases in
   ``contracts.RACE_WORKER_CARVEOUTS`` (closures handed back through
   return values the resolver cannot trace).  Name-fallback edges
   are dropped wholesale here: a ``param.update_batch(...)`` edge
   that fans out to every same-named method in the package would put
   the whole engine in the worker footprint (BTX-THREAD keeps those
   edges — over-approximation is the right bias for main-only
   *policing*, and wrong for a shared-state *inventory*).

3. **Main footprint** — BFS from the per-batch hot-path roots
   (``contracts.PER_BATCH_METHOD_NAMES``), the same roots the gsync
   and drain reachability rules use.  The walk does not enter the
   pinned drain points or drain-only machinery (a drain flushes the
   lanes first — its accesses cannot race), nor the worker roots
   themselves (the depth-1 inline mode runs them on the main thread,
   but then no worker thread exists at all).

4. Functions owned by a device-tier state class (anything a
   ``make_*state`` factory returns, or a ``global_exchange = True``
   tier) are excluded from the MAIN walk only: those objects are
   lane-owned between drain points by construction — BTX-DRAIN
   proves the drains, BTX-THREAD polices reachability — so the main
   thread's sanctioned accesses to them all happen behind a flush.
   The worker walk DOES descend into them (executing them is the
   worker's whole job), which is how the genuinely-shared runtime
   shell underneath — flight ring, fault plans, wire caches — gets
   both-sides attribution.

A conflict is an attribute the worker lane WRITES that the main
footprint reads or writes; the finding carries *dual* witness
chains — the worker path and the main path to the attribute.  (The
complementary direction — a sealed task merely *reading* what the
main thread writes — is BTX-LANE's sealed-task purity component, so
the two rules never double-report one attribute.)  Stale
``SHARED_STATE`` entries (no longer shared on the real tree) are
findings too, so the inventory cannot rot.
"""

from typing import Dict, List, Optional, Set, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import FunctionInfo, Project
from bytewax_tpu_torch.analysis.rules import thread

RULE_ID = "BTX-RACE"

#: Full-tree-only components (SHARED_STATE staleness) key on the
#: engine driver's presence, like the knob catalog's staleness half.
_TREE_SENTINEL = "bytewax_tpu_torch.engine.driver"

#: Class token for module-global effects.
_GLOBALS_CLS = "<globals>"

_DRAIN_NAMES = (
    contracts.DRAIN_ONLY_METHODS | contracts.DRAIN_POINT_METHOD_NAMES
)


# -- lane-owned device-tier state classes --------------------------------


def _lane_owned_class_ids(project: Project) -> Set[str]:
    """Class ids (plus their MROs) of every device-tier state class:
    anything returned by a ``make_*state`` factory — the objects the
    dispatch/collective lanes own between drain points."""
    cached = getattr(project, "_race_lane_owned_cache", None)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for fn in project.iter_functions():
        if fn.name not in contracts.DEVICE_STATE_FACTORY_NAMES:
            continue
        for cid in project.returned_classes(fn.id):
            for ci in project.mro(cid):
                out.add(ci.id)
    project._race_lane_owned_cache = out
    return out


def lane_owned(project: Project, fid: str) -> bool:
    """Is this function a method of a lane-owned device-tier state
    class (or of the ``global_exchange = True`` collective tier)?"""
    fn = project.functions.get(fid)
    if fn is None or fn.cls is None:
        return False
    cid = f"{fn.module}:{fn.cls}"
    if cid in _lane_owned_class_ids(project):
        return True
    return (
        project.class_attr(cid, contracts.GLOBAL_EXCHANGE_ATTR) is True
    )


# -- per-function effect sets --------------------------------------------


def _mutated_globals(project: Project) -> Dict[str, Set[str]]:
    """module name -> names some function in it declares ``global``
    (the only way function code writes a module global)."""
    cached = getattr(project, "_race_mutated_globals_cache", None)
    if cached is not None:
        return cached
    out: Dict[str, Set[str]] = {}
    for fn in project.iter_functions(include_nested=True):
        if fn.global_decls:
            out.setdefault(fn.module, set()).update(fn.global_decls)
    project._race_mutated_globals_cache = out
    return out


def _class_method_names(project: Project, cid: str) -> Set[str]:
    cached = getattr(project, "_race_method_names_cache", None)
    if cached is None:
        cached = {}
        project._race_method_names_cache = cached
    names = cached.get(cid)
    if names is None:
        names = set()
        for ci in project.mro(cid):
            names.update(ci.methods)
        cached[cid] = names
    return names


def function_effects(
    project: Project, fid: str
) -> Tuple[Set[str], Set[str]]:
    """``(reads, writes)`` effect keys for one function:
    ``module:Class.attr`` for ``self`` attributes (method names
    filtered; ``__init__`` is construction-time and contributes
    nothing), ``module:<globals>.name`` for module globals."""
    fn = project.functions[fid]
    reads: Set[str] = set()
    writes: Set[str] = set()
    if fn.name != "__init__":
        if fn.cls is not None and (fn.self_reads or fn.self_writes):
            methods = _class_method_names(
                project, f"{fn.module}:{fn.cls}"
            )
            for attr in fn.self_reads - methods:
                reads.add(f"{fn.module}:{fn.cls}.{attr}")
            for attr in fn.self_writes - methods:
                writes.add(f"{fn.module}:{fn.cls}.{attr}")
        mutated = _mutated_globals(project).get(fn.module, ())
        if mutated:
            for name in fn.name_loads:
                if name in mutated:
                    reads.add(
                        f"{fn.module}:{_GLOBALS_CLS}.{name}"
                    )
        for name in fn.global_decls:
            writes.add(f"{fn.module}:{_GLOBALS_CLS}.{name}")
    return reads, writes


# -- footprints ----------------------------------------------------------


class Footprints:
    """Worker- and main-side effect maps (effect key -> one
    representative function id) plus the BFS parent forests the
    witness chains are rebuilt from.  Built once per project and
    shared with BTX-LANE's sealed-task purity component."""

    __slots__ = (
        "worker_reads",
        "worker_writes",
        "worker_parent",
        "main_reads",
        "main_writes",
        "main_parent",
    )

    def __init__(self) -> None:
        self.worker_reads: Dict[str, str] = {}
        self.worker_writes: Dict[str, str] = {}
        self.worker_parent: Dict[str, Optional[str]] = {}
        self.main_reads: Dict[str, str] = {}
        self.main_writes: Dict[str, str] = {}
        self.main_parent: Dict[str, Optional[str]] = {}


def _resolved_edges(fn: FunctionInfo):
    """Call edges minus every name-fallback binding (see the module
    docstring: fallback fan-out is the wrong bias for an effect
    inventory) — EXCEPT the ``contracts.WORKER_SAFE`` names: the
    flight-ring append surface is the one place the worker lane is
    *supposed* to share state, and its module-global ``RECORDER``
    receiver is exactly what the type pass cannot see, so dropping
    those edges would hide the marquee SHARED_STATE entries."""
    for call in fn.calls:
        if call.fallback and call.name not in contracts.WORKER_SAFE:
            continue
        yield from call.targets


def _main_edges(fn: FunctionInfo):
    """Main-side call edges: fallback edges survive unless they bind
    a ubiquitous collection-method name (the thread rule's own
    filter) — the main footprint SHOULD over-approximate."""
    for call in fn.calls:
        if (
            call.fallback
            and call.name in contracts.FALLBACK_BENIGN_METHODS
        ):
            continue
        yield from call.targets


def _collect(
    project: Project,
    fid: str,
    parent: Dict[str, Optional[str]],
    reads: Dict[str, str],
    writes: Dict[str, str],
) -> None:
    r, w = function_effects(project, fid)
    for key in r:
        reads.setdefault(key, fid)
    for key in w:
        writes.setdefault(key, fid)


def footprints(project: Project) -> Footprints:
    cached = getattr(project, "_race_footprints_cache", None)
    if cached is not None:
        return cached
    fp = Footprints()
    worker_roots = set(thread.worker_lane_roots(project))
    worker_roots.update(
        fid
        for fid in contracts.RACE_WORKER_CARVEOUTS
        if fid in project.functions
    )

    # Worker side: resolved edges only, never into main-only modules
    # (BTX-THREAD's beat) or drain machinery.  Lane-owned state
    # classes ARE descended into — executing them is the worker's
    # whole job; it is the MAIN walk that must not see their
    # internals (between drain points only the lane touches them).
    queue: List[str] = []
    for root in sorted(worker_roots):
        if root in project.functions and root not in fp.worker_parent:
            fp.worker_parent[root] = None
            queue.append(root)
    while queue:
        fid = queue.pop(0)
        fn = project.functions[fid]
        _collect(project, fid, fp.worker_parent, fp.worker_reads,
                 fp.worker_writes)
        for target in sorted(set(_resolved_edges(fn))):
            if target in fp.worker_parent:
                continue
            tfn = project.functions.get(target)
            if tfn is None:
                continue
            if tfn.module in contracts.MAIN_ONLY_MODULES:
                continue
            if tfn.name in _DRAIN_NAMES:
                continue
            fp.worker_parent[target] = fid
            queue.append(target)

    # Main side: the per-batch hot path, drain points and the worker
    # roots themselves excluded.
    for fn in project.iter_functions():
        if fn.name not in contracts.PER_BATCH_METHOD_NAMES:
            continue
        if fn.name in _DRAIN_NAMES:
            continue
        if fn.id in worker_roots or fn.id in fp.worker_parent:
            continue
        if lane_owned(project, fn.id):
            continue
        if fn.id not in fp.main_parent:
            fp.main_parent[fn.id] = None
            queue.append(fn.id)
    while queue:
        fid = queue.pop(0)
        fn = project.functions[fid]
        _collect(project, fid, fp.main_parent, fp.main_reads,
                 fp.main_writes)
        for target in sorted(set(_main_edges(fn))):
            if target in fp.main_parent:
                continue
            tfn = project.functions.get(target)
            if tfn is None:
                continue
            if target in worker_roots:
                continue
            if tfn.name in _DRAIN_NAMES:
                continue
            if (tfn.module, tfn.qualname) in contracts.DRAIN_POINTS:
                continue
            if lane_owned(project, target):
                continue
            fp.main_parent[target] = fid
            queue.append(target)

    project._race_footprints_cache = fp
    return fp


def chain(
    project: Project, parent: Dict[str, Optional[str]], fid: str
) -> str:
    """Render the BFS path root -> ... -> fid as a witness chain."""
    hops: List[FunctionInfo] = []
    cur: Optional[str] = fid
    while cur is not None:
        hops.append(project.functions[cur])
        cur = parent.get(cur)
    hops.reverse()
    return " -> ".join(f.qualname for f in hops)


def _site(project: Project, fid: str) -> Tuple[str, int]:
    fn = project.functions[fid]
    return project.modules[fn.module].rel, fn.node.lineno


# -- the rule ------------------------------------------------------------


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    fp = footprints(project)
    shared = contracts.SHARED_STATE
    for key in sorted(fp.worker_writes):
        wfid = fp.worker_writes[key]
        main_hits = [
            (verb, side[key])
            for verb, side in (
                ("writes", fp.main_writes),
                ("reads", fp.main_reads),
            )
            if key in side
        ]
        if not main_hits or key in shared:
            continue
        verb, mfid = main_hits[0]
        rel, lineno = _site(project, wfid)
        wchain = chain(project, fp.worker_parent, wfid)
        mchain = chain(project, fp.main_parent, mfid)
        out.append(
            Diagnostic(
                RULE_ID,
                rel,
                lineno,
                f"shared attribute {key}: the worker lane writes it "
                f"(via {wchain}) and per-batch main-thread code "
                f"{verb} it (via {mchain}); pin it in "
                "contracts.SHARED_STATE with a one-line "
                "synchronization justification (and the pinning "
                "test) or remove the sharing",
            )
        )
    # Staleness: a SHARED_STATE entry must still be shared (tree-only;
    # fixture runs never see the engine's inventory).
    if _TREE_SENTINEL in project.modules:
        worker_all = set(fp.worker_reads) | set(fp.worker_writes)
        main_all = set(fp.main_reads) | set(fp.main_writes)
        for key in sorted(shared):
            if key in worker_all and key in main_all:
                continue
            out.append(
                Diagnostic(
                    RULE_ID,
                    "bytewax_tpu_torch/analysis/contracts.py",
                    1,
                    f"stale SHARED_STATE entry {key}: no longer "
                    "touched by both the worker lane and the "
                    "per-batch main path — remove it (and update the "
                    "pinning test)",
                )
            )
    return out
