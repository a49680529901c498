"""Shared helpers for the contract rules."""

import ast
from typing import Iterable, List, Optional, Set, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.resolver import (
    FunctionInfo,
    Module,
    Project,
)

__all__ = [
    "comm_receiver_events",
    "const_str_arg",
    "is_comm_expr",
    "is_pipeline_expr",
    "local_aliases",
    "pipeline_aliases",
    "pipeline_submit_sites",
]


def const_str_arg(call: ast.Call, index: int = 0) -> Optional[str]:
    """The call's positional arg at ``index`` when it is a string
    literal."""
    if len(call.args) > index and isinstance(
        call.args[index], ast.Constant
    ):
        val = call.args[index].value
        if isinstance(val, str):
            return val
    return None


def local_aliases(
    fn: FunctionInfo, is_source: "callable"
) -> Set[str]:
    """Names assigned (anywhere in ``fn``) from an expression the
    predicate tags — e.g. ``c = self.comm`` with a predicate matching
    ``*.comm``.  Chained re-aliasing (``d = c``) is followed until a
    fixpoint, so a rename chain cannot smuggle the value past a
    rule.  Reads the resolver's pre-collected assignment list — no
    AST re-walk."""
    tagged: Set[str] = set()
    assigns: List[Tuple[str, ast.expr]] = []
    for targets, value in fn.assigns:
        # Every target of a (possibly chained) assignment:
        # ``c = d = self.comm`` tags both names.
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                assigns.append((tgt.id, value))
    changed = True
    while changed:
        changed = False
        for name, value in assigns:
            if name in tagged:
                continue
            if is_source(value) or (
                isinstance(value, ast.Name) and value.id in tagged
            ):
                tagged.add(name)
                changed = True
    return tagged


def _project_assigns(project: Project):
    """Every assignment in the project — function bodies (the scan
    pass) plus class-level statements — as ``(mod, targets, value)``
    triples, collected once and cached.  The attribute fixpoints
    below iterate this list instead of re-walking every AST."""
    cached = getattr(project, "_project_assigns_cache", None)
    if cached is not None:
        return cached
    out = []
    for mod in project.modules.values():
        for targets, value in mod.scope_assigns:
            out.append((mod, targets, value))
        for fn in mod.functions.values():
            if fn.nested:
                continue  # enclosing scan already covers these
            for targets, value in fn.assigns:
                out.append((mod, targets, value))
    project._project_assigns_cache = out
    return out


def _attr_name_fixpoint(
    project: Project, seed: Set[str], ctor_dotted: str
) -> Set[str]:
    """Attribute names that (transitively) hold a value of the given
    class: seeded by name convention and/or construction
    (``X = Ctor(...)``), closed over project-wide re-assignment
    (``self.mesh = driver.comm`` makes ``.mesh`` holding too)."""
    names = set(seed)

    def denotes(expr: ast.expr, mod: Module) -> bool:
        if isinstance(expr, ast.Attribute):
            return expr.attr in names
        if isinstance(expr, ast.Name):
            return expr.id in names
        if isinstance(expr, ast.Call):
            return (
                project.resolve_dotted(mod, expr.func) == ctor_dotted
            )
        return False

    # Fixpoint over attribute names (value expressions can reference
    # attributes tagged in a later pass).
    changed = True
    while changed:
        changed = False
        for mod, targets, value in _project_assigns(project):
            if not denotes(value, mod):
                continue
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and tgt.attr not in names
                ):
                    names.add(tgt.attr)
                    changed = True
    return names


def _comm_attr_names(project: Project) -> Set[str]:
    """Attribute names that hold the Comm object (``self.comm`` by
    convention, plus anything assigned FROM a comm-denoting
    expression anywhere in the project, to a fixpoint).  Cached on
    the project object."""
    cached = getattr(project, "_comm_attr_names_cache", None)
    if cached is not None:
        return cached
    names = _attr_name_fixpoint(
        project, {"comm"}, contracts.COMM_CLASS
    )
    project._comm_attr_names_cache = names
    return names


def _is_comm_expr(
    project: Project,
    mod: Module,
    fn: FunctionInfo,
    node: ast.expr,
    aliases: Set[str],
) -> bool:
    """Does this expression denote the cluster Comm object?

    True for: a ``Comm(...)`` construction (resolved through
    imports/aliases), any attribute whose name is comm-holding
    project-wide (``.comm`` by convention, plus attributes assigned
    from a comm expression — ``self.mesh = driver.comm``), a name
    aliased to one of those, a parameter/variable literally named
    ``comm``, and ``self`` inside :class:`Comm` (or a subclass)."""
    if isinstance(node, ast.Call):
        dotted = project.resolve_dotted(mod, node.func)
        if dotted == contracts.COMM_CLASS:
            return True
        ent = project.lookup(dotted) if dotted else None
        if ent is not None and ent[0] == "class":
            mro = project.mro(ent[1])
            return any(
                f"{ci.module}.{ci.name}" == contracts.COMM_CLASS
                for ci in mro
            )
        return False
    if isinstance(node, ast.Attribute) and node.attr in _comm_attr_names(
        project
    ):
        return True
    if isinstance(node, ast.Name):
        if node.id == "comm" or node.id in aliases:
            return True
        if node.id == "self" and fn.cls is not None:
            mro = project.mro(f"{fn.module}:{fn.cls}")
            return any(
                f"{ci.module}.{ci.name}" == contracts.COMM_CLASS
                for ci in mro
            )
    return False


def is_comm_expr(
    project: Project,
    mod: Module,
    fn: FunctionInfo,
    node: ast.expr,
    aliases: Optional[Set[str]] = None,
) -> bool:
    """Public face of :func:`_is_comm_expr` for rules that need to
    recognize the cluster Comm object outside the raw-send event
    scan (e.g. bound-method aliases of ``comm.send`` on the worker
    lane)."""
    return _is_comm_expr(
        project, mod, fn, node, aliases if aliases is not None else set()
    )


def _pipeline_attr_names(project: Project) -> Set[str]:
    """Attribute names that hold a :class:`DevicePipeline`
    (``self._pipe`` by convention, plus anything assigned from a
    pipeline-denoting expression project-wide, to a fixpoint) —
    the same shape as :func:`_comm_attr_names`."""
    cached = getattr(project, "_pipeline_attr_names_cache", None)
    if cached is not None:
        return cached
    names = _attr_name_fixpoint(
        project, set(), contracts.PIPELINE_CLASS
    )
    project._pipeline_attr_names_cache = names
    return names


def is_pipeline_expr(
    project: Project,
    mod: Module,
    fn: FunctionInfo,
    node: ast.expr,
    aliases: Set[str],
) -> bool:
    """Does this expression denote a dispatch pipeline?  True for a
    ``DevicePipeline(...)`` construction, an attribute whose name is
    pipeline-holding project-wide (``self._pipe``), a local name
    assigned from one of those, and ``self`` inside the pipeline
    class itself."""
    if isinstance(node, ast.Call):
        return (
            project.resolve_dotted(mod, node.func)
            == contracts.PIPELINE_CLASS
        )
    if isinstance(node, ast.Attribute):
        return node.attr in _pipeline_attr_names(project)
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return True
        if node.id == "self" and fn.cls is not None:
            return any(
                f"{ci.module}.{ci.name}" == contracts.PIPELINE_CLASS
                for ci in project.mro(f"{fn.module}:{fn.cls}")
            )
    return False


def pipeline_aliases(
    project: Project, mod: Module, fn: FunctionInfo
) -> Set[str]:
    """Local names aliased to a pipeline-denoting expression."""
    return local_aliases(
        fn,
        lambda expr: is_pipeline_expr(project, mod, fn, expr, set()),
    )


def pipeline_submit_sites(
    project: Project, mod: Module, fn: FunctionInfo
) -> Iterable[Tuple[ast.Call, Set[str]]]:
    """Yield ``(call, worker_targets)`` for every thread-submission
    call in ``fn``: a ``push``/``submit`` on a pipeline-denoting
    receiver, with the callable first argument resolved to the
    function ids that will run on the worker lane."""
    aliases: Optional[Set[str]] = None
    for call in fn.calls:
        node = call.node
        callee = node.func
        if not isinstance(callee, ast.Attribute):
            continue
        if callee.attr not in contracts.PIPELINE_SUBMIT_METHODS:
            continue
        if aliases is None:
            aliases = pipeline_aliases(project, mod, fn)
        if not is_pipeline_expr(project, mod, fn, callee.value, aliases):
            continue
        if not node.args:
            continue
        yield node, project.callable_targets(mod, fn, node.args[0])


def comm_receiver_events(
    project: Project, mod: Module, fn: FunctionInfo
) -> Iterable[Tuple[str, ast.Call]]:
    """Yield ``(kind, call)`` comm events in a function body:

    - ``("comm_construct", call)`` — ``Comm(...)`` construction
    - ``("raw_send", call)`` — ``send``/``broadcast`` on a
      Comm-denoting receiver (through any local alias)
    - ``("ship", call)`` — ``ship_deliver``/``ship_route``

    Iterates the resolver's pre-resolved call list (no AST re-walk);
    aliases are computed lazily — only when a candidate name
    actually appears.
    """
    aliases: Optional[Set[str]] = None
    for call in fn.calls:
        node = call.node
        callee = node.func
        if call.dotted == contracts.COMM_CLASS:
            yield ("comm_construct", node)
            continue
        if call.name in contracts.SHIP_METHODS:
            yield ("ship", node)
            continue
        if call.name in contracts.RAW_SEND_METHODS and isinstance(
            callee, ast.Attribute
        ):
            if aliases is None:
                aliases = local_aliases(
                    fn,
                    lambda expr: _is_comm_expr(
                        project, mod, fn, expr, set()
                    ),
                )
            if _is_comm_expr(project, mod, fn, callee.value, aliases):
                yield ("raw_send", node)
