"""BTX-KNOB — every BYTEWAX_TPU_* environment knob is cataloged.

The engine has grown dozens of ``BYTEWAX_TPU_*`` tuning/feature
knobs with no inventory: nothing stopped a knob from shipping
undocumented, or a doc from describing a knob the code no longer
reads.  This rule turns knob sprawl and doc drift into analyzer
findings against the pinned ``contracts.KNOBS`` catalog (name ->
default + doc anchor, mirrored as the reference table in
``docs/configuration.md``):

1. **Literal reads** — every ``os.environ.get``/``os.getenv``/
   ``os.environ[...]`` read of a ``BYTEWAX_TPU_*`` name must use a
   string literal (a computed name evades the catalog; a
   comprehension over a tuple of literals is resolved element-wise)
   and that literal must be in the catalog.

2. **Catalog staleness** — on a full-tree scan, every cataloged knob
   must still be read somewhere in the package (a removed knob must
   leave the catalog), and every entry's doc anchor must exist and
   mention the knob (doc drift).
"""

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Set, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import (
    MODULE_QUAL,
    FunctionInfo,
    Module,
    Project,
)

RULE_ID = "BTX-KNOB"

#: Module whose presence marks a full-tree scan (fixture runs scan
#: loose files and skip the catalog-staleness/doc components).
_TREE_SENTINEL = "bytewax_tpu_torch.engine.driver"


def _comprehension_literals(
    fn_node: ast.AST, name: str, read: ast.AST
) -> Optional[List[str]]:
    """If ``name`` at ``read`` is the target of an enclosing
    comprehension iterating a tuple/list of string literals
    (``os.environ.get(k) for k in ("A", "B")``), return those
    literals; else None."""
    for node in ast.walk(fn_node):
        if not isinstance(
            node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)
        ):
            continue
        found = any(n is read for n in ast.walk(node))
        if not found:
            continue
        for comp in node.generators:
            if not (
                isinstance(comp.target, ast.Name)
                and comp.target.id == name
            ):
                continue
            if isinstance(comp.iter, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant)
                and isinstance(e.value, str)
                for e in comp.iter.elts
            ):
                return [e.value for e in comp.iter.elts]
    return None


def _contains_knob_prefix(expr: ast.expr) -> bool:
    """Any string constant inside the expression carrying the knob
    prefix (an f-string / concat computing a knob name)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ):
            if contracts.KNOB_PREFIX in node.value:
                return True
    return False


def _name_binding(
    project: Project, fn: FunctionInfo, name: str
) -> Optional[ast.expr]:
    """The expression a plain name was assigned from, searching this
    function, its enclosing chain, the module level, and the module
    level of the package module it was imported from — so
    ``_KNOB = "BYTEWAX_TPU_X"; environ.get(_KNOB)`` cannot slip the
    catalog by one level of indirection, nor by keeping the name in
    another module."""
    cur: Optional[FunctionInfo] = fn
    while cur is not None:
        for targets, value in cur.assigns:
            if any(
                isinstance(t, ast.Name) and t.id == name
                for t in targets
            ):
                return value
        cur = (
            project.functions.get(cur.parent)
            if cur.parent is not None
            else None
        )
    mod = project.modules[fn.module]
    mod_fn = mod.functions.get(MODULE_QUAL)
    if mod_fn is not None and mod_fn is not fn:
        found = _module_assign(mod_fn, name)
        if found is not None:
            return found
    return _imported_constant(project, mod, name)


def _module_assign(mod_fn: FunctionInfo, name: str) -> Optional[ast.expr]:
    for targets, value in mod_fn.assigns:
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return value
    return None


def _imported_constant(
    project: Project, mod: Module, name: str
) -> Optional[ast.expr]:
    """The module-level value behind ``from pkg.mod import NAME``, so a
    knob name kept as a constant in another module of the package is
    read like a literal."""
    mod_name, _, attr = mod.bindings.get(name, "").rpartition(".")
    owner = project.modules.get(mod_name)
    owner_fn = owner.functions.get(MODULE_QUAL) if owner else None
    return _module_assign(owner_fn, attr) if owner_fn else None


def _env_reads(
    project: Project, mod: Module, fn: FunctionInfo
) -> Iterable[Tuple[int, ast.expr, ast.AST]]:
    """Yield ``(lineno, name_expr, read_node)`` for every
    environment read in ``fn``: ``os.environ.get(...)`` /
    ``os.getenv(...)`` calls and ``os.environ[...]`` subscript
    loads (through any import alias).  Reads the resolver's cached
    call/subscript lists — no AST re-walk."""
    for call in fn.calls:
        if call.dotted in contracts.ENV_READ_CALLS and call.node.args:
            yield call.lineno, call.node.args[0], call.node
    for node in fn.subscripts:
        dotted = project.resolve_dotted(mod, node.value)
        if dotted == contracts.ENV_MAPPING:
            yield node.lineno, node.slice, node


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    read_knobs: Set[str] = set()

    for fn in project.iter_functions():
        mod = project.modules[fn.module]
        for lineno, name_expr, read in _env_reads(project, mod, fn):
            literals: List[str] = []
            if isinstance(name_expr, ast.Constant) and isinstance(
                name_expr.value, str
            ):
                literals = [name_expr.value]
            elif isinstance(name_expr, ast.Name):
                resolved = _comprehension_literals(
                    fn.node, name_expr.id, read
                )
                if resolved is not None:
                    literals = resolved
                else:
                    # One level of variable indirection:
                    # ``_KNOB = "BYTEWAX_TPU_X"; environ.get(_KNOB)``.
                    bound = _name_binding(project, fn, name_expr.id)
                    if isinstance(
                        bound, ast.Constant
                    ) and isinstance(bound.value, str):
                        literals = [bound.value]
                    elif bound is not None and _contains_knob_prefix(
                        bound
                    ):
                        out.append(
                            Diagnostic(
                                RULE_ID,
                                mod.rel,
                                lineno,
                                f"computed BYTEWAX_TPU_* knob name "
                                f"in {fn.qualname}; knob reads must "
                                "be string literals so the pinned "
                                "contracts.KNOBS catalog stays "
                                "closed",
                            )
                        )
                        continue
                    else:
                        continue  # non-knob variable: out of scope
            elif _contains_knob_prefix(name_expr):
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        lineno,
                        f"computed BYTEWAX_TPU_* knob name in "
                        f"{fn.qualname}; knob reads must be string "
                        "literals so the pinned contracts.KNOBS "
                        "catalog stays closed",
                    )
                )
                continue
            else:
                continue
            for name in literals:
                if not name.startswith(contracts.KNOB_PREFIX):
                    continue
                read_knobs.add(name)
                if name not in contracts.KNOBS:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            mod.rel,
                            lineno,
                            f"uncataloged knob {name} read in "
                            f"{fn.qualname}; add it to "
                            "contracts.KNOBS (default + doc anchor), "
                            "the pinning test, and "
                            "docs/configuration.md",
                        )
                    )

    if _TREE_SENTINEL in project.modules:
        out.extend(_check_catalog(project, read_knobs))
    return out


def _check_catalog(
    project: Project, read_knobs: Set[str]
) -> List[Diagnostic]:
    """Full-tree components: catalog staleness + doc anchors."""
    out: List[Diagnostic] = []
    contracts_rel = "bytewax_tpu_torch/analysis/contracts.py"
    # Repo root: the parent of the package directory.
    driver_path = Path(project.modules[_TREE_SENTINEL].path)
    root = driver_path.resolve().parents[2]
    doc_cache: dict = {}
    for name, (_default, doc) in sorted(contracts.KNOBS.items()):
        if name not in read_knobs:
            out.append(
                Diagnostic(
                    RULE_ID,
                    contracts_rel,
                    1,
                    f"cataloged knob {name} is no longer read "
                    "anywhere in the package; drop it from "
                    "contracts.KNOBS, the pinning test, and "
                    "docs/configuration.md",
                )
            )
        doc_path = root / doc
        if doc not in doc_cache:
            doc_cache[doc] = (
                doc_path.read_text() if doc_path.is_file() else None
            )
        if doc_cache[doc] is None:
            out.append(
                Diagnostic(
                    RULE_ID,
                    contracts_rel,
                    1,
                    f"knob {name} anchors to missing doc {doc}",
                )
            )
        elif name not in doc_cache[doc]:
            out.append(
                Diagnostic(
                    RULE_ID,
                    contracts_rel,
                    1,
                    f"knob {name} anchors to {doc} but the doc "
                    "never mentions it; document the knob (or "
                    "re-anchor it) so the catalog and docs/ cannot "
                    "drift",
                )
            )
    return out
