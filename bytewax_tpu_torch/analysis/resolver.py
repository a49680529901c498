"""Module/attribute resolver and intra-package call graph.

Pure-AST model of the package (no imports are executed, no torch is
touched): every scanned file becomes a :class:`Module` with its
import/alias bindings, class table, and function table; every call
site is resolved through those bindings into either a project entity
(function/class) or an external dotted path
(``torch.distributed.all_to_all_single``).

Resolution sees through the things a regex cannot:

- ``from bytewax_tpu_torch.engine.comm import Comm as C`` then ``C(...)``
- ``from bytewax_tpu_torch.engine import faults as _f`` then ``_f.fire(...)``
- method receivers: ``self.agg.flush()`` binds to the classes a
  factory assigned to ``self.agg`` (attribute-type map built from
  ``self.X = Factory(...)`` assignments project-wide), and ``self``
  binds through the enclosing class's MRO.

Method calls with an unknown receiver fall back to *visible* name
matching: every project method with that name whose defining module
the caller imports (directly or via a member).  This deliberately
over-approximates — a contract checker must fail loud on a possible
edge, not stay quiet on a missed one.

Nested functions and lambdas are indexed as their own
:class:`FunctionInfo` entries (qualname ``outer.<locals>.name`` /
``outer.<locals>.<lambda>``), carrying a ``parent`` pointer and the
enclosing class for ``self`` binding.  This is what lets a rule trace
callables handed to a thread-submission surface
(``DevicePipeline.push(task, finalize)``) as roots of their own
execution lane — see :meth:`Project.callable_targets`.  For backward
compatibility the enclosing function still *sees* its nested bodies
(``body_walk`` descends), so rules that iterate top-level functions
only must skip ``fn.parent is not None`` entries to avoid double
counting; ``iter_functions`` does so by default.
"""

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "MODULE_QUAL",
    "body_walk",
    "CallSite",
    "ClassInfo",
    "FunctionInfo",
    "Module",
    "Project",
]


#: Qualname of the synthetic function holding a module's top-level
#: statements (scripts execute these; rules may inspect their calls).
MODULE_QUAL = "<module>"

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)

#: Scope pruning for the per-function EFFECT sets: unlike the
#: backward-compatible body lists, a nested def or lambda owns its own
#: reads/writes (it runs on whatever thread it is handed to, not its
#: encloser's), so lambdas prune too.
_EFFECT_SCOPE_NODES = _SCOPE_NODES + (ast.Lambda,)

#: Container-mutator method names: ``self.X.append(...)`` (and
#: ``self.X[k] = v``) mutate the object held in ``X`` — for the
#: effect sets that is a WRITE of ``X``, not a read (a race on the
#: container is a race on the attribute that shares it).
_MUTATOR_METHODS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "insert",
        "add",
        "update",
        "setdefault",
        "pop",
        "popleft",
        "popitem",
        "remove",
        "discard",
        "clear",
        "put",
    }
)


def _walk_pruned(node: ast.AST):
    """``ast.walk`` that does not descend into nested function/class
    scopes — the module pseudo-function must only see module-level
    statements."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, _SCOPE_NODES):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def _walk_effect_scope(node: ast.AST):
    """Walk one function's OWN statements only: nested defs, lambdas
    and class bodies are separate execution scopes with their own
    :class:`FunctionInfo` entries and their own effect sets."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, _EFFECT_SCOPE_NODES):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def body_walk(fn: "FunctionInfo"):
    """Walk a function's body; for the module pseudo-function, prune
    nested function/class scopes so their statements are not seen
    twice (they have their own FunctionInfo)."""
    if fn.qualname == MODULE_QUAL:
        return _walk_pruned(fn.node)
    return ast.walk(fn.node)


def _dotted_of(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` expression -> ``["a", "b", "c"]``; None when the
    chain is rooted in anything but a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


class CallSite:
    """One resolved call expression inside a function body."""

    __slots__ = (
        "node",
        "lineno",
        "col",
        "name",
        "dotted",
        "targets",
        "fallback",
    )

    def __init__(
        self,
        node: ast.Call,
        name: str,
        dotted: Optional[str],
        targets: Set[str],
        fallback: bool = False,
    ):
        self.node = node
        self.lineno = node.lineno
        self.col = node.col_offset
        #: Final callee segment (``fire`` for ``_f.fire(...)``).
        self.name = name
        #: Fully resolved dotted path when the whole chain resolved
        #: through module bindings (``bytewax_tpu_torch.engine.faults.fire``
        #: or an external path like ``torch.distributed.barrier``); None for
        #: method calls on non-module receivers.
        self.dotted = dotted
        #: Project function ids (``module:qualname``) this call may
        #: invoke.
        self.targets = targets
        #: True when ``targets`` came from the visible-name fallback
        #: (unknown receiver): deliberately over-approximate edges a
        #: rule may choose to treat with less confidence for
        #: ubiquitous collection-method names.
        self.fallback = fallback


class FunctionInfo:
    __slots__ = (
        "module",
        "qualname",
        "node",
        "cls",
        "calls",
        "parent",
        "local_defs",
        "assigns",
        "call_nodes",
        "subscripts",
        "self_reads",
        "self_writes",
        "global_decls",
        "name_loads",
    )

    def __init__(
        self,
        module: str,
        qualname: str,
        node: ast.AST,
        cls: Optional[str],
        parent: Optional[str] = None,
    ):
        self.module = module
        self.qualname = qualname  # "Class.method" or "func"
        self.node = node
        self.cls = cls  # owning (or enclosing, for nested) class name
        self.calls: List[CallSite] = []
        #: Enclosing function id for nested defs/lambdas, else None.
        self.parent = parent
        #: bare name -> FunctionInfo of defs nested directly in this
        #: function's scope (lambdas excluded: they have no name).
        self.local_defs: Dict[str, "FunctionInfo"] = {}
        #: ``(target exprs, value expr)`` for every Assign in the
        #: body, collected by the one scan pass — alias and
        #: attribute-type analyses read this instead of re-walking
        #: the AST.
        self.assigns: List[Tuple[Tuple[ast.expr, ...], ast.expr]] = []
        #: Every ``ast.Call`` in the body (same scan pass).
        self.call_nodes: List[ast.Call] = []
        #: ``ast.Subscript`` loads whose base is a name/attribute
        #: chain (environment-read detection and the like).
        self.subscripts: List[ast.Subscript] = []
        #: Effect sets (BTX-LANE / BTX-RACE): attribute names this
        #: function loads / stores on bare ``self``.  Scope-pruned —
        #: nested defs and lambdas carry their OWN effects (they may
        #: execute on a different thread than their encloser), unlike
        #: the backward-compatible body lists above.  An augmented
        #: assignment counts as a write (its read is implied).
        self.self_reads: Set[str] = set()
        self.self_writes: Set[str] = set()
        #: Names this function declares ``global`` (the only way a
        #: function WRITES a module global) and every bare name it
        #: loads — the race rule intersects the loads with the
        #: module's globally-mutated names to get global READS.
        self.global_decls: Set[str] = set()
        self.name_loads: Set[str] = set()

    @property
    def nested(self) -> bool:
        return self.parent is not None

    @property
    def id(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


class ClassInfo:
    __slots__ = ("module", "name", "node", "bases", "methods", "attrs")

    def __init__(self, module: str, name: str, node: ast.ClassDef):
        self.module = module
        self.name = name
        self.node = node
        #: Raw base expressions, resolved lazily by Project.mro.
        self.bases: List[ast.expr] = list(node.bases)
        self.methods: Dict[str, FunctionInfo] = {}
        #: Class-level ``name = <constant>`` assignments.
        self.attrs: Dict[str, object] = {}

    @property
    def id(self) -> str:
        return f"{self.module}:{self.name}"


class Module:
    __slots__ = (
        "name",
        "path",
        "rel",
        "tree",
        "source",
        "is_script",
        "bindings",
        "functions",
        "classes",
        "visible",
        "lambda_map",
        "scope_assigns",
    )

    def __init__(
        self, name: str, path: Path, source: str, is_script: bool
    ):
        self.name = name
        self.path = path
        #: Display path used in diagnostics (set by the loader).
        self.rel = str(path)
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.is_script = is_script
        #: local name -> dotted target ("torch", "bytewax_tpu_torch.engine.
        #: comm.Comm", ...), collected from every import statement in
        #: the file (function-local imports included).
        self.bindings: Dict[str, str] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        #: Project modules this module imports (or imports members
        #: of); used to scope name-based method-edge fallbacks.
        self.visible: Set[str] = set()
        #: (lineno, col) of a ``lambda`` expression -> its indexed
        #: function id; lets callable-argument resolution name the
        #: exact lambda at a call site.
        self.lambda_map: Dict[Tuple[int, int], str] = {}
        #: Class-body ``Assign`` statements (outside any function):
        #: together with every function's ``assigns`` these cover all
        #: assignments in the file, so fixpoint analyses never
        #: re-walk the AST.
        self.scope_assigns: List[
            Tuple[Tuple[ast.expr, ...], ast.expr]
        ] = []


class Project:
    """All scanned modules plus the resolved call graph."""

    def __init__(self) -> None:
        self.modules: Dict[str, Module] = {}
        #: ``module:qualname`` -> FunctionInfo
        self.functions: Dict[str, FunctionInfo] = {}
        #: ``module:ClassName`` -> ClassInfo
        self.classes: Dict[str, ClassInfo] = {}
        #: method name -> ids of every project function with it.
        self._by_method: Dict[str, Set[str]] = {}
        #: attribute name -> class ids assigned to ``self.<attr>``
        #: anywhere in the project (via constructor or factory call).
        self._attr_types: Dict[str, Set[str]] = {}
        #: factory function id -> class ids it can return.
        self._returns_cache: Dict[str, Set[str]] = {}

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(
        cls,
        files: Iterable[Tuple[str, Path, bool]],
        rel_root: Optional[Path] = None,
    ) -> "Project":
        """Build a project from ``(module_name, path, is_script)``
        triples.  Files that fail to parse raise SyntaxError — a
        contract checker must not skip unparseable engine code."""
        proj = cls()
        for name, path, is_script in files:
            source = Path(path).read_text()
            mod = Module(name, Path(path), source, is_script)
            if rel_root is not None:
                try:
                    mod.rel = str(
                        Path(path).resolve().relative_to(
                            Path(rel_root).resolve()
                        )
                    )
                except ValueError:
                    pass
            proj.modules[name] = mod
        for mod in proj.modules.values():
            proj._index_module(mod)
        for mod in proj.modules.values():
            proj._compute_visible(mod)
        # ONE body walk per function collects assigns/calls/
        # subscripts; everything downstream (attribute types, call
        # resolution, the rules' alias analyses) consumes the cached
        # lists instead of re-walking the AST.
        for mod in proj.modules.values():
            for fn in mod.functions.values():
                proj._scan_body(fn)
        proj._build_attr_types()
        for mod in proj.modules.values():
            for fn in mod.functions.values():
                proj._resolve_calls(mod, fn)
        return proj

    def _scan_body(self, fn: FunctionInfo) -> None:
        for node in body_walk(fn):
            if isinstance(node, ast.Assign):
                fn.assigns.append((tuple(node.targets), node.value))
            elif isinstance(node, ast.Call):
                fn.call_nodes.append(node)
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ):
                fn.subscripts.append(node)
        # Second, scope-pruned pass for the effect sets: ``self.X``
        # loads and stores belonging to THIS function only (nested
        # defs/lambdas prune — they have their own FunctionInfo and
        # may run on another thread).
        for node in _walk_effect_scope(fn.node):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                if isinstance(node.ctx, ast.Load):
                    fn.self_reads.add(node.attr)
                else:
                    fn.self_writes.add(node.attr)
            elif isinstance(node, ast.Subscript) and not isinstance(
                node.ctx, ast.Load
            ):
                # self.X[k] = v / del self.X[k]: a write of X.
                base = node.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    fn.self_writes.add(base.attr)
            elif isinstance(node, ast.Call):
                # self.X.append(...) and friends: a write of X.
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _MUTATOR_METHODS
                    and isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self"
                ):
                    fn.self_writes.add(f.value.attr)
            elif isinstance(node, ast.Global):
                fn.global_decls.update(node.names)
            elif isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Load
            ):
                fn.name_loads.add(node.id)

    # -- indexing ----------------------------------------------------------

    def _index_module(self, mod: Module) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
                    mod.bindings[local] = target
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # Relative import: resolve against this module's
                    # package path.
                    pkg = mod.name.split(".")
                    pkg = pkg[: len(pkg) - node.level]
                    base = ".".join(pkg + ([node.module] if node.module else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    mod.bindings[local] = f"{base}.{alias.name}"

        def index_fn(
            node: ast.AST,
            qual: str,
            cls: Optional[ClassInfo],
            parent: Optional[FunctionInfo] = None,
        ) -> FunctionInfo:
            fn = FunctionInfo(
                mod.name,
                qual,
                node,
                cls.name if cls else None,
                parent=parent.id if parent is not None else None,
            )
            mod.functions[qual] = fn
            self.functions[fn.id] = fn
            if not isinstance(node, ast.Lambda):
                self._by_method.setdefault(fn.name, set()).add(fn.id)
            if cls is not None and parent is None:
                cls.methods[fn.name] = fn
            return fn

        def index_nested(owner: FunctionInfo, cls: Optional[ClassInfo]):
            """Index defs/lambdas nested directly inside ``owner``
            (recursively).  They keep the enclosing class for ``self``
            binding (closures capture it) but are NOT registered as
            class methods, and the name-fallback edge builder skips
            them — only explicit references (a local call, a callable
            argument) reach a nested function."""
            scopes: List[ast.AST] = []
            stack = list(ast.iter_child_nodes(owner.node))
            while stack:
                child = stack.pop()
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    scopes.append(child)
                    continue
                if isinstance(child, ast.ClassDef):
                    continue  # nested classes: out of scope
                stack.extend(ast.iter_child_nodes(child))
            scopes.sort(key=lambda n: (n.lineno, n.col_offset))
            n_lambda = 0
            for node in scopes:
                if isinstance(node, ast.Lambda):
                    n_lambda += 1
                    leaf = (
                        "<lambda>"
                        if n_lambda == 1
                        else f"<lambda:{n_lambda}>"
                    )
                else:
                    leaf = node.name
                sub = index_fn(
                    node,
                    f"{owner.qualname}.<locals>.{leaf}",
                    cls,
                    parent=owner,
                )
                if isinstance(node, ast.Lambda):
                    mod.lambda_map[(node.lineno, node.col_offset)] = (
                        sub.id
                    )
                else:
                    owner.local_defs[node.name] = sub
                index_nested(sub, cls)

        # Module-level statements as a pseudo-function: scripts
        # execute these, and rules need their call sites resolved.
        index_fn(mod.tree, MODULE_QUAL, None)

        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = index_fn(node, node.name, None)
                index_nested(fn, None)
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(mod.name, node.name, node)
                mod.classes[node.name] = ci
                self.classes[ci.id] = ci
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        fn = index_fn(sub, f"{node.name}.{sub.name}", ci)
                        index_nested(fn, ci)
                    elif isinstance(sub, ast.Assign):
                        mod.scope_assigns.append(
                            (tuple(sub.targets), sub.value)
                        )
                        for tgt in sub.targets:
                            if isinstance(tgt, ast.Name) and isinstance(
                                sub.value, ast.Constant
                            ):
                                ci.attrs[tgt.id] = sub.value.value

    def _compute_visible(self, mod: Module) -> None:
        mod.visible.add(mod.name)
        for target in mod.bindings.values():
            # Longest project-module prefix of the bound dotted path.
            parts = target.split(".")
            for i in range(len(parts), 0, -1):
                prefix = ".".join(parts[:i])
                if prefix in self.modules:
                    mod.visible.add(prefix)
                    break

    # -- resolution --------------------------------------------------------

    def resolve_dotted(
        self, mod: Module, node: ast.AST
    ) -> Optional[str]:
        """Resolve an ``a.b.c`` expression through the module's
        bindings into a dotted path.  The result may name a project
        entity or an external one (``torch.distributed.barrier``)."""
        parts = _dotted_of(node)
        if parts is None:
            return None
        head, rest = parts[0], parts[1:]
        bound = mod.bindings.get(head)
        if bound is not None:
            return ".".join([bound] + rest)
        if head in mod.classes or head in mod.functions:
            return ".".join([mod.name, head] + rest)
        # Unbound head (a local, ``self``, a builtin): not a dotted
        # path — method-receiver analysis handles it instead.
        return None

    def lookup(self, dotted: str) -> Optional[Tuple[str, str]]:
        """Map a dotted path to a project entity: ``("func", id)``,
        ``("class", id)``, or ``("module", name)``."""
        if dotted in self.modules:
            return ("module", dotted)
        if "." not in dotted:
            return None
        mod_name, _, attr = dotted.rpartition(".")
        mod = self.modules.get(mod_name)
        if mod is None:
            return None
        if attr in mod.classes:
            return ("class", f"{mod_name}:{attr}")
        if attr in mod.functions:
            return ("func", f"{mod_name}:{attr}")
        return None

    def mro(self, class_id: str) -> List[ClassInfo]:
        """Best-effort linearization: the class followed by its
        resolved project bases, depth-first."""
        out: List[ClassInfo] = []
        seen: Set[str] = set()

        def visit(cid: str) -> None:
            if cid in seen:
                return
            seen.add(cid)
            ci = self.classes.get(cid)
            if ci is None:
                return
            out.append(ci)
            mod = self.modules[ci.module]
            for base in ci.bases:
                dotted = self.resolve_dotted(mod, base)
                if dotted is None:
                    continue
                ent = self.lookup(dotted)
                if ent is not None and ent[0] == "class":
                    visit(ent[1])

        visit(class_id)
        return out

    def class_method(
        self, class_id: str, name: str
    ) -> Optional[FunctionInfo]:
        for ci in self.mro(class_id):
            fn = ci.methods.get(name)
            if fn is not None:
                return fn
        return None

    def class_attr(self, class_id: str, name: str) -> object:
        for ci in self.mro(class_id):
            if name in ci.attrs:
                return ci.attrs[name]
        return None

    def returned_classes(
        self, func_id: str, _depth: int = 0
    ) -> Set[str]:
        """Class ids a factory function can return (following
        factory→factory calls two levels deep)."""
        cached = self._returns_cache.get(func_id)
        if cached is not None:
            return cached
        self._returns_cache[func_id] = set()  # cycle guard
        out: Set[str] = set()
        fn = self.functions.get(func_id)
        if fn is None or _depth > 3:
            return out
        mod = self.modules[fn.module]
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            val = node.value
            if not isinstance(val, ast.Call):
                continue
            dotted = self.resolve_dotted(mod, val.func)
            if dotted is None:
                continue
            ent = self.lookup(dotted)
            if ent is None:
                continue
            kind, ident = ent
            if kind == "class":
                out.add(ident)
            elif kind == "func":
                out |= self.returned_classes(ident, _depth + 1)
        self._returns_cache[func_id] = out
        return out

    def _build_attr_types(self) -> None:
        """``self.X = Ctor(...)`` / ``self.X = factory(...)`` across
        the project -> attribute name X may hold those classes.
        Nested functions are skipped (closures assign through the
        same ``self``, and the enclosing function's scan already
        covers their statements)."""
        for fn in self.functions.values():
            if fn.nested:
                continue
            mod = self.modules[fn.module]
            for targets, value in fn.assigns:
                if not isinstance(value, ast.Call):
                    continue
                dotted = self.resolve_dotted(mod, value.func)
                if dotted is None:
                    continue
                ent = self.lookup(dotted)
                if ent is None:
                    continue
                kind, ident = ent
                classes: Set[str] = set()
                if kind == "class":
                    classes = {ident}
                elif kind == "func":
                    classes = self.returned_classes(ident)
                if not classes:
                    continue
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        self._attr_types.setdefault(
                            tgt.attr, set()
                        ).update(classes)

    # -- call graph --------------------------------------------------------

    def _local_var_types(
        self, mod: Module, fn: FunctionInfo
    ) -> Dict[str, Set[str]]:
        """``x = Ctor(...)`` / ``x = factory(...)`` locals."""
        out: Dict[str, Set[str]] = {}
        for targets, value in fn.assigns:
            if not isinstance(value, ast.Call):
                continue
            dotted = self.resolve_dotted(mod, value.func)
            if dotted is None:
                continue
            ent = self.lookup(dotted)
            if ent is None:
                continue
            kind, ident = ent
            classes: Set[str] = set()
            if kind == "class":
                classes = {ident}
            elif kind == "func":
                classes = self.returned_classes(ident)
            if not classes:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, set()).update(classes)
        return out

    def _resolve_calls(self, mod: Module, fn: FunctionInfo) -> None:
        local_types = self._local_var_types(mod, fn)
        for node in fn.call_nodes:
            callee = node.func
            targets: Set[str] = set()
            dotted = self.resolve_dotted(mod, callee)
            name = (
                callee.attr
                if isinstance(callee, ast.Attribute)
                else callee.id
                if isinstance(callee, ast.Name)
                else ""
            )
            if not name:
                continue
            if dotted is not None:
                ent = self.lookup(dotted)
                if ent is not None:
                    kind, ident = ent
                    if kind == "func":
                        targets.add(ident)
                    elif kind == "class":
                        # Construction: edge into __init__ if defined.
                        init = self.class_method(ident, "__init__")
                        if init is not None:
                            targets.add(init.id)
            fallback = False
            if not targets and isinstance(callee, ast.Attribute):
                targets, fallback = self._method_targets(
                    mod, fn, callee, local_types
                )
            if not targets and isinstance(callee, ast.Name):
                local = self._local_def(fn, callee.id)
                if local is not None:
                    targets = {local.id}
                else:
                    bound = self._bound_alias_target(fn, callee.id)
                    if bound is not None:
                        targets = {bound.id}
            fn.calls.append(
                CallSite(node, name, dotted, targets, fallback)
            )

    def _local_def(
        self, fn: FunctionInfo, name: str
    ) -> Optional[FunctionInfo]:
        """A nested ``def`` visible from ``fn`` under ``name``
        (Python closure scoping: this function, then the enclosing
        chain)."""
        cur: Optional[FunctionInfo] = fn
        while cur is not None:
            target = cur.local_defs.get(name)
            if target is not None:
                return target
            cur = (
                self.functions.get(cur.parent)
                if cur.parent is not None
                else None
            )
        return None

    def _bound_alias_target(
        self, fn: FunctionInfo, name: str
    ) -> Optional[FunctionInfo]:
        """A bound-method alias visible from ``fn`` under ``name``
        (``m = self._meth`` in this function or an enclosing one,
        with ``_meth`` a method of the owning class's MRO).  Without
        this edge a worker task that binds a method to a local first
        would vanish from the call graph — the exact smuggling shape
        the effect-footprint rules must see."""
        cur: Optional[FunctionInfo] = fn
        while cur is not None:
            for targets, value in cur.assigns:
                if not (
                    isinstance(value, ast.Attribute)
                    and isinstance(value.value, ast.Name)
                    and value.value.id == "self"
                    and cur.cls is not None
                ):
                    continue
                for tgt in targets:
                    if isinstance(tgt, ast.Name) and tgt.id == name:
                        target = self.class_method(
                            f"{cur.module}:{cur.cls}", value.attr
                        )
                        if target is not None:
                            return target
            cur = (
                self.functions.get(cur.parent)
                if cur.parent is not None
                else None
            )
        return None

    def _method_targets(
        self,
        mod: Module,
        fn: FunctionInfo,
        callee: ast.Attribute,
        local_types: Dict[str, Set[str]],
    ) -> Tuple[Set[str], bool]:
        """Returns ``(candidate ids, used_name_fallback)``."""
        name = callee.attr
        recv = callee.value
        candidates: Set[str] = set()
        # self.m() -> enclosing class MRO.
        if isinstance(recv, ast.Name) and recv.id == "self" and fn.cls:
            target = self.class_method(f"{fn.module}:{fn.cls}", name)
            if target is not None:
                return {target.id}, False
        # typed local: x = Ctor(...); x.m()
        if isinstance(recv, ast.Name) and recv.id in local_types:
            for cid in local_types[recv.id]:
                target = self.class_method(cid, name)
                if target is not None:
                    candidates.add(target.id)
            if candidates:
                return candidates, False
        # typed attribute: self.agg.m() / driver.agg.m() via the
        # project-wide attribute-type map.
        if isinstance(recv, ast.Attribute):
            for cid in self._attr_types.get(recv.attr, ()):
                target = self.class_method(cid, name)
                if target is not None:
                    candidates.add(target.id)
            if candidates:
                return candidates, False
        # Fallback: every visible project method with this name.
        for fid in self._by_method.get(name, ()):  # pragma: no branch
            target = self.functions[fid]
            if target.cls is None or target.nested:
                # Bare functions resolve via dotted paths; nested
                # defs only via explicit local/callable references.
                continue
            if target.module in mod.visible:
                candidates.add(fid)
        return candidates, bool(candidates)

    # -- callable-argument tracing ----------------------------------------

    def callable_targets(
        self, mod: Module, fn: FunctionInfo, expr: ast.expr
    ) -> Set[str]:
        """Function ids a callable-valued *expression* may denote —
        the argument side of a thread-submission surface
        (``pipe.push(task, finalize)``): a lambda, a nested ``def``
        (or an alias of one), a module-level function, or a bound
        method (``self._accel_finalize``)."""
        out: Set[str] = set()
        if isinstance(expr, ast.Lambda):
            fid = mod.lambda_map.get((expr.lineno, expr.col_offset))
            if fid is not None:
                out.add(fid)
            return out
        if isinstance(expr, ast.Name):
            name = expr.id
            # One level of local re-aliasing: ``t = task``.
            for targets, value in fn.assigns:
                if isinstance(value, ast.Name) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in targets
                ):
                    name = value.id
                    break
            local = self._local_def(fn, name)
            if local is not None:
                return {local.id}
            dotted = self.resolve_dotted(mod, ast.Name(id=name))
            if dotted is not None:
                ent = self.lookup(dotted)
                if ent is not None and ent[0] == "func":
                    out.add(ent[1])
            return out
        if isinstance(expr, ast.Attribute):
            out |= self._method_targets(
                mod, fn, expr, self._local_var_types(mod, fn)
            )[0]
            dotted = self.resolve_dotted(mod, expr)
            if dotted is not None:
                ent = self.lookup(dotted)
                if ent is not None and ent[0] == "func":
                    out.add(ent[1])
            return out
        return out

    # -- convenience for rules --------------------------------------------

    def functions_named(self, name: str) -> List[FunctionInfo]:
        return [
            self.functions[fid]
            for fid in sorted(self._by_method.get(name, ()))
            if not self.functions[fid].nested
        ]

    def iter_functions(
        self, include_nested: bool = False
    ) -> Sequence[FunctionInfo]:
        """All indexed functions.  Nested defs/lambdas are excluded by
        default: the enclosing function's body walk already covers
        their statements, so rules that scan every function would
        double-report.  Lane-tracing rules pass
        ``include_nested=True``."""
        return [
            fn
            for fn in self.functions.values()
            if include_nested or not fn.nested
        ]

    def adjacency(self) -> Dict[str, Set[str]]:
        """The resolved call graph as one shared adjacency map
        (``caller id -> callee ids``), built once per project and
        cached — every reachability rule walks this same structure
        instead of re-deriving edges from ``fn.calls``."""
        cached = getattr(self, "_adjacency_cache", None)
        if cached is not None:
            return cached
        adj: Dict[str, Set[str]] = {}
        for fn in self.functions.values():
            edges = adj.setdefault(fn.id, set())
            for call in fn.calls:
                edges.update(call.targets)
        self._adjacency_cache = adj
        return adj
