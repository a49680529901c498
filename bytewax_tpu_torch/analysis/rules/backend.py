"""BTX-BACKEND — standalone scripts choose the platform first.

The device tier runs on ``cuda:0`` unless ``BYTEWAX_TPU_PLATFORM=cpu``
asks for the CPU, and a process inherits that variable from whoever
started it.  So a script executed directly (``python chip_smoke.py``)
must choose the platform BEFORE anything that starts the device
tier's runtime: set, ``setdefault``, ``pop`` or ``del``
``BYTEWAX_TPU_PLATFORM``, or call
``bytewax_tpu_torch.utils.force_platform``/``force_cpu_mesh``.

The rule walks each script module's executable statements in program
order (module level plus ``if __name__ == "__main__":`` bodies) and
flags the first runtime-starting call — a run entry point
(``run_main``/``cluster_main``/``cli_main``), joining the
``torch.distributed`` world, or a ``torch.cuda.*`` call other than
the ``is_available``/``device_count`` probes — that executes with no
platform choice before it.  Scripts that only *define* a flow are
exempt: ``python -m bytewax_tpu_torch.run`` is the documented
launcher and the test harness sets the platform variable.
"""

import ast
from typing import List, Optional

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Module, Project

RULE_ID = "BTX-BACKEND"


def _is_forcing(project: Project, mod: Module, node: ast.AST) -> bool:
    if isinstance(node, (ast.Assign, ast.Delete)):
        # os.environ["BYTEWAX_TPU_PLATFORM"] = ... / del environ[...]
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.slice, ast.Constant)
                and tgt.slice.value in contracts.FORCE_ENV_KEYS
            ):
                return True
        if isinstance(node, ast.Delete):
            return False
        node = node.value
    if not isinstance(node, ast.Call):
        return False
    callee = node.func
    name = (
        callee.attr
        if isinstance(callee, ast.Attribute)
        else callee.id
        if isinstance(callee, ast.Name)
        else None
    )
    dotted = project.resolve_dotted(mod, callee) or ""
    if (
        dotted in contracts.FORCE_HELPERS
        or name in contracts.FORCE_HELPER_NAMES
    ):
        return True
    # os.environ.setdefault("BYTEWAX_TPU_PLATFORM", ...) and
    # os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    if name in ("setdefault", "pop") and dotted.endswith(
        f"os.environ.{name}"
    ):
        first = node.args[0] if node.args else None
        if (
            isinstance(first, ast.Constant)
            and first.value in contracts.FORCE_ENV_KEYS
        ):
            return True
    return False


def _risky_call(
    project: Project, mod: Module, node: ast.AST
) -> Optional[str]:
    """The reason this statement can start the device tier's
    runtime."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        callee = sub.func
        name = (
            callee.attr
            if isinstance(callee, ast.Attribute)
            else callee.id
            if isinstance(callee, ast.Name)
            else None
        )
        if name is None:
            continue
        dotted = project.resolve_dotted(mod, callee) or ""
        if (
            dotted in contracts.RUN_ENTRY_POINTS
            or name in contracts.RUN_ENTRY_NAMES
        ):
            return f"run entry point {name}()"
        if dotted in contracts.RUNTIME_STARTERS:
            return f"torch.distributed call {dotted}()"
        if (
            dotted.startswith(contracts.TORCH_CUDA_PREFIX)
            and dotted not in contracts.TORCH_CUDA_PROBES
        ):
            return f"torch.cuda call {dotted}()"
    return None


_COMPOUND = (ast.If, ast.For, ast.While, ast.With, ast.Try)


def _walk_exec(statements, project, mod, state, out):
    """Walk executable statements in program order; ``state`` is a
    one-element list holding the 'forced yet?' flag.  Compound
    statements (the ``__main__`` guard, try/with/for blocks) recurse
    branch-by-branch with a branch-local copy of the flag: forcing
    inside a branch covers the rest of THAT branch, but only counts
    for statements after the compound when every branch forced (an
    ``if`` without ``else`` has an implicit empty branch, and loop
    bodies may run zero times — neither guarantees anything)."""
    for stmt in statements:
        if isinstance(
            stmt,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            continue  # definitions don't execute their bodies
        if isinstance(stmt, _COMPOUND):
            branches = []
            for field in ("body", "orelse"):
                sub = getattr(stmt, field, None)
                if sub:
                    branch_state = [state[0]]
                    _walk_exec(sub, project, mod, branch_state, out)
                    branches.append(branch_state[0])
                elif isinstance(stmt, ast.If) and field == "orelse":
                    branches.append(state[0])  # implicit empty else
            for handler in getattr(stmt, "handlers", ()):
                branch_state = [state[0]]
                _walk_exec(
                    handler.body, project, mod, branch_state, out
                )
                branches.append(branch_state[0])
            final = getattr(stmt, "finalbody", None)
            if isinstance(stmt, (ast.If, ast.With)) and branches:
                # `with` has exactly one always-run body; `if` forces
                # only when every branch (incl. the implicit else)
                # forced.
                state[0] = all(branches)
            if final:
                # finally always runs; its forcing carries forward.
                _walk_exec(final, project, mod, state, out)
            continue
        if _is_forcing(project, mod, stmt) or (
            isinstance(stmt, ast.Expr)
            and _is_forcing(project, mod, stmt.value)
        ):
            state[0] = True
            continue
        if not state[0]:
            reason = _risky_call(project, mod, stmt)
            if reason is not None:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        stmt.lineno,
                        f"standalone script reaches {reason} with no "
                        "platform chosen first; set, setdefault or "
                        "pop BYTEWAX_TPU_PLATFORM, or call "
                        "force_platform()/force_cpu_mesh(), before it "
                        "(the device tier otherwise runs wherever an "
                        "inherited BYTEWAX_TPU_PLATFORM points)",
                    )
                )
                state[0] = True  # one finding per script is enough


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for mod in project.modules.values():
        if not mod.is_script:
            continue
        _walk_exec(mod.tree.body, project, mod, [False], out)
    return out
