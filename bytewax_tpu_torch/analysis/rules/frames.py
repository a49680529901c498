"""BTX-FRAMES — the control-frame kind inventory is closed.

The clustered driver's ``_handle_ctrl`` dispatcher and every literal
frame tuple it sends must agree with the pinned inventory
(``contracts.CONTROL_FRAMES``).  Adding a frame kind is a protocol
change: data frames must stay counted (``deliver``/``route``) and
everything else must be legal at the protocol point it arrives at,
or the count-matched epoch barrier / gsync ordering silently breaks.

Checks (AST, not regex):

- handled kinds: every ``kind == "..."`` comparison in a
  ``_handle_ctrl`` body, cross-checked both ways against the pinned
  inventory;
- sent kinds: the payload of every raw send — ``send(dest, (KIND,
  ...))`` / ``broadcast((KIND, ...))`` — must be a pinned kind;
- in a module that defines ``_handle_ctrl`` (the driver), a raw send
  whose payload is not a literal tuple is flagged as statically
  unverifiable (the comm layer's pass-through forwarding is exempt:
  it defines no dispatcher).
"""

import ast
from typing import List, Set

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Project
from bytewax_tpu_torch.analysis.rules._util import comm_receiver_events

RULE_ID = "BTX-FRAMES"


def _handled_kinds(fn_node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Compare):
            continue
        if not (
            isinstance(node.left, ast.Name)
            and node.left.id == "kind"
            and len(node.ops) == 1
            and isinstance(node.ops[0], ast.Eq)
        ):
            continue
        comp = node.comparators[0]
        if isinstance(comp, ast.Constant) and isinstance(
            comp.value, str
        ):
            out.add(comp.value)
    return out


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    inventory = contracts.CONTROL_FRAMES

    for mod in project.modules.values():
        dispatcher = None
        for fn in mod.functions.values():
            if fn.name == contracts.FRAME_DISPATCHER:
                dispatcher = fn
        if dispatcher is not None:
            handled = _handled_kinds(dispatcher.node)
            extra = sorted(handled - inventory)
            gone = sorted(inventory - handled)
            if extra or gone:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        dispatcher.node.lineno,
                        f"{dispatcher.qualname} frame inventory "
                        "drifted from contracts.CONTROL_FRAMES "
                        f"(new: {extra}, gone: {gone}); update the "
                        "inventory AND re-check the barrier/gsync "
                        "contract in docs/contracts.md",
                    )
                )

        for fn in mod.functions.values():
            if fn.nested:
                continue  # enclosing body walk already covers these
            for kind, call in comm_receiver_events(project, mod, fn):
                if kind != "raw_send":
                    continue
                is_broadcast = (
                    isinstance(call.func, ast.Attribute)
                    and call.func.attr == "broadcast"
                )
                idx = 0 if is_broadcast else 1
                if len(call.args) <= idx:
                    continue
                payload = call.args[idx]
                if isinstance(payload, ast.Tuple) and payload.elts:
                    first = payload.elts[0]
                    if isinstance(first, ast.Constant) and isinstance(
                        first.value, str
                    ):
                        if first.value not in inventory:
                            out.append(
                                Diagnostic(
                                    RULE_ID,
                                    mod.rel,
                                    call.lineno,
                                    f"frame kind {first.value!r} sent "
                                    f"in {fn.qualname} is not in the "
                                    "pinned contracts.CONTROL_FRAMES "
                                    "inventory",
                                )
                            )
                        continue
                if dispatcher is not None:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            mod.rel,
                            call.lineno,
                            f"raw send in {fn.qualname} ships a "
                            "payload whose frame kind is not a "
                            "literal tuple — the frame inventory "
                            "cannot be verified statically",
                        )
                    )
    return out
