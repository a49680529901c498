"""BTX-FAULT — the chaos-injection contract.

Three checks grounded in docs/recovery.md:

- **Site inventory** — every ``faults.fire(<site>)`` call site names
  a site in the pinned inventory (``contracts.FAULT_SITES``), the
  site argument is a string literal (a computed site evades the
  inventory), and the inventory equals the ``SITES`` tuple in
  ``engine/faults.py`` itself (drift detection in both directions).
- **No traffic** — ``engine/faults.py`` may drop/delay/raise at comm
  sites but must never originate traffic: a fault that *sends* would
  bypass the counted surfaces and corrupt the barrier under test.
- **Fire-before-mutate** — on the device-dispatch path a
  :class:`DeviceFault` is only retryable because no device state has
  mutated yet; in any function that fires the ``device_dispatch``
  site, the ``fire()`` call must precede the first device-state
  mutator call (``contracts.DEVICE_MUTATORS``) — and, since the
  dispatch pipeline (``engine/pipeline.py``) indirects device phases
  through ``make_room``/``push``, the check is also *reachability*:
  a call lexically before the fire may not transitively reach a
  mutator through the project call graph (bounded by
  ``contracts.FAULT_REACH_DEPTH``), so routing a fold through a new
  helper module cannot hide the ordering.
"""

import ast
from typing import List, Optional, Tuple

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Project, body_walk
from bytewax_tpu_torch.analysis.rules._util import const_str_arg

RULE_ID = "BTX-FAULT"


def _fire_calls(project, mod, fn):
    """(call, site_or_None) for calls resolving to faults.fire."""
    for call in fn.calls:
        if call.name != "fire":
            continue
        resolved = call.dotted == contracts.FAULT_FIRE or any(
            t == f"{contracts.FAULTS_MODULE}:fire"
            for t in call.targets
        )
        if resolved:
            yield call, const_str_arg(call.node, 0)


def _mutator_chain(project, call, depth: int) -> Optional[str]:
    """If ``call`` may transitively invoke a device-state mutator,
    return a witness chain (``a -> b -> mutator``); else None.  A
    bounded breadth-first walk over the project call graph — this is
    what lets the rule see through the dispatch pipeline's
    indirection instead of trusting function names lexically."""
    if call.name in contracts.DEVICE_MUTATORS:
        return call.name
    seen = set()
    frontier = [(t, call.name) for t in call.targets]
    for _ in range(depth):
        nxt = []
        for fid, path in frontier:
            if fid in seen:
                continue
            seen.add(fid)
            fn = project.functions.get(fid)
            if fn is None:
                continue
            for sub in fn.calls:
                if sub.name in contracts.DEVICE_MUTATORS:
                    return f"{path} -> {fn.qualname} -> {sub.name}"
                for t in sub.targets:
                    nxt.append((t, f"{path} -> {fn.qualname}"))
        frontier = nxt
        if not frontier:
            break
    return None


def _pinned_sites_of(mod) -> Optional[Tuple[str, ...]]:
    """The ``SITES = (...)`` literal from the faults module AST."""
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "SITES"
            for t in node.targets
        ):
            continue
        if isinstance(node.value, ast.Tuple) and all(
            isinstance(e, ast.Constant) for e in node.value.elts
        ):
            return tuple(e.value for e in node.value.elts)
    return None


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    sites = set(contracts.FAULT_SITES)

    faults_mod = project.modules.get(contracts.FAULTS_MODULE)
    if faults_mod is not None:
        pinned = _pinned_sites_of(faults_mod)
        if pinned is not None and tuple(pinned) != tuple(
            contracts.FAULT_SITES
        ):
            out.append(
                Diagnostic(
                    RULE_ID,
                    faults_mod.rel,
                    1,
                    "faults.SITES drifted from contracts.FAULT_SITES "
                    f"(module: {pinned!r}, contracts: "
                    f"{contracts.FAULT_SITES!r}); update both "
                    "together and re-check docs/recovery.md",
                )
            )
        # The injector may never originate traffic.
        for fn in faults_mod.functions.values():
            if fn.nested:
                continue  # enclosing body walk already covers these
            for node in body_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = node.func
                name = (
                    callee.attr
                    if isinstance(callee, ast.Attribute)
                    else callee.id
                    if isinstance(callee, ast.Name)
                    else None
                )
                if name in ("send", "broadcast", "sendall") or (
                    project.resolve_dotted(faults_mod, callee)
                    == contracts.COMM_CLASS
                ):
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            faults_mod.rel,
                            node.lineno,
                            f"the fault injector calls {name!r} in "
                            f"{fn.qualname}: faults may drop/delay/"
                            "raise but must never originate traffic "
                            "(it would bypass the counted send "
                            "surfaces and corrupt the barrier under "
                            "test)",
                        )
                    )

    for mod in project.modules.values():
        for fn in mod.functions.values():
            if fn.nested:
                continue  # enclosing body walk already covers these
            fires = list(_fire_calls(project, mod, fn))
            for call, site in fires:
                if site is None:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            mod.rel,
                            call.lineno,
                            f"faults.fire in {fn.qualname} takes a "
                            "non-literal site name; sites must be "
                            "string literals from contracts."
                            "FAULT_SITES so the inventory stays "
                            "closed",
                        )
                    )
                elif site not in sites:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            mod.rel,
                            call.lineno,
                            f"unknown fault site {site!r} in "
                            f"{fn.qualname}; pinned inventory: "
                            f"{sorted(sites)} (extend contracts."
                            "FAULT_SITES and faults.SITES together)",
                        )
                    )
            # Fire-before-mutate on the device-dispatch path: no call
            # lexically before the fire may be — or transitively
            # reach, e.g. through engine/pipeline.py — a device-state
            # mutator.  Applies to every retryable device-path site
            # (device_dispatch AND residency_restore): their injected
            # DeviceFault is only retryable because no device state
            # has mutated yet.
            dispatch_fires = [
                call
                for call, site in fires
                if site in contracts.FAULT_DEVICE_SITES
            ]
            if not dispatch_fires:
                continue
            fire_pos = min(
                (c.lineno, c.col) for c in dispatch_fires
            )
            for call in fn.calls:
                if (call.lineno, call.col) >= fire_pos:
                    continue
                chain = _mutator_chain(
                    project, call, contracts.FAULT_REACH_DEPTH
                )
                if chain is not None:
                    out.append(
                        Diagnostic(
                            RULE_ID,
                            mod.rel,
                            call.lineno,
                            f"{fn.qualname} may mutate device state "
                            f"(via {chain}) before firing the "
                            "device_dispatch fault site; a "
                            "DeviceFault is only retryable/demotable "
                            "because no device state has mutated yet",
                        )
                    )
    return out
