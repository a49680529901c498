"""BTX-SNAPSHOT — cross-tier recovery stays closed under new tiers.

The driver heals flaky device tiers by demoting a step to the host
tier: ``demotion_snapshots()`` drains the device state as host-format
snapshots that rebuild host logics exactly as a recovery resume
would.  That only works if EVERY state class the device-tier
factories can hand the dispatch table implements it.

For each factory (any project function named in
``contracts.DEVICE_STATE_FACTORY_NAMES`` — today ``make_agg_state``,
``make_scan_state``, and the spec classes' ``make_state``), resolve
the classes its ``return`` statements construct (following
factory→factory calls), then require each class's MRO to provide
``demotion_snapshots`` — unless the class is marked
``global_exchange = True``: the collective tier must NOT demote
per-process (peers would block in the exchange forever; it unwinds
to the supervisor instead), so defining the method there is flagged
too.

The residency surface (``engine/residency.py``) is checked the same
way: a reachable class implementing ``extract_keys`` must implement
``inject_keys`` (an evicted key needs a restore path), and the
``global_exchange = True`` tier must implement neither (per-process
eviction would desynchronize the collective step shapes).
"""

from typing import List

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Project

RULE_ID = "BTX-SNAPSHOT"


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    seen = set()
    for fn in project.iter_functions():
        if fn.name not in contracts.DEVICE_STATE_FACTORY_NAMES:
            continue
        factory_mod = project.modules[fn.module]
        for cid in sorted(project.returned_classes(fn.id)):
            if (fn.id, cid) in seen:
                continue
            seen.add((fn.id, cid))
            ci = project.classes.get(cid)
            if ci is None:
                continue
            cls_mod = project.modules[ci.module]
            is_global = (
                project.class_attr(
                    cid, contracts.GLOBAL_EXCHANGE_ATTR
                )
                is True
            )
            has_method = (
                project.class_method(cid, contracts.DEMOTION_METHOD)
                is not None
            )
            if is_global and has_method:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        cls_mod.rel,
                        ci.node.lineno,
                        f"{ci.name} is marked global_exchange=True "
                        f"but defines {contracts.DEMOTION_METHOD}(); "
                        "the collective tier must never demote "
                        "per-process (peers would block in the "
                        "exchange) — it unwinds to the supervisor",
                    )
                )
            elif not is_global and not has_method:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        cls_mod.rel,
                        ci.node.lineno,
                        f"device-tier state class {ci.name} "
                        f"(returned by {fn.qualname} in "
                        f"{factory_mod.rel}) implements no "
                        f"{contracts.DEMOTION_METHOD}(); demotion "
                        "would strand its state on a faulted device "
                        "— implement it (cross-tier snapshot "
                        "interchange, docs/recovery.md) or mark the "
                        "class global_exchange = True if it is a "
                        "collective tier",
                    )
                )
            # Residency pairing (docs/state-residency.md): the
            # eviction half without the restore half strands every
            # extracted key, and the collective tier must expose
            # neither (a per-process eviction there desynchronizes
            # the collective step shapes cluster-wide).
            has_extract = (
                project.class_method(cid, contracts.RESIDENCY_EXTRACT)
                is not None
            )
            has_inject = (
                project.class_method(cid, contracts.RESIDENCY_INJECT)
                is not None
            )
            if is_global and (has_extract or has_inject):
                out.append(
                    Diagnostic(
                        RULE_ID,
                        cls_mod.rel,
                        ci.node.lineno,
                        f"{ci.name} is marked global_exchange=True "
                        "but implements the residency surface "
                        f"({contracts.RESIDENCY_EXTRACT}/"
                        f"{contracts.RESIDENCY_INJECT}); the "
                        "collective tier must never evict "
                        "per-process — eviction would desynchronize "
                        "the collective step shapes",
                    )
                )
            elif not is_global and has_extract and not has_inject:
                out.append(
                    Diagnostic(
                        RULE_ID,
                        cls_mod.rel,
                        ci.node.lineno,
                        f"device-tier state class {ci.name} "
                        f"implements {contracts.RESIDENCY_EXTRACT}() "
                        f"but no {contracts.RESIDENCY_INJECT}(); an "
                        "evicted key would have no restore path — "
                        "implement the inject half (cross-tier "
                        "snapshot interchange, "
                        "docs/state-residency.md)",
                    )
                )
    return out
