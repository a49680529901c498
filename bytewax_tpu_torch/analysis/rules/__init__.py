"""Rule registry: one module per engine contract.

Each rule module exposes ``RULE_ID`` and ``check(project) ->
List[Diagnostic]``.  Register new rules here; catalog them in
``docs/contracts.md`` (``tests/test_torch_static_contracts.py`` pins that
the doc catalog lists exactly these ids).

The resolved call graph is built once per project
(:meth:`Project.adjacency`, cached) and shared by every reachability
rule; ``run_rules`` primes it before dispatching so per-rule timings
measure rule logic, not graph construction.
"""

import time
from typing import Callable, Dict, List, Optional

from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Project
from bytewax_tpu_torch.analysis.rules import (
    backend,
    drain,
    fault,
    frames,
    gsync,
    knobs,
    send,
    snapshot,
    thread,
)
from bytewax_tpu_torch.analysis.rules import lane, race  # noqa: E402 — import
# after thread: both walk the worker lane it discovers.

__all__ = ["ALL_RULES", "run_rules"]

ALL_RULES: Dict[str, Callable[[Project], List[Diagnostic]]] = {
    send.RULE_ID: send.check,
    gsync.RULE_ID: gsync.check,
    frames.RULE_ID: frames.check,
    fault.RULE_ID: fault.check,
    snapshot.RULE_ID: snapshot.check,
    backend.RULE_ID: backend.check,
    drain.RULE_ID: drain.check,
    thread.RULE_ID: thread.check,
    knobs.RULE_ID: knobs.check,
    lane.RULE_ID: lane.check,
    race.RULE_ID: race.check,
}


def run_rules(
    project: Project,
    rule_ids=None,
    timings: Optional[Dict[str, float]] = None,
) -> List[Diagnostic]:
    """Run the requested rules (all by default).  When ``timings``
    is a dict it is filled with per-rule wall seconds (plus the
    shared call-graph build under ``"<call-graph>"``)."""
    wanted = list(ALL_RULES) if rule_ids is None else list(rule_ids)
    checkers = []
    for rid in wanted:
        try:
            checkers.append((rid, ALL_RULES[rid]))
        except KeyError:
            raise KeyError(
                f"unknown rule {rid!r}; known: {sorted(ALL_RULES)}"
            ) from None
    t0 = time.perf_counter()
    project.adjacency()  # build the shared call graph once
    if timings is not None:
        timings["<call-graph>"] = time.perf_counter() - t0
    out: List[Diagnostic] = []
    for rid, checker in checkers:
        t0 = time.perf_counter()
        out.extend(checker(project))
        if timings is not None:
            timings[rid] = time.perf_counter() - t0
    return sorted(out, key=Diagnostic.sort_key)
