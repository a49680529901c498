"""Flatten a nested operator tree into the 9-core-operator plan.

The reference does this reflectively in the engine with a build stack
(upstream bytewax ``src/worker.rs:255-497``); here it is a plain
recursive walk producing a topologically-ordered list of core
operators plus stream wiring tables.
"""

from typing import Dict, List, Optional, Tuple

from bytewax_tpu_torch.dataflow import Dataflow, DataflowError, Operator

__all__ = ["Plan", "flatten"]


def _find_core_stateful(op: Operator) -> Optional[Operator]:
    for sub in op.substeps:
        if sub.core and sub.name == "stateful_batch":
            return sub
        found = _find_core_stateful(sub)
        if found is not None:
            return found
    return None


def _annotate_accel(op: Operator) -> None:
    """Lowering pass: recognize aggregation shapes and annotate their
    core ``stateful_batch`` with a device spec so the driver folds
    them on device instead of per-key Python logics.

    Keyed aggregations (``reduce_final`` with a marked reducer,
    ``stats_final``) are the shapes the port lowers so far; scans,
    inference and windows run on the host tier.
    """
    from bytewax_tpu_torch.engine.xla import AccelSpec
    from bytewax_tpu_torch.xla import Reducer

    spec = None
    if op.name == "reduce_final" and isinstance(op.conf.get("reducer"), Reducer):
        spec = AccelSpec(op.conf["reducer"].kind)
    elif op.name == "stats_final":
        spec = AccelSpec("stats")
    if spec is not None:
        inner = _find_core_stateful(op)
        if inner is not None:
            inner.conf["_accel"] = spec


CORE_OPS = frozenset(
    {
        "_noop",
        "branch",
        "flat_map_batch",
        "input",
        "inspect_debug",
        "merge",
        "output",
        "redistribute",
        "stateful_batch",
    }
)


class Plan:
    """Execution plan: core ops in topological order + stream wiring."""

    def __init__(self, flow: Dataflow):
        self.flow = flow
        self.ops: List[Operator] = []
        #: stream_id -> index of producing core op in ``ops``
        self.producer: Dict[str, int] = {}
        #: stream_id -> [(consumer op index, port name)]
        self.consumers: Dict[str, List[Tuple[int, str]]] = {}

    def up_stream_ids(self, op: Operator) -> List[str]:
        return [s.stream_id for s in op.up_streams()]


def _walk(op: Operator, plan: Plan) -> None:
    if op.core:
        if op.name not in CORE_OPS:
            msg = f"unknown core operator {op.name!r} at {op.step_id!r}"
            raise DataflowError(msg)
        plan.ops.append(op)
    else:
        _annotate_accel(op)
        for sub in op.substeps:
            _walk(sub, plan)


def _index(plan: Plan) -> None:
    plan.producer = {}
    plan.consumers = {}
    for idx, op in enumerate(plan.ops):
        for port, val in op.ups.items():
            streams = [val] if not isinstance(val, list) else val
            for s in streams:
                plan.consumers.setdefault(s.stream_id, []).append((idx, port))
        for s in op.down_streams():
            plan.producer[s.stream_id] = idx


#: Core ops a columnar batch passes through (possibly transformed but
#: still batch-granular) on its way to a device-tier consumer.  Used
#: by the ingest reachability pass below; branch/inspect itemize but
#: still forward, so they stay transparent for reachability.
_BATCH_TRANSPARENT = frozenset(
    {
        "_noop",
        "branch",
        "flat_map_batch",
        "inspect_debug",
        "merge",
        "redistribute",
    }
)


def _annotate_accel_bound(plan: Plan) -> None:
    """Ingest-plumbing pass: mark each core ``input`` op whose stream
    reaches a device-annotated ``stateful_batch`` through batch-
    transparent ops with ``_accel_bound``.  The driver arms adaptive
    micro-batch coalescing (engine/batching.py) for those inputs by
    default — re-batching trickle sources into device-sized
    micro-batches pays exactly when a dispatch is being amortized.
    Deterministic (plan order), so every cluster process agrees."""
    for op in plan.ops:
        if op.name != "input":
            continue
        seen: set = set()
        frontier = [s.stream_id for s in op.down_streams()]
        bound = False
        while frontier and not bound:
            sid = frontier.pop()
            if sid in seen:
                continue
            seen.add(sid)
            for ci, _port in plan.consumers.get(sid, []):
                consumer = plan.ops[ci]
                spec = (
                    consumer.conf.get("_accel")
                    if consumer.name == "stateful_batch"
                    else None
                )
                if spec is not None:
                    # Session windows merge by inter-batch arrival
                    # grouping, so re-batching would change their
                    # window metadata — they never arm coalescing.
                    if type(spec).__name__ != "SessionAccelSpec":
                        bound = True
                        break
                if consumer.name in _BATCH_TRANSPARENT:
                    frontier.extend(
                        s.stream_id for s in consumer.down_streams()
                    )
        op.conf["_accel_bound"] = bound


def _prune_dead_taps(plan: Plan) -> None:
    """Drop core steps marked ``_prunable`` (pure internal shims —
    the window operator's unwrap taps) whose output streams have no
    consumer: they can never affect anything observable, and a live
    tap costs a per-event Python pass.  Iterates because dropping a
    tap can orphan another prunable step upstream.  Deterministic
    (tree order), so every cluster process prunes identically."""
    while True:
        dead = [
            op
            for op in plan.ops
            if op.conf.get("_prunable")
            and all(
                not plan.consumers.get(s.stream_id)
                for s in op.down_streams()
            )
        ]
        if not dead:
            return
        drop = set(map(id, dead))
        plan.ops = [op for op in plan.ops if id(op) not in drop]
        _index(plan)


def flatten(flow: Dataflow) -> Plan:
    """Flatten the operator tree; validate ≥1 input and ≥1 output
    (reference parity: ``src/worker.rs:474-483``)."""
    plan = Plan(flow)
    for op in flow.substeps:
        _walk(op, plan)
    _index(plan)
    _prune_dead_taps(plan)
    _annotate_accel_bound(plan)
    names = {op.name for op in plan.ops}
    if "input" not in names:
        msg = (
            f"dataflow {flow.flow_id!r} needs at least one input step; "
            "add an `bytewax_tpu_torch.operators.input` step"
        )
        raise DataflowError(msg)
    if "output" not in names:
        msg = (
            f"dataflow {flow.flow_id!r} needs at least one output step; "
            "add an `bytewax_tpu_torch.operators.output` step"
        )
        raise DataflowError(msg)
    return plan
