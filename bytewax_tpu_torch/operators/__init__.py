"""Built-in operators.

The engine only interprets the **core** operators (marked
``@operator(_core=True)``): ``branch``, ``flat_map_batch``, ``input``,
``inspect_debug``, ``merge``, ``output``, ``redistribute``,
``stateful_batch``, and ``_noop``.  Everything else here is pure composition
on top of those, so it runs identically on the host tier and on the XLA tier.

API parity with the reference operator library
(upstream bytewax ``pysrc/bytewax/operators/__init__.py``); implementations are
our own.
"""

import copy
import itertools
from abc import ABC, abstractmethod
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    Iterable,
    List,
    Optional,
    Tuple,
    TypeVar,
)

from typing_extensions import Literal, TypeAlias

from bytewax_tpu_torch.dataflow import (
    Dataflow,
    KeyedStream,
    Stream,
    f_repr,
    operator,
    _new_stream,
)
from bytewax_tpu_torch.inputs import Source
from bytewax_tpu_torch.outputs import Sink

X = TypeVar("X")
Y = TypeVar("Y")
V = TypeVar("V")
W = TypeVar("W")
S = TypeVar("S")
DK = TypeVar("DK")
DV = TypeVar("DV")

_EMPTY: Tuple = ()


def _identity(x: X) -> X:
    return x


def _get_system_utc() -> datetime:
    return datetime.now(timezone.utc)


def _unpack_kv(step_id: str, k_v: Any) -> Tuple[str, Any]:
    """Unpack an upstream ``(key, value)`` 2-tuple with the shared
    keyed-operator error wording."""
    try:
        k, v = k_v
    except TypeError as ex:
        msg = (
            f"step {step_id!r} requires (key, value) 2-tuple from "
            f"upstream; got a {type(k_v)!r} instead"
        )
        raise TypeError(msg) from ex
    return k, v


def _untyped_none() -> Any:
    return None


# --------------------------------------------------------------------------
# Core operators
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BranchOut(Generic[X, Y]):
    """Streams returned from :func:`branch`.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSource
    >>> flow = Dataflow("branch_out_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2]))
    >>> b = op.branch("split", s, lambda x: x > 1)
    >>> type(b.trues).__name__, type(b.falses).__name__
    ('Stream', 'Stream')
    """

    trues: Stream[X]
    falses: Stream[Y]


@operator(_core=True)
def branch(
    step_id: str,
    up: Stream[X],
    predicate: Callable[[X], bool],
) -> BranchOut:
    """Divide items into two streams with a predicate.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("branch_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2, 3, 4]))
    >>> b = op.branch("evens", s, lambda x: x % 2 == 0)
    >>> evens, odds = [], []
    >>> op.output("ev", b.trues, TestingSink(evens))
    >>> op.output("od", b.falses, TestingSink(odds))
    >>> run_main(flow)
    >>> (evens, odds)
    ([2, 4], [1, 3])

    Reference parity: ``operators/__init__.py:119`` /
    ``src/operators.rs:34-100``.

    :arg step_id: Unique ID.
    :arg up: Stream to divide.
    :arg predicate: Returns a truthy value to route an item to
        ``trues``, falsy to ``falses``.
    :returns: :class:`BranchOut` with ``trues`` and ``falses`` streams.
    """
    if not callable(predicate):
        msg = f"predicate of branch {step_id!r} must be callable"
        raise TypeError(msg)
    return BranchOut(trues=_new_stream("trues"), falses=_new_stream("falses"))


@operator(_core=True)
def flat_map_batch(
    step_id: str,
    up: Stream[X],
    mapper: Callable[[List[X]], Iterable[Y]],
    *,
    _prunable: bool = False,
) -> Stream[Y]:
    """Transform an entire batch of items 1-to-many.

    This is the lowest-level stateless transform; all ``map``-family
    operators lower to it.  On the XLA tier, batches whose mapper is
    jax-traceable are fused into the compiled step.

    ``_prunable`` (internal) marks the step as a pure shim the
    flatten pass may drop when its output is never consumed; only
    set it for mappers with no side effects.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("flat_map_batch_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2, 3]))
    >>> s = op.flat_map_batch("double", s, lambda xs: [x * 2 for x in xs])
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [2, 4, 6]

    Reference parity: ``operators/__init__.py:179`` /
    ``src/operators.rs:122-228``.
    """
    if not callable(mapper):
        msg = f"mapper of flat_map_batch {step_id!r} must be callable"
        raise TypeError(msg)
    return _new_stream("down")


@operator(_core=True)
def input(  # noqa: A001
    step_id: str,
    flow: Dataflow,
    source: Source[X],
) -> Stream[X]:
    """Introduce items into a dataflow from a source.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("input_eg")
    >>> s = op.input("inp", flow, TestingSource(["a", "b"]))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    ['a', 'b']

    Reference parity: ``operators/__init__.py:240`` /
    ``src/inputs.rs:449-858``.
    """
    if not isinstance(source, Source):
        msg = f"source of input {step_id!r} must be a Source; got {source!r}"
        raise TypeError(msg)
    return _new_stream("down")


def _default_debug_inspector(step_id: str, item: Any, epoch: int, worker: int) -> None:
    print(f"{step_id} W{worker} @{epoch}: {item!r}", flush=True)


@operator(_core=True)
def inspect_debug(
    step_id: str,
    up: Stream[X],
    inspector: Callable[[str, X, int, int], None] = _default_debug_inspector,
) -> Stream[X]:
    """Observe items, their epoch, and worker.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("inspect_debug_eg")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> s = op.inspect_debug("dbg", s)
    >>> op.output("out", s, TestingSink([]))
    >>> run_main(flow)
    inspect_debug_eg.dbg W0 @1: 1

    Reference parity: ``operators/__init__.py:296`` /
    ``src/operators.rs:230-317``.
    """
    return _new_stream("down")


@operator(_core=True)
def merge(step_id: str, *ups: Stream[X]) -> Stream[X]:
    """Combine multiple streams together.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("merge_eg")
    >>> ones = op.input("ones", flow, TestingSource([1, 2]))
    >>> tens = op.input("tens", flow, TestingSource([10, 20]))
    >>> s = op.merge("merge", ones, tens)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [1, 2, 10, 20]

    Reference parity: ``operators/__init__.py:394`` /
    ``src/operators.rs:319-343``.
    """
    if len(ups) < 1:
        msg = f"merge {step_id!r} requires at least one upstream"
        raise TypeError(msg)
    return _new_stream("down")


@operator(_core=True)
def output(step_id: str, up: Stream[X], sink: Sink[X]) -> None:
    """Write items out of a dataflow into a sink.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("output_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2]))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1, 2]

    Reference parity: ``operators/__init__.py:449`` /
    ``src/outputs.rs:200-589``.
    """
    if not isinstance(sink, Sink):
        msg = f"sink of output {step_id!r} must be a Sink; got {sink!r}"
        raise TypeError(msg)
    return None


@operator(_core=True)
def redistribute(step_id: str, up: Stream[X]) -> Stream[X]:
    """Redistribute items randomly across all workers.

    With a single worker this is a passthrough; in a cluster it
    round-robins batches across lanes to rebalance skew.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("redistribute_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2, 3]))
    >>> s = op.redistribute("spread", s)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [1, 2, 3]

    Reference parity: ``operators/__init__.py:497`` /
    ``src/operators.rs:345-361``.
    """
    return _new_stream("down")


@operator(_core=True)
def _noop(step_id: str, up: Stream[X]) -> Stream[X]:
    """No-op passthrough; used to enforce stream identity boundaries."""
    return _new_stream("down")


class StatefulBatchLogic(ABC, Generic[V, W, S]):
    """Abstract logic for :func:`stateful_batch`, the stateful engine
    primitive.

    One instance exists per key; the engine guarantees all values for a
    key are routed to the same instance in epoch order.

    Reference parity: ``operators/__init__.py:593`` /
    ``src/operators.rs:441-1041``.
    """

    #: Return as the second value to keep the logic for this key.
    RETAIN: bool = False
    #: Return as the second value to discard the logic for this key.
    DISCARD: bool = True

    @abstractmethod
    def on_batch(self, values: List[V]) -> Tuple[Iterable[W], bool]:
        """Called with all values for this key arriving in a batch.

        :returns: ``(emit_values, is_complete)``.
        """
        ...

    def on_notify(self) -> Tuple[Iterable[W], bool]:
        """Called when the scheduled notification time has passed."""
        return (_EMPTY, StatefulBatchLogic.RETAIN)

    def on_eof(self) -> Tuple[Iterable[W], bool]:
        """Called once the upstream is EOF for this execution.

        This will not be called on recovery resume; state is retained
        unless you return DISCARD.
        """
        return (_EMPTY, StatefulBatchLogic.RETAIN)

    def notify_at(self) -> Optional[datetime]:
        """Next system time this logic wants :meth:`on_notify` called."""
        return None

    @abstractmethod
    def snapshot(self) -> S:
        """Return an immutable copy of the state for recovery."""
        ...


@operator(_core=True)
def stateful_batch(
    step_id: str,
    up: KeyedStream[V],
    builder: Callable[[Optional[S]], StatefulBatchLogic[V, W, S]],
) -> KeyedStream[W]:
    """Advanced generic stateful operator.

    Keys are hash-routed to a home worker (chip shard on the XLA tier);
    ``builder`` is called with ``None`` for new keys or the resume
    snapshot on recovery.

    A running-total logic, snapshotting its sum for recovery:

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> class RunningTotal(op.StatefulBatchLogic):
    ...     def __init__(self, resume_state):
    ...         self.total = resume_state if resume_state is not None else 0
    ...     def on_batch(self, values):
    ...         self.total += sum(values)
    ...         return ([self.total], op.StatefulBatchLogic.RETAIN)
    ...     def snapshot(self):
    ...         return self.total
    >>> flow = Dataflow("stateful_batch_eg")
    >>> inp = [("a", 1), ("a", 2), ("b", 10)]
    >>> s = op.input("inp", flow, TestingSource(inp))
    >>> s = op.stateful_batch("total", s, RunningTotal)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [('a', 1), ('a', 3), ('b', 10)]

    Reference parity: ``operators/__init__.py:795`` /
    ``src/operators.rs:441-1041``.
    """
    if not callable(builder):
        msg = f"builder of stateful_batch {step_id!r} must be callable"
        raise TypeError(msg)
    return _new_stream("down")


# --------------------------------------------------------------------------
# Stateful per-item sugar
# --------------------------------------------------------------------------


class StatefulLogic(ABC, Generic[V, W, S]):
    """Abstract logic for :func:`stateful`; per-item flavor of
    :class:`StatefulBatchLogic`.

    Reference parity: ``operators/__init__.py:918``.
    """

    RETAIN: bool = False
    DISCARD: bool = True

    @abstractmethod
    def on_item(self, value: V) -> Tuple[Iterable[W], bool]:
        """Called on each new upstream item."""
        ...

    def on_notify(self) -> Tuple[Iterable[W], bool]:
        return (_EMPTY, StatefulLogic.RETAIN)

    def on_eof(self) -> Tuple[Iterable[W], bool]:
        return (_EMPTY, StatefulLogic.RETAIN)

    def notify_at(self) -> Optional[datetime]:
        return None

    @abstractmethod
    def snapshot(self) -> S:
        ...


@dataclass
class _StatefulShim(StatefulBatchLogic[V, W, S]):
    builder: Callable[[Optional[S]], StatefulLogic[V, W, S]]
    logic: Optional[StatefulLogic[V, W, S]]

    def on_batch(self, values: List[V]) -> Tuple[Iterable[W], bool]:
        emits: List[W] = []
        extend = emits.extend
        builder = self.builder
        logic = self.logic
        for v in values:
            # A mid-batch discard must not drop the remaining values
            # for the key: rebuild fresh logic and keep going (the
            # reference does the same: operators/__init__.py:1030-1042).
            if logic is None:
                logic = builder(None)
            vs, is_complete = logic.on_item(v)
            # Identity check, not truthiness: `vs` may be any
            # iterable (a numpy array is ambiguous under bool()).
            if vs is not _EMPTY:
                extend(vs)
            if is_complete:
                logic = None
        self.logic = logic
        if logic is None:
            return (emits, StatefulBatchLogic.DISCARD)
        return (emits, StatefulBatchLogic.RETAIN)

    def on_notify(self) -> Tuple[Iterable[W], bool]:
        assert self.logic is not None
        return self.logic.on_notify()

    def on_eof(self) -> Tuple[Iterable[W], bool]:
        assert self.logic is not None
        return self.logic.on_eof()

    def notify_at(self) -> Optional[datetime]:
        assert self.logic is not None
        return self.logic.notify_at()

    def snapshot(self) -> S:
        assert self.logic is not None
        return self.logic.snapshot()


@operator
def stateful(
    step_id: str,
    up: KeyedStream[V],
    builder: Callable[[Optional[S]], StatefulLogic[V, W, S]],
) -> KeyedStream[W]:
    """Advanced per-item stateful operator.

    A logic that passes each value through and discards its per-key
    state after every item (so each item builds a fresh logic):

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> class FirstOnly(op.StatefulLogic):
    ...     def __init__(self, resume_state):
    ...         pass
    ...     def on_item(self, value):
    ...         return ([value], op.StatefulLogic.DISCARD)
    ...     def snapshot(self):
    ...         return None
    >>> flow = Dataflow("stateful_eg")
    >>> inp = [("a", "x"), ("a", "y"), ("b", "z")]
    >>> s = op.input("inp", flow, TestingSource(inp))
    >>> s = op.stateful("first", s, FirstOnly)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [('a', 'x'), ('a', 'y'), ('b', 'z')]

    (Each ``DISCARD`` drops the key's logic, so the next item for that
    key builds a fresh one — retaining with ``RETAIN`` and emitting
    nothing on later items would dedupe instead.)

    Reference parity: ``operators/__init__.py:1065``.
    """

    def shim_builder(resume_state: Optional[S]) -> _StatefulShim[V, W, S]:
        return _StatefulShim(builder, builder(resume_state))

    shim_builder.__wrapped__ = builder
    return stateful_batch("stateful_batch", up, shim_builder)


# --------------------------------------------------------------------------
# Stateless sugar
# --------------------------------------------------------------------------


def _per_item(shim: Callable[[List[X]], Iterable[Y]]) -> Callable:
    """Mark a ``flat_map_batch`` shim as genuinely per-item: a
    columnar ``ArrayBatch`` reaching it itemizes (``to_pylist``)
    before the shim runs.  This is the host-tier contact point the
    batch-native ingest protocol itemizes at — batch-level shims that
    can consume columns directly (e.g. ``count_final``'s keying) pass
    themselves unwrapped instead."""

    def per_item_shim(xs: Any) -> Iterable[Y]:
        from bytewax_tpu_torch.engine.arrays import ArrayBatch as _AB

        if isinstance(xs, _AB):
            xs = xs.to_pylist()
        return shim(xs)

    per_item_shim.__wrapped__ = shim
    return per_item_shim


@operator
def flat_map(
    step_id: str,
    up: Stream[X],
    mapper: Callable[[X], Iterable[Y]],
) -> Stream[Y]:
    """Transform items one-to-many.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("flat_map_eg")
    >>> s = op.input("inp", flow, TestingSource(["hello world"]))
    >>> s = op.flat_map("split", s, str.split)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    ['hello', 'world']

    Reference parity: ``operators/__init__.py:1460``.
    """

    def shim_mapper(xs: List[X]) -> Iterable[Y]:
        return itertools.chain.from_iterable(mapper(x) for x in xs)

    shim_mapper.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def flat_map_value(
    step_id: str,
    up: KeyedStream[V],
    mapper: Callable[[V], Iterable[W]],
) -> KeyedStream[W]:
    """Transform values one-to-many.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("flat_map_value_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", "a b")]))
    >>> s = op.flat_map_value("split", s, str.split)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 'a'), ('k', 'b')]

    Reference parity: ``operators/__init__.py:1526``.
    """

    def shim_mapper(k_vs: List[Tuple[str, V]]) -> List[Tuple[str, W]]:
        out = []
        for k_v in k_vs:
            k, v = _unpack_kv(step_id, k_v)
            for w in mapper(v):
                out.append((k, w))
        return out

    shim_mapper.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def flatten(
    step_id: str,
    up: Stream[Iterable[X]],
) -> Stream[X]:
    """Move all sub-items up a level.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("flatten_eg")
    >>> s = op.input("inp", flow, TestingSource([[1, 2], [3]]))
    >>> s = op.flatten("flat", s)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1, 2, 3]

    Reference parity: ``operators/__init__.py:1593``.
    """

    def shim_mapper(xs: List[Iterable[X]]) -> List[X]:
        out: List[X] = []
        for x in xs:
            if not isinstance(x, Iterable):
                msg = (
                    f"step {step_id!r} requires upstream to be iterables; "
                    f"got a {type(x)!r} instead"
                )
                raise TypeError(msg)
            out.extend(x)
        return out

    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def filter(  # noqa: A001
    step_id: str,
    up: Stream[X],
    predicate: Callable[[X], bool],
) -> Stream[X]:
    """Keep only some items.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("filter_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2, 3, 4]))
    >>> s = op.filter("keep_even", s, lambda x: x % 2 == 0)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [2, 4]

    Reference parity: ``operators/__init__.py:1652``.
    """

    def shim_mapper(xs: List[X]) -> List[X]:
        out = []
        for x in xs:
            keep = predicate(x)
            if not isinstance(keep, bool):
                msg = (
                    f"return value of predicate {f_repr(predicate)} "
                    f"in step {step_id!r} must be a bool; got {keep!r} "
                    "instead"
                )
                raise TypeError(msg)
            if keep:
                out.append(x)
        return out

    shim_mapper.__wrapped__ = predicate
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def filter_value(
    step_id: str,
    up: KeyedStream[V],
    predicate: Callable[[V], bool],
) -> KeyedStream[V]:
    """Keep only some values; keys untouched.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("filter_value_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2)]))
    >>> s = op.filter_value("keep_even", s, lambda v: v % 2 == 0)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 2)]

    Reference parity: ``operators/__init__.py:1726``.
    """

    def shim_mapper(k_vs: List[Tuple[str, V]]) -> List[Tuple[str, V]]:
        out = []
        for k_v in k_vs:
            _k, v = _unpack_kv(step_id, k_v)
            keep = predicate(v)
            if not isinstance(keep, bool):
                msg = (
                    f"return value of predicate {f_repr(predicate)} "
                    f"in step {step_id!r} must be a bool; got {keep!r} "
                    "instead"
                )
                raise TypeError(msg)
            if keep:
                out.append(k_v)
        return out

    shim_mapper.__wrapped__ = predicate
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def filter_map(
    step_id: str,
    up: Stream[X],
    mapper: Callable[[X], Optional[Y]],
) -> Stream[Y]:
    """Transform items one-to-maybe-one; ``None`` is discarded.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("filter_map_eg")
    >>> s = op.input("inp", flow, TestingSource(["1", "x", "3"]))
    >>> s = op.filter_map("to_int", s, lambda x: int(x) if x.isdigit() else None)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1, 3]

    Reference parity: ``operators/__init__.py:1790``.
    """

    def shim_mapper(xs: List[X]) -> List[Y]:
        out = []
        for x in xs:
            y = mapper(x)
            if y is not None:
                out.append(y)
        return out

    shim_mapper.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def filter_map_value(
    step_id: str,
    up: KeyedStream[V],
    mapper: Callable[[V], Optional[W]],
) -> KeyedStream[W]:
    """Transform values one-to-maybe-one; ``None`` is discarded.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("filter_map_value_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", "1"), ("k", "x")]))
    >>> s = op.filter_map_value("to_int", s, lambda v: int(v) if v.isdigit() else None)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 1)]

    Reference parity: ``operators/__init__.py:1860``.
    """

    def shim_mapper(k_vs: List[Tuple[str, V]]) -> List[Tuple[str, W]]:
        out = []
        for k_v in k_vs:
            k, v = _unpack_kv(step_id, k_v)
            w = mapper(v)
            if w is not None:
                out.append((k, w))
        return out

    shim_mapper.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def inspect(
    step_id: str,
    up: Stream[X],
    inspector: Callable[[str, X], None] = None,  # type: ignore[assignment]
) -> Stream[X]:
    """Observe items for debugging; prints by default.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("inspect_eg")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> s = op.inspect("see", s)
    >>> op.output("out", s, TestingSink([]))
    >>> run_main(flow)
    inspect_eg.see: 1

    Reference parity: ``operators/__init__.py:2021``.
    """
    if inspector is None:
        def inspector(i_step_id: str, item: X) -> None:  # noqa: A002
            print(f"{i_step_id}: {item!r}", flush=True)

    def shim_inspector(
        _fq_step_id: str, item: X, _epoch: int, _worker_idx: int
    ) -> None:
        inspector(step_id, item)

    shim_inspector.__wrapped__ = inspector
    return inspect_debug("inspect_debug", up, shim_inspector)


@operator
def key_on(step_id: str, up: Stream[X], key: Callable[[X], str]) -> KeyedStream[X]:
    """Add a key for each item, making a :class:`KeyedStream`.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("key_on_eg")
    >>> s = op.input("inp", flow, TestingSource(["apple", "kiwi"]))
    >>> s = op.key_on("by_first", s, lambda x: x[0])
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('a', 'apple'), ('k', 'kiwi')]

    Reference parity: ``operators/__init__.py:2375``.
    """

    def shim_mapper(xs: List[X]) -> List[Tuple[str, X]]:
        out = []
        for x in xs:
            k = key(x)
            if not isinstance(k, str):
                msg = (
                    f"return value of key function {f_repr(key)} "
                    f"in step {step_id!r} must be a str; got {k!r} instead"
                )
                raise TypeError(msg)
            out.append((k, x))
        return out

    shim_mapper.__wrapped__ = key
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def key_rm(step_id: str, up: KeyedStream[X]) -> Stream[X]:
    """Discard keys.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("key_rm_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2)]))
    >>> s = op.key_rm("unkey", s)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1, 2]

    Reference parity: ``operators/__init__.py:2439``.
    """

    def shim_batch(k_vs: List[Tuple[str, X]]) -> List[X]:
        return [v for _k, v in k_vs]

    return flat_map_batch("flat_map_batch", up, _per_item(shim_batch))


@operator
def map(  # noqa: A001
    step_id: str,
    up: Stream[X],
    mapper: Callable[[X], Y],
) -> Stream[Y]:
    """Transform items one-by-one.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("map_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2, 3]))
    >>> s = op.map("double", s, lambda x: x * 2)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [2, 4, 6]

    Reference parity: ``operators/__init__.py:2497``.
    """

    def shim_mapper(xs: List[X]) -> Iterable[Y]:
        return [mapper(x) for x in xs]

    shim_mapper.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


@operator
def map_value(
    step_id: str,
    up: KeyedStream[V],
    mapper: Callable[[V], W],
) -> KeyedStream[W]:
    """Transform values one-by-one.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("map_value_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2)]))
    >>> s = op.map_value("double", s, lambda v: v * 2)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 2), ('k', 4)]

    Reference parity: ``operators/__init__.py:2557``.
    """

    def shim_mapper(k_v: Tuple[str, V]) -> Tuple[str, W]:
        try:
            k, v = k_v
        except TypeError as ex:
            msg = (
                f"step {step_id!r} requires (key, value) 2-tuple from "
                f"upstream; got a {type(k_v)!r} instead"
            )
            raise TypeError(msg) from ex
        return (k, mapper(v))

    def shim_batch(k_vs: List[Tuple[str, V]]) -> List[Tuple[str, W]]:
        return [shim_mapper(k_v) for k_v in k_vs]

    shim_batch.__wrapped__ = mapper
    return flat_map_batch("flat_map_batch", up, _per_item(shim_batch))


@operator
def raises(step_id: str, up: Stream[Any]) -> None:
    """Raise an exception and crash the dataflow on any item.

    Useful to assert a stream stays empty (e.g. an error branch):

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> flow = Dataflow("raises_eg")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.raises("boom", s)
    >>> try:
    ...     run_main(flow)
    ... except RuntimeError:
    ...     print("crashed")
    crashed

    Reference parity: ``operators/__init__.py:2767``.
    """

    def shim_mapper(x: Any) -> Iterable[Any]:
        msg = f"`raises` step {step_id!r} got an item: {x!r}"
        raise RuntimeError(msg)

    from bytewax_tpu_torch.connectors.stdio import StdOutSink

    nop = flat_map("flat_map", up, shim_mapper)
    return output("output", nop, StdOutSink())


# --------------------------------------------------------------------------
# Keyed aggregation sugar
# --------------------------------------------------------------------------


@dataclass
class _FoldFinalLogic(StatefulLogic[V, S, S]):
    step_id: str
    folder: Callable[[S, V], S]
    state: S

    def on_item(self, value: V) -> Tuple[Iterable[S], bool]:
        self.state = self.folder(self.state, value)
        return (_EMPTY, StatefulLogic.RETAIN)

    def on_eof(self) -> Tuple[Iterable[S], bool]:
        return ((self.state,), StatefulLogic.DISCARD)

    def snapshot(self) -> S:
        return copy.deepcopy(self.state)


@operator
def fold_final(
    step_id: str,
    up: KeyedStream[V],
    builder: Callable[[], S],
    folder: Callable[[S, V], S],
) -> KeyedStream[S]:
    """Build an empty accumulator, then combine values into it; emit at
    EOF.  Only works on finite streams.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("fold_final_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2), ("k", 3)]))
    >>> s = op.fold_final("sum", s, lambda: 0, lambda acc, v: acc + v)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 6)]

    Reference parity: ``operators/__init__.py:1944``.
    """

    def shim_builder(resume_state: Optional[S]) -> _FoldFinalLogic[V, S]:
        state = resume_state if resume_state is not None else builder()
        return _FoldFinalLogic(step_id, folder, state)

    return stateful("stateful", up, shim_builder)


@operator
def count_final(
    step_id: str,
    up: Stream[X],
    key: Callable[[X], str],
) -> KeyedStream[int]:
    """Count the number of occurrences of items in the entire stream;
    emit at EOF.  Only works on finite streams.

    Vectorized on the XLA tier as a segment-sum over hashed key ids.

    ``key`` applies to itemized rows only: a columnar ``ArrayBatch``
    already carrying a ``key``/``key_id`` column counts by that
    column directly (the rows' keys ARE the keys — a non-trivial
    ``key`` transform belongs upstream of batch construction).

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("count_final_eg")
    >>> s = op.input("inp", flow, TestingSource(["a", "b", "a"]))
    >>> s = op.count_final("count", s, lambda x: x)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [('a', 2), ('b', 1)]

    Reference parity: ``operators/__init__.py:1221``.
    """
    from bytewax_tpu_torch.xla import SUM

    def _key_ones(batch):
        """Batch-level keying: one listcomp per itemized batch; a
        columnar batch that already carries a key column counts one
        per row (``key`` applies to itemized rows only — columnar
        rows are keyed by their own key/key_id column)."""
        import numpy as _np

        from bytewax_tpu_torch.engine.arrays import ArrayBatch as _AB

        if isinstance(batch, _AB):
            if "key" in batch.cols or "key_id" in batch.cols:
                cols = dict(batch.cols)
                cols["value"] = _np.ones(len(batch), dtype=_np.int32)
                return _AB(cols, key_vocab=batch.key_vocab)
            batch = batch.to_pylist()
        return [(key(x), 1) for x in batch]

    down = flat_map_batch("key", up, _key_ones)
    return reduce_final("sum", down, SUM)


@operator
def max_final(
    step_id: str,
    up: KeyedStream[V],
    by=_identity,
) -> KeyedStream:
    """Find the maximum value for each key; emit at EOF.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("max_final_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 4), ("k", 9), ("k", 1)]))
    >>> s = op.max_final("max", s)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 9)]

    Reference parity: ``operators/__init__.py:2624``.
    """
    if by is _identity:
        from bytewax_tpu_torch.xla import MAX

        return reduce_final("reduce_final", up, MAX)
    return reduce_final("reduce_final", up, lambda s, x: max(s, x, key=by))


@operator
def min_final(
    step_id: str,
    up: KeyedStream[V],
    by=_identity,
) -> KeyedStream:
    """Find the minimum value for each key; emit at EOF.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("min_final_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 4), ("k", 9), ("k", 1)]))
    >>> s = op.min_final("min", s)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 1)]

    Reference parity: ``operators/__init__.py:2692``.
    """
    if by is _identity:
        from bytewax_tpu_torch.xla import MIN

        return reduce_final("reduce_final", up, MIN)
    return reduce_final("reduce_final", up, lambda s, x: min(s, x, key=by))


@operator
def reduce_final(
    step_id: str,
    up: KeyedStream[V],
    reducer: Callable[[V, V], V],
) -> KeyedStream[V]:
    """Distill all values for a key down into a single value; emit at
    EOF.  Like :func:`fold_final` but the first value is the initial
    accumulator.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("reduce_final_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2), ("k", 3)]))
    >>> s = op.reduce_final("sum", s, lambda a, b: a + b)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 6)]

    Includes a map-side pre-combine within each batch (the reference
    does the same: ``operators/__init__.py:2836-2847``), which is also
    what lets the XLA tier turn this into a device-side segment
    reduction.
    """

    from bytewax_tpu_torch import xla as _xla

    # The canonical marked reducers have known combines; inlining
    # them in the pre-combine loop skips two Python calls per item on
    # the hot path (wordcount's per-word SUM, for one).  Identity
    # check only: a user's custom Reducer("sum", fn) must keep its
    # own fn on the host tier.
    inline_op = None
    if reducer is _xla.SUM:
        inline_op = "sum"
    elif reducer is _xla.MIN:
        inline_op = min
    elif reducer is _xla.MAX:
        inline_op = max

    def pre_reducer(mixed_batch: List[Tuple[str, V]]) -> Iterable[Tuple[str, V]]:
        from bytewax_tpu_torch.engine.arrays import ArrayBatch

        if isinstance(mixed_batch, ArrayBatch):
            # Columnar batches pre-combine on device instead.
            return mixed_batch
        states: Dict[str, V] = {}
        if inline_op == "sum":
            for k, v in mixed_batch:
                if k in states:
                    # Binary `+`, not `+=`: the first stored value is
                    # aliased by the input batch (and any other
                    # consumer of the same stream), so it must never
                    # be mutated in place.
                    states[k] = states[k] + v
                else:
                    states[k] = v
        elif inline_op is not None:
            for k, v in mixed_batch:
                if k in states:
                    states[k] = inline_op(states[k], v)
                else:
                    states[k] = v
        else:
            for k, v in mixed_batch:
                if k in states:
                    states[k] = reducer(states[k], v)
                else:
                    states[k] = v
        return states.items()

    pre_up = flat_map_batch("pre_reduce", up, pre_reducer)

    def shim_folder(s: V, v: V) -> V:
        if s is None:
            return v
        return reducer(s, v)

    return fold_final("fold_final", pre_up, _untyped_none, shim_folder)


# --------------------------------------------------------------------------
# collect
# --------------------------------------------------------------------------


@dataclass
class _CollectState(Generic[V]):
    acc: List[V]
    timeout_at: datetime


@dataclass
class _CollectLogic(StatefulLogic[V, List[V], _CollectState[V]]):
    step_id: str
    now_getter: Callable[[], datetime]
    timeout: timedelta
    max_size: int
    state: _CollectState[V]

    def on_item(self, value: V) -> Tuple[Iterable[List[V]], bool]:
        now = self.now_getter()
        self.state.timeout_at = now + self.timeout
        self.state.acc.append(value)
        if len(self.state.acc) >= self.max_size:
            return ((self.state.acc,), StatefulLogic.DISCARD)
        return (_EMPTY, StatefulLogic.RETAIN)

    def on_notify(self) -> Tuple[Iterable[List[V]], bool]:
        return ((self.state.acc,), StatefulLogic.DISCARD)

    def on_eof(self) -> Tuple[Iterable[List[V]], bool]:
        return ((self.state.acc,), StatefulLogic.DISCARD)

    def notify_at(self) -> Optional[datetime]:
        return self.state.timeout_at

    def snapshot(self) -> _CollectState[V]:
        return copy.deepcopy(self.state)


@operator
def collect(
    step_id: str,
    up: KeyedStream[V],
    timeout: timedelta,
    max_size: int,
) -> KeyedStream[List[V]]:
    """Collect items into a list up to a size or a timeout.

    >>> from datetime import timedelta
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("collect_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2), ("k", 3)]))
    >>> s = op.collect("batch", s, timeout=timedelta(seconds=10), max_size=2)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', [1, 2]), ('k', [3])]

    Reference parity: ``operators/__init__.py:1148``.
    """

    def shim_builder(
        resume_state: Optional[_CollectState[V]],
    ) -> _CollectLogic[V]:
        state = (
            resume_state
            if resume_state is not None
            else _CollectState([], _get_system_utc() + timeout)
        )
        return _CollectLogic(step_id, _get_system_utc, timeout, max_size, state)

    return stateful("stateful", up, shim_builder)


# --------------------------------------------------------------------------
# enrich_cached
# --------------------------------------------------------------------------


class TTLCache(Generic[DK, DV]):
    """A dict-like cache with a fixed time-to-live.

    Entries are stamped when fetched and re-fetched on first access
    at or past their deadline (expiry is lazy: an entry that is never
    read again is simply overwritten whenever it is next fetched).

    >>> from datetime import datetime, timedelta, timezone
    >>> from bytewax_tpu_torch.operators import TTLCache
    >>> clock = [datetime(2024, 1, 1, tzinfo=timezone.utc)]
    >>> fetches = []
    >>> def getter(k):
    ...     fetches.append(k)
    ...     return k.upper()
    >>> cache = TTLCache(getter, lambda: clock[0], timedelta(seconds=10))
    >>> cache.get("a"), cache.get("a")
    ('A', 'A')
    >>> fetches
    ['a']
    >>> clock[0] += timedelta(seconds=11)
    >>> _ = cache.get("a")
    >>> fetches
    ['a', 'a']

    Reference parity: ``operators/__init__.py:1275``.
    """

    def __init__(
        self,
        getter: Callable[[DK], DV],
        now_getter: Callable[[], datetime],
        ttl: timedelta,
    ):
        self._getter = getter
        self._now_getter = now_getter
        self._ttl = ttl
        self._entries: Dict[DK, Tuple[datetime, DV]] = {}

    def get(self, k: DK) -> DV:
        """Get the cached value for a key, refreshing if expired."""
        now = self._now_getter()
        entry = self._entries.get(k)
        if entry is not None and now - entry[0] < self._ttl:
            return entry[1]
        value = self._getter(k)
        self._entries[k] = (now, value)
        return value

    def remove(self, k: DK) -> None:
        """Remove the cached value for a key."""
        del self._entries[k]


@operator
def enrich_cached(
    step_id: str,
    up: Stream[X],
    getter: Callable[[DK], DV],
    mapper: Callable[[TTLCache[DK, DV], X], Y],
    ttl: timedelta = timedelta.max,
    _now_getter: Callable[[], datetime] = _get_system_utc,
) -> Stream[Y]:
    """Enrich / join items using a cached lookup to an external service.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> def lookup(user_id):
    ...     return {"1": "ada", "2": "kay"}[user_id]
    >>> def enrich(cache, user_id):
    ...     return (user_id, cache.get(user_id))
    >>> flow = Dataflow("enrich_eg")
    >>> s = op.input("inp", flow, TestingSource(["1", "2", "1"]))
    >>> s = op.enrich_cached("names", s, lookup, enrich)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('1', 'ada'), ('2', 'kay'), ('1', 'ada')]

    Reference parity: ``operators/__init__.py:1314``.
    """
    now = _now_getter()

    def batch_now_getter() -> datetime:
        return now

    cache = TTLCache(getter, batch_now_getter, ttl)

    def shim_mapper(xs: List[X]) -> Iterable[Y]:
        nonlocal now
        now = _now_getter()
        return [mapper(cache, x) for x in xs]

    return flat_map_batch("flat_map_batch", up, _per_item(shim_mapper))


# --------------------------------------------------------------------------
# join
# --------------------------------------------------------------------------

JoinInsertMode: TypeAlias = Literal["first", "last", "product"]
"""How to handle multiple values from a side during a join:
``first`` keeps only the first value per side, ``last`` the most
recent, ``product`` keeps all (cross-join)."""

JoinEmitMode: TypeAlias = Literal["complete", "final", "running"]
"""When to emit joined rows: ``complete`` once all sides have a value
(then the state resets), ``final`` only at EOF (finite streams only),
``running`` on every new value (missing sides are ``None``)."""

class _SideTable:
    """Per-side value pools for one key of a join.

    Each side of the join owns a pool of values seen so far (an empty
    pool means that side is still missing).  The insert mode is
    applied at absorb time — ``first`` ignores repeats, ``last``
    overwrites, ``product`` accumulates — and the window-merge algebra
    lives in :meth:`union`.  Decisions about *when* to emit belong to
    the emit policies below, not here.
    """

    __slots__ = ("pools",)

    def __init__(self, pools: List[List[Any]]):
        self.pools = pools

    @classmethod
    def empty(cls, n_sides: int) -> "_SideTable":
        return cls([[] for _ in range(n_sides)])

    def absorb(self, side: int, value: Any, mode: str) -> None:
        pool = self.pools[side]
        if mode == "product":
            pool.append(value)
        elif mode == "last" or not pool:
            pool[:] = (value,)

    def union(self, absorbed: "_SideTable", mode: str) -> None:
        """Fold another table (from a merged-away session window,
        which opened earlier) into this one: ``first`` lets the
        earlier window win filled sides, ``last`` keeps this window's
        sides where filled, ``product`` concatenates everything."""
        pairs = zip(self.pools, absorbed.pools)
        if mode == "product":
            self.pools = [mine + theirs for mine, theirs in pairs]
        elif mode == "first":
            self.pools = [theirs or mine for mine, theirs in pairs]
        else:  # last
            self.pools = [mine or theirs for mine, theirs in pairs]

    def complete(self) -> bool:
        return all(self.pools)

    def rows(self) -> List[Tuple]:
        """Every combination of one value per side, ``None`` standing
        in for sides with no value yet."""
        filled = [pool if pool else (None,) for pool in self.pools]
        return list(itertools.product(*filled))

    def reset(self) -> None:
        for pool in self.pools:
            del pool[:]

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _SideTable) and self.pools == other.pools

    def __repr__(self) -> str:
        return f"_SideTable({self.pools!r})"


class _EmitPolicy:
    """When a join key's table emits rows downstream and whether its
    state survives the emission.  The base policy never emits."""

    __slots__ = ()

    def after_absorb(self, table: _SideTable) -> Tuple[Iterable[Tuple], bool]:
        return (_EMPTY, StatefulLogic.RETAIN)

    def at_eof(self, table: _SideTable) -> Tuple[Iterable[Tuple], bool]:
        return (_EMPTY, StatefulLogic.RETAIN)


class _EmitWhenComplete(_EmitPolicy):
    """Emit (and reset) the first time every side has a value."""

    def after_absorb(self, table: _SideTable) -> Tuple[Iterable[Tuple], bool]:
        if table.complete():
            return (table.rows(), StatefulLogic.DISCARD)
        return (_EMPTY, StatefulLogic.RETAIN)


class _EmitEveryChange(_EmitPolicy):
    """Emit the (possibly partial) rows after every absorbed value."""

    def after_absorb(self, table: _SideTable) -> Tuple[Iterable[Tuple], bool]:
        return (table.rows(), StatefulLogic.RETAIN)


class _EmitAtEof(_EmitPolicy):
    """Hold everything until the stream ends, then flush."""

    def at_eof(self, table: _SideTable) -> Tuple[Iterable[Tuple], bool]:
        return (table.rows(), StatefulLogic.DISCARD)


_EMIT_POLICIES: Dict[str, _EmitPolicy] = {
    "complete": _EmitWhenComplete(),
    "running": _EmitEveryChange(),
    "final": _EmitAtEof(),
}


@dataclass
class _JoinLogic(StatefulLogic[Tuple[int, Any], Tuple, _SideTable]):
    insert_mode: str
    policy: _EmitPolicy
    table: _SideTable

    def on_item(self, value: Tuple[int, Any]) -> Tuple[Iterable[Tuple], bool]:
        side, side_value = value
        self.table.absorb(side, side_value, self.insert_mode)
        return self.policy.after_absorb(self.table)

    def on_eof(self) -> Tuple[Iterable[Tuple], bool]:
        return self.policy.at_eof(self.table)

    def snapshot(self) -> _SideTable:
        return copy.deepcopy(self.table)


@operator
def _tag_sides(
    step_id: str,
    *ups: KeyedStream[Any],
) -> KeyedStream[Tuple[int, Any]]:
    """Tag each upstream's values with their side index and merge."""
    tagged = [
        map_value(f"side_{i}", up, lambda v, _i=i: (_i, v))
        for i, up in enumerate(ups)
    ]
    return merge("merge", *tagged)


@operator
def join(
    step_id: str,
    *sides: KeyedStream[Any],
    insert_mode: JoinInsertMode = "last",
    emit_mode: JoinEmitMode = "complete",
) -> KeyedStream[Tuple]:
    """Gather together the value for a key on multiple streams.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("join_eg")
    >>> names = op.input("names", flow, TestingSource([("1", "ada")]))
    >>> emails = op.input("emails", flow, TestingSource([("1", "a@b.co")]))
    >>> s = op.join("join", names, emails)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('1', ('ada', 'a@b.co'))]

    Reference parity: ``operators/__init__.py:2324``.
    """
    if insert_mode not in ("first", "last", "product"):
        msg = f"unknown join insert mode {insert_mode!r}"
        raise ValueError(msg)
    if emit_mode not in ("complete", "final", "running"):
        msg = f"unknown join emit mode {emit_mode!r}"
        raise ValueError(msg)

    side_count = len(sides)
    policy = _EMIT_POLICIES[emit_mode]

    def shim_builder(
        resume_state: Optional[_SideTable],
    ) -> _JoinLogic:
        table = (
            resume_state
            if resume_state is not None
            else _SideTable.empty(side_count)
        )
        return _JoinLogic(insert_mode, policy, table)

    merged = _tag_sides("tag", *sides)
    return stateful("join", merged, shim_builder)


# --------------------------------------------------------------------------
# stateful_map / stateful_flat_map
# --------------------------------------------------------------------------


@dataclass
class _StatefulFlatMapLogic(StatefulLogic[V, W, S]):
    step_id: str
    mapper: Callable[[Optional[S], V], Tuple[Optional[S], Iterable[W]]]
    state: Optional[S]

    def on_item(self, value: V) -> Tuple[Iterable[W], bool]:
        res = self.mapper(self.state, value)
        try:
            self.state, ws = res
        except TypeError as ex:
            msg = (
                f"return value of mapper {f_repr(self.mapper)} in step "
                f"{self.step_id!r} must be a 2-tuple of "
                "(updated_state, emit_values); got a "
                f"{type(res)!r} instead"
            )
            raise TypeError(msg) from ex
        if self.state is None:
            return (ws, StatefulLogic.DISCARD)
        return (ws, StatefulLogic.RETAIN)

    def snapshot(self) -> S:
        return copy.deepcopy(self.state)  # type: ignore[return-value]


@operator
def stateful_flat_map(
    step_id: str,
    up: KeyedStream[V],
    mapper: Callable[[Optional[S], V], Tuple[Optional[S], Iterable[W]]],
) -> KeyedStream[W]:
    """Transform values one-to-many, referencing a persistent state.

    Returning ``None`` as the updated state discards it.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("stateful_flat_map_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 1), ("k", 2)]))
    >>> s = op.stateful_flat_map("dedupe_run", s, lambda st, v: (v, [] if st == v else [v]))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 1), ('k', 2)]

    Reference parity: ``operators/__init__.py:2893``.
    """

    def shim_builder(resume_state: Optional[S]) -> _StatefulFlatMapLogic[V, W, S]:
        return _StatefulFlatMapLogic(step_id, mapper, resume_state)

    return stateful("stateful", up, shim_builder)


@operator
def stateful_map(
    step_id: str,
    up: KeyedStream[V],
    mapper: Callable[[Optional[S], V], Tuple[Optional[S], W]],
) -> KeyedStream[W]:
    """Transform values one-to-one, referencing a persistent state.

    Returning ``None`` as the updated state discards it.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("stateful_map_eg")
    >>> s = op.input("inp", flow, TestingSource([("k", 1), ("k", 2), ("k", 3)]))
    >>> s = op.stateful_map("running_sum", s, lambda st, v: ((st or 0) + v, (st or 0) + v))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('k', 1), ('k', 3), ('k', 6)]

    Reference parity: ``operators/__init__.py:2920``.
    """

    # Direct logic (not a shim through stateful_flat_map): this is
    # the per-item stateful hot path (anomaly-detector shape), and
    # one less Python call per item matters.
    def shim_builder(resume_state: Optional[S]) -> "_StatefulMapLogic[V, W, S]":
        return _StatefulMapLogic(step_id, mapper, resume_state)

    shim_builder.__wrapped__ = mapper

    # Nested under a "stateful_flat_map" scope so the flattened step
    # id (...stateful_flat_map.stateful.stateful_batch) AND the
    # rendered op_type (from the builder's __name__) are unchanged
    # from the shim implementation this replaced — snapshots in
    # existing recovery stores keep resolving and diagrams read the
    # same.  The local def shadows the module-level operator only
    # inside this body.
    @operator
    def stateful_flat_map(step_id: str, up: KeyedStream) -> KeyedStream:
        return stateful("stateful", up, shim_builder)

    return stateful_flat_map("stateful_flat_map", up)


@dataclass
class _StatefulMapLogic(StatefulLogic[V, W, S]):
    step_id: str
    mapper: Callable[[Optional[S], V], Tuple[Optional[S], W]]
    state: Optional[S]

    def on_item(self, value: V) -> Tuple[Iterable[W], bool]:
        res = self.mapper(self.state, value)
        try:
            self.state, w = res
        except TypeError as ex:
            msg = (
                f"return value of mapper {f_repr(self.mapper)} in step "
                f"{self.step_id!r} must be a 2-tuple of (updated_state, "
                f"emit_value); got a {type(res)!r} instead"
            )
            raise TypeError(msg) from ex
        if self.state is None:
            return ((w,), StatefulLogic.DISCARD)
        return ((w,), StatefulLogic.RETAIN)

    def snapshot(self) -> S:
        return copy.deepcopy(self.state)  # type: ignore[return-value]
