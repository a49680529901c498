"""Dataflow graph data model.

A :class:`Dataflow` is a DAG of operators built fluently in Python.  Operators
are declared with the :func:`operator` decorator: the decorated *builder
function* is called at graph-construction time and either composes other
operators (a *derived* operator) or — for *core* operators — simply declares
its output streams.  The engine only ever interprets core operators; every
derived operator flattens away.

Capability parity with the reference graph model
(upstream bytewax ``pysrc/bytewax/dataflow.py:125-716``): nested scopes,
fully-qualified step ids with duplicate detection, stream/port bookkeeping for
visualization, and fluent ``Stream.then`` chaining.  The implementation is our
own: instead of generating a dataclass per operator type from the builder's
signature, we record every node as a uniform :class:`Operator` with named
up/down ports — equally expressive, far simpler to walk.
"""

import functools
import inspect
from dataclasses import dataclass, field, replace
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    List,
    Optional,
    Tuple,
    TypeVar,
)

X = TypeVar("X")
Y = TypeVar("Y")
V = TypeVar("V")

__all__ = [
    "Dataflow",
    "DataflowError",
    "KeyedStream",
    "Operator",
    "Stream",
    "f_repr",
    "operator",
]


class DataflowError(ValueError):
    """Raised on malformed graph construction."""


def f_repr(f: Callable) -> str:
    """Nice ``repr`` for a user callable (used in graph rendering)."""
    if hasattr(f, "__qualname__"):
        mod = getattr(f, "__module__", None)
        if mod and mod not in ("builtins", "__main__"):
            return f"{mod}.{f.__qualname__}"
        return f.__qualname__
    return repr(f)


@dataclass(frozen=True)
class _Scope:
    """Where new substeps are appended and how step ids are qualified."""

    parent_id: str
    substeps: List["Operator"] = field(repr=False, default_factory=list)
    flow: "Dataflow" = field(repr=False, default=None)  # type: ignore[assignment]

    def child_id(self, name: str) -> str:
        return f"{self.parent_id}.{name}"


@dataclass(frozen=True)
class Stream(Generic[X]):
    """Handle to a typed stream of items flowing between operators.

    Returned by operator calls; passed as the upstream argument to the next
    operator.  Supports fluent chaining via :meth:`then`.
    """

    stream_id: str
    _scope: _Scope = field(repr=False, compare=False)

    def flow(self) -> "Dataflow":
        return self._scope.flow

    def then(self, op_fn: Callable, step_id: str, *args, **kwargs):
        """Chain an operator: ``s.then(op.map, "x", f)`` ==
        ``op.map("x", s, f)``."""
        return op_fn(step_id, self, *args, **kwargs)

    def _to_scope(self, scope: _Scope) -> "Stream[X]":
        return replace(self, _scope=scope)


#: A stream of ``(key, value)`` 2-tuples; keys must be strings.
KeyedStream = Stream[Tuple[str, V]]


@dataclass
class Operator:
    """One node in the graph.

    ``ups``/``downs`` map port names to the streams wired into / out of this
    operator.  Multi-streams (``*ups`` style ports) are lists.  ``core``
    operators are interpreted by the engine; others carry ``substeps``.
    ``conf`` holds the non-stream arguments (callables, sources, configs).
    """

    step_id: str
    name: str
    ups: Dict[str, Any] = field(default_factory=dict)
    downs: Dict[str, "Stream"] = field(default_factory=dict)
    substeps: List["Operator"] = field(default_factory=list)
    core: bool = False
    conf: Dict[str, Any] = field(default_factory=dict)

    @property
    def step_name(self) -> str:
        return self.step_id.rsplit(".", 1)[-1]

    def up_streams(self) -> List[Stream]:
        out: List[Stream] = []
        for v in self.ups.values():
            if isinstance(v, Stream):
                out.append(v)
            else:
                out.extend(v)
        return out

    def down_streams(self) -> List[Stream]:
        return list(self.downs.values())


class Dataflow:
    """Container for a dataflow graph.

    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> flow = Dataflow("my_flow")
    """

    def __init__(self, flow_id: str):
        if not isinstance(flow_id, str) or not flow_id:
            raise DataflowError("flow ID must be a non-empty string")
        if "." in flow_id:
            raise DataflowError(f"flow ID {flow_id!r} can't contain a period")
        self.flow_id = flow_id
        self.substeps: List[Operator] = []
        self._step_ids: set = set()

    def __repr__(self) -> str:
        return f"Dataflow({self.flow_id!r})"

    def _scope(self) -> _Scope:
        return _Scope(parent_id=self.flow_id, substeps=self.substeps, flow=self)

    def _register_step(self, step_id: str) -> None:
        if step_id in self._step_ids:
            raise DataflowError(f"step {step_id!r} already exists; step IDs must be unique")
        self._step_ids.add(step_id)


def _find_scope(args: List[Any]) -> Optional[_Scope]:
    for arg in args:
        if isinstance(arg, Dataflow):
            return arg._scope()
        if isinstance(arg, Stream):
            return arg._scope
    return None


class _BuildCtx:
    """Graph-construction context for the operator currently being built."""

    stack: List["_BuildCtx"] = []

    def __init__(self, op: Operator, scope: _Scope):
        self.op = op
        self.scope = scope

    @classmethod
    def current(cls) -> "_BuildCtx":
        if not cls.stack:
            raise DataflowError(
                "streams can only be created while building an operator"
            )
        return cls.stack[-1]


def _new_stream(port_name: str) -> Stream:
    """Create an output stream for the core operator currently being built."""
    ctx = _BuildCtx.current()
    sid = f"{ctx.op.step_id}.{port_name}"
    return Stream(stream_id=sid, _scope=ctx.scope)


def operator(builder: Optional[Callable] = None, *, _core: bool = False) -> Callable:
    """Decorate a builder function into a dataflow operator.

    The builder's first parameter must be ``step_id``; parameters annotated or
    passed as :class:`Stream` (or variadic streams) become upstream ports; the
    return value's streams become downstream ports.  Derived builders call
    other operators in their body — those become nested ``substeps``.
    """

    def deco(builder: Callable) -> Callable:
        sig = inspect.signature(builder)
        params = list(sig.parameters.values())
        if not params or params[0].name != "step_id":
            raise DataflowError(
                f"operator builder {builder.__name__!r} must take 'step_id' "
                "as its first parameter"
            )

        @functools.wraps(builder)
        def wrapper(step_id: str, *args, **kwargs):
            if not isinstance(step_id, str):
                raise DataflowError(
                    f"step ID for {builder.__name__!r} must be a string; "
                    f"got {step_id!r}"
                )
            if "." in step_id:
                raise DataflowError(
                    f"step ID {step_id!r} can't contain a period"
                )
            try:
                bound = sig.bind(step_id, *args, **kwargs)
            except TypeError as ex:
                raise TypeError(
                    f"operator {builder.__name__!r} called incorrectly: {ex}"
                ) from None
            bound.apply_defaults()

            outer = _find_scope(list(args) + list(kwargs.values()))
            if outer is None:
                raise DataflowError(
                    f"operator {builder.__name__!r} needs a Stream or "
                    "Dataflow argument to attach to"
                )
            flow = outer.flow
            full_id = outer.child_id(step_id)
            flow._register_step(full_id)

            # Classify bound args into ports vs config.
            ups: Dict[str, Any] = {}
            conf: Dict[str, Any] = {}
            inner_scope = _Scope(parent_id=full_id, substeps=[], flow=flow)
            call_args: Dict[str, Any] = {}
            for pname, pval in bound.arguments.items():
                if pname == "step_id":
                    # Builders see the fully-qualified id, so error
                    # messages and inspectors show the full path.
                    call_args[pname] = full_id
                    continue
                param = sig.parameters[pname]
                if isinstance(pval, Stream):
                    if pval._scope.flow is not flow:
                        raise DataflowError(
                            f"stream {pval.stream_id!r} passed to "
                            f"{full_id!r} is from a different dataflow"
                        )
                    ups[pname] = pval
                    call_args[pname] = pval._to_scope(inner_scope)
                elif param.kind is inspect.Parameter.VAR_POSITIONAL and any(
                    isinstance(v, Stream) for v in pval
                ):
                    if not all(isinstance(v, Stream) for v in pval):
                        raise DataflowError(
                            f"*{pname} of {full_id!r} must be all Streams"
                        )
                    for v in pval:
                        if v._scope.flow is not flow:
                            raise DataflowError(
                                f"stream {v.stream_id!r} passed to "
                                f"{full_id!r} is from a different dataflow"
                            )
                    ups[pname] = list(pval)
                    call_args[pname] = tuple(
                        v._to_scope(inner_scope) for v in pval
                    )
                elif isinstance(pval, Dataflow):
                    conf[pname] = pval
                    call_args[pname] = pval
                else:
                    conf[pname] = pval
                    call_args[pname] = pval

            op = Operator(
                step_id=full_id,
                name=builder.__name__,
                ups=ups,
                substeps=inner_scope.substeps,
                core=_core,
                conf=conf,
            )

            # Reconstruct positional/keyword call matching the signature
            # (sig.bind can't round-trip VAR_POSITIONAL through kwargs).
            pos_args: List[Any] = []
            kw_args: Dict[str, Any] = {}
            for param in params:
                if param.name not in call_args:
                    continue
                val = call_args[param.name]
                if param.kind is inspect.Parameter.VAR_POSITIONAL:
                    pos_args.extend(val)
                elif param.kind is inspect.Parameter.KEYWORD_ONLY:
                    kw_args[param.name] = val
                elif param.kind is inspect.Parameter.VAR_KEYWORD:
                    kw_args.update(val)
                else:
                    pos_args.append(val)

            ctx = _BuildCtx(op, inner_scope)
            _BuildCtx.stack.append(ctx)
            try:
                out = builder(*pos_args, **kw_args)
            finally:
                _BuildCtx.stack.pop()

            if _core and op.substeps:
                raise DataflowError(
                    f"core operator {full_id!r} can't have substeps"
                )

            # Wire outputs: re-scope returned streams to the outer scope so
            # downstream chaining attaches siblings, not children.
            result: Any
            if out is None:
                result = None
            elif isinstance(out, Stream):
                op.downs["down"] = out
                result = out._to_scope(outer)
            else:
                # Dataclass-like bundle of streams (e.g. BranchOut).
                rescoped = {}
                for fname, fval in vars(out).items():
                    if isinstance(fval, Stream):
                        op.downs[fname] = fval
                        rescoped[fname] = fval._to_scope(outer)
                    else:
                        rescoped[fname] = fval
                result = type(out)(**rescoped)

            outer.substeps.append(op)
            return result

        wrapper._is_operator = True  # type: ignore[attr-defined]
        wrapper._is_core = _core  # type: ignore[attr-defined]
        return wrapper

    if builder is not None:
        return deco(builder)
    return deco
