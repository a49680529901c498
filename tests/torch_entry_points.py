"""The JAX package and the torch port side by side, for the parity
tests of the operator library and its execution semantics
(``tests/test_torch_dataflow.py``, ``test_torch_errors.py``,
``test_torch_execution.py``, ``test_torch_operators.py``,
``test_torch_windowing_ops.py``, ``test_torch_window_lowering.py``,
and the residency, columnar-ingest, connector and native files).

``REF`` and ``PORT`` map the same names to each package's modules and
classes; a test builds its flow through one of them (``pkg["op"]``,
``pkg["win"]``, ``pkg["Dataflow"]``, ...).  ``ENTRY_POINTS`` names the
three execution entry points of ``tests/conftest.py`` and
:func:`entry` gives each package's own, so the port never runs under
the conftest fixture, which calls the JAX package's.

A test module imports the two autouse fixtures, ``port_on_cpu`` and
``unsharded``: the port's device tier goes to the CPU, and the JAX
package runs with ``BYTEWAX_TPU_SHARD=0`` (the test session's 8-device
CPU mesh would otherwise put it on its mesh-sharded tier; the port's
tier here is the single-device slot table).
"""

import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

import pytest

import bytewax_tpu.errors as ref_errors
import bytewax_tpu.inputs as ref_inputs
import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu.recovery as ref_recovery
import bytewax_tpu_torch.engine.sharded_state as port_sharded_state
import bytewax_tpu_torch.errors as port_errors
import bytewax_tpu_torch.inputs as port_inputs
import bytewax_tpu_torch.operators as port_op
import bytewax_tpu_torch.operators.windowing as port_win
import bytewax_tpu_torch.recovery as port_recovery
from bytewax_tpu import testing as ref_testing
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.dataflow import DataflowError as RefDataflowError
from bytewax_tpu.engine import arrays as ref_arrays
from bytewax_tpu.engine import window_accel as ref_wa
from bytewax_tpu.engine import xla as ref_engine_xla
from bytewax_tpu.engine.flatten import flatten as ref_flatten
from bytewax_tpu.models.brc import ArrayBatchSource as RefArraySource
from bytewax_tpu_torch import testing as port_testing
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.dataflow import DataflowError as PortDataflowError
from bytewax_tpu_torch.engine import arrays as port_arrays
from bytewax_tpu_torch.engine import window_accel as port_wa
from bytewax_tpu_torch.engine import xla as port_engine_xla
from bytewax_tpu_torch.engine.flatten import flatten as port_flatten
from bytewax_tpu_torch.models.brc import ArrayBatchSource as PortArraySource
from bytewax_tpu_torch.utils import force_platform


def _names(
    name, op, win, xla, testing, dataflow, dataflow_error, flatten, errors,
    inputs, recovery, arrays, wa, engine_xla, array_source,
):
    return {
        "name": name,
        "op": op,
        "win": win,
        "xla": xla,
        "Dataflow": dataflow,
        "DataflowError": dataflow_error,
        "flatten": flatten,
        "errors": errors,
        "inputs": inputs,
        "recovery": recovery,
        "Source": testing.TestingSource,
        "Sink": testing.TestingSink,
        "TimeTestingGetter": testing.TimeTestingGetter,
        "testing": testing,
        "run_main": testing.run_main,
        "cluster_main": testing.cluster_main,
        "Batch": arrays.ArrayBatch,
        "TsValue": arrays.TsValue,
        "column_ts": arrays.column_ts,
        "ArraySource": array_source,
        "wa": wa,
        "NonNumericValues": engine_xla.NonNumericValues,
    }


REF = _names(
    "bytewax_tpu", ref_op, ref_win, ref_xla, ref_testing, RefDataflow,
    RefDataflowError, ref_flatten, ref_errors, ref_inputs, ref_recovery,
    ref_arrays, ref_wa, ref_engine_xla, RefArraySource,
)
PORT = _names(
    "bytewax_tpu_torch", port_op, port_win, port_xla, port_testing,
    PortDataflow, PortDataflowError, port_flatten, port_errors, port_inputs,
    port_recovery, port_arrays, port_wa, port_engine_xla, PortArraySource,
)
PKGS = (REF, PORT)

ENTRY_POINTS = ("run_main", "cluster_main-1thread", "cluster_main-2thread")


def entry(pkg, name: str) -> Callable:
    """``pkg``'s own execution entry point called ``name``."""
    if name == "run_main":
        return pkg["run_main"]
    lanes = {"cluster_main-1thread": 1, "cluster_main-2thread": 2}[name]

    def run(flow, **kwargs):
        return pkg["cluster_main"](flow, [], 0, worker_count_per_proc=lanes, **kwargs)

    return run


def run_both(build, entry_name: str = "run_main") -> Tuple[Any, Any]:
    """``build(pkg)`` returns ``(flow, out)``; runs the JAX package's
    flow and the port's under their own ``entry_name`` and returns
    ``(want, got)``, the two ``out``."""
    outs = []
    for pkg in PKGS:
        flow, out = build(pkg)
        entry(pkg, entry_name)(flow)
        outs.append(out)
    return outs[0], outs[1]


def recovery_config(pkg, path):
    """A one-partition store of ``pkg``'s own under ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    pkg["recovery"].init_db_dir(path, 1)
    return pkg["recovery"].RecoveryConfig(str(path))


def raised(fn: Callable[[], Any]) -> BaseException:
    """The exception ``fn`` raises (the test fails if it returns)."""
    with pytest.raises(BaseException) as info:
        fn()
    return info.value


def assert_same_error(want: BaseException, got: BaseException, pkg_class=None) -> None:
    """The port raised the reference's error: the same type name (and,
    for a class each package defines, the port's own class) with the
    same message, once each package's name is taken out of it."""
    assert type(got).__name__ == type(want).__name__, (got, want)
    if pkg_class is not None:
        assert isinstance(got, pkg_class), type(got)
    assert _neutral(str(got)) == _neutral(str(want)), (str(got), str(want))


_ENGINE_AT = re.compile(r"\(engine at [^)]*\)")


def _neutral(text: str) -> str:
    return text.replace("bytewax_tpu_torch", "bytewax_tpu")


def neutral_notes(ex: BaseException) -> List[str]:
    """The exception's notes with each package's name and the engine
    call site's file and line taken out (the two drivers differ in
    their lines; the step ids and the user callable's location must
    not)."""
    return [
        _ENGINE_AT.sub("(engine at ...)", _neutral(n))
        for n in getattr(ex, "__notes__", [])
    ]


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.fixture(autouse=True)
def unsharded(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")


@dataclass
class Folds:
    """The device states the port's driver built in a test and the
    rows each of its folds took (``DeviceAggState._scatter``, the one
    place a fold launches the segment-fold kernel on a card)."""

    states: List[Any] = field(default_factory=list)
    rows: List[int] = field(default_factory=list)

    @property
    def total(self) -> int:
        return sum(self.rows)


@pytest.fixture
def port_folds(monkeypatch):
    """Records the port's device folds (see :class:`Folds`)."""
    folds = Folds()
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        state = make(kind, driver=driver)
        folds.states.append(state)
        scatter = state._scatter

        def counted(slot_ids, values):
            folds.rows.append(len(slot_ids))
            return scatter(slot_ids, values)

        state._scatter = counted
        return state

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    return folds


@pytest.fixture
def port_deliveries(monkeypatch):
    """The length of each delivery the port's aggregation states take
    through ``update``, ``update_items`` or ``update_batch``: one fold
    each, whatever the path (string keys, items, dictionary ids)."""
    lengths: List[int] = []
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        state = make(kind, driver=driver)
        for name in ("update", "update_items", "update_batch"):
            inner = getattr(state, name)

            def counted(*args, _inner=inner):
                lengths.append(len(args[0]))
                return _inner(*args)

            setattr(state, name, counted)
        return state

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    return lengths
