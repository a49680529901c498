"""Both packages' modules by one short name each, for the parity tests
of the connector-edge resilience, device-fault demotion, graceful stop
and observability modules (``tests/test_torch_io_resilience.py``,
``test_torch_chaos.py``, ``test_torch_pipeline.py``,
``test_torch_graceful_stop.py``, ``test_torch_wire.py``,
``test_torch_observability.py``, ``test_torch_flowmap.py``,
``test_torch_ledger.py``, ``test_torch_tracing_export.py`` and their
process-spawning companions).

A case is written once as ``_case(m, ...)`` over a :class:`Pkg` and run
through :data:`JAX` and :data:`TORCH` on the same input; it returns
what the test compares (outputs, DLQ rows, flight-recorder counters,
metric samples, JSON shapes).  ``m.op``, ``m.faults``, ``m.flight``,
``m.Dataflow``, ... resolve to the package's own module or class.

Each package keeps its own fault plan, flight recorder and metrics
registry; ``xN`` fault counts last for the whole process, so the
autouse :func:`fresh_faults` resets both plans around every test.  The
port's engine metrics live on ``_metrics.ENGINE_REGISTRY``
(:attr:`Pkg.registry`), the JAX package's on the default registry.
"""

import importlib
import json
import os
import re
import sys
from datetime import timedelta
from typing import Any, Dict, List, Optional

import pytest

from tests.torch_entry_points import port_on_cpu, unsharded  # noqa: F401

ZERO_TD = timedelta(seconds=0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Short name -> ``module`` or ``module:attribute`` under the package.
NAMES: Dict[str, str] = {
    "op": "operators",
    "win": "operators.windowing",
    "helpers": "operators.helpers",
    "xla": "xla",
    "dataflow": "dataflow",
    "Dataflow": "dataflow:Dataflow",
    "errors": "errors",
    "inputs": "inputs",
    "outputs": "outputs",
    "RecoveryConfig": "recovery:RecoveryConfig",
    "init_db_dir": "recovery:init_db_dir",
    "testing": "testing",
    "TestingSource": "testing:TestingSource",
    "TestingSink": "testing:TestingSink",
    "run_main": "testing:run_main",
    "cluster_main": "testing:cluster_main",
    "files": "connectors.files",
    "kafka": "connectors.kafka",
    "inmem": "connectors.kafka.inmem",
    "arrays": "engine.arrays",
    "ArrayBatch": "engine.arrays:ArrayBatch",
    "ArrayBatchSource": "models.brc:ArrayBatchSource",
    "backoff": "engine.backoff",
    "comm": "engine.comm",
    "dlq": "engine.dlq",
    "driver": "engine.driver",
    "faults": "engine.faults",
    "flatten": "engine.flatten",
    "flight": "engine.flight",
    "flowmap": "engine.flowmap",
    "pipeline": "engine.pipeline",
    "store": "engine.recovery_store",
    "sharded_state": "engine.sharded_state",
    "webserver": "engine.webserver",
    "wire": "engine.wire",
    "engine_xla": "engine.xla",
    "metrics": "_metrics",
    "tracing": "tracing",
    "visualize": "visualize",
    "analysis": "analysis",
    "contracts": "analysis.contracts",
}


class Pkg:
    """One package's modules by their short names (:data:`NAMES`)."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label

    def __getattr__(self, short: str) -> Any:
        try:
            path = NAMES[short]
        except KeyError:
            raise AttributeError(short) from None
        module, _, attr = path.partition(":")
        value = importlib.import_module(f"{self.name}.{module}")
        if attr:
            value = getattr(value, attr)
        self.__dict__[short] = value
        return value

    def __repr__(self) -> str:
        return self.label

    @property
    def is_port(self) -> bool:
        return self.name == "bytewax_tpu_torch"

    @property
    def registry(self):
        """The registry that holds the package's engine metrics."""
        if self.is_port:
            return self.metrics.ENGINE_REGISTRY
        from prometheus_client import REGISTRY

        return REGISTRY

    def sample(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self.registry.get_sample_value(name, labels or {})

    def exposition(self) -> str:
        """The engine families' Prometheus text."""
        from prometheus_client import generate_latest

        return generate_latest(self.registry).decode("utf-8")

    def counter(self, key: str, default: Any = 0) -> Any:
        return self.flight.RECORDER.counters.get(key, default)

    def entry(self, name: str):
        """The package's own execution entry point called ``name``
        (the names of ``tests/conftest.py``'s ``entry_point_name``)."""
        if name == "run_main":
            return self.run_main
        lanes = {"cluster_main-1thread": 1, "cluster_main-2thread": 2}[name]
        cluster_main = self.cluster_main

        def run(flow, **kwargs):
            return cluster_main(flow, [], 0, worker_count_per_proc=lanes, **kwargs)

        return run

    def rc(self, path):
        """A one-partition recovery store of the package under ``path``."""
        path.mkdir(parents=True, exist_ok=True)
        self.init_db_dir(path, 1)
        return self.RecoveryConfig(str(path))

    def child_env(self, **extra: str) -> Dict[str, str]:
        """The environment of a child process that runs the package on
        the CPU from this checkout."""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["BYTEWAX_TPU_PLATFORM"] = "cpu"
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("BYTEWAX_TPU_FAULTS", None)
        env.update(extra)
        return env

    def module_cmd(self, module: str, *args: str) -> List[str]:
        return [sys.executable, "-m", f"{self.name}.{module}", *args]


JAX = Pkg("bytewax_tpu", "jax")
TORCH = Pkg("bytewax_tpu_torch", "torch")
BOTH = (JAX, TORCH)


def both(case, *args, **kwargs):
    """``(case(JAX, ...), case(TORCH, ...))``."""
    return case(JAX, *args, **kwargs), case(TORCH, *args, **kwargs)


def neutral(value: Any) -> Any:
    """``value`` with the port's package name read as the JAX
    package's, through strings, lists, tuples and dicts."""
    if isinstance(value, str):
        return value.replace("bytewax_tpu_torch", "bytewax_tpu")
    if isinstance(value, (list, tuple)):
        return type(value)(neutral(v) for v in value)
    if isinstance(value, dict):
        return {neutral(k): neutral(v) for k, v in value.items()}
    return value


def shape(value: Any) -> Any:
    """The JSON shape of ``value``: its keys and value types, not the
    values themselves (timings, pids and ports differ run to run)."""
    if isinstance(value, dict):
        return {k: shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return ["list"]
    if isinstance(value, bool) or value is None:
        return type(value).__name__
    if isinstance(value, (int, float)):
        return "number"
    return type(value).__name__


def status_shape(status: Dict[str, Any]) -> Any:
    """The JSON shape of a ``/status`` document, with the flight
    recorder's and the ledger's sections cut to their keys: their
    counters, rings and phase totals hold whatever earlier runs in the
    process left there."""
    history = ("recorder", "ledger")
    out = {k: shape(v) for k, v in status.items() if k not in history}
    out.update({k: sorted(status[k]) for k in history if k in status})
    return out


def for_pkg(text: str, m: "Pkg") -> str:
    """Flow-module source written for the JAX package, importing
    ``m``'s modules instead."""
    return re.sub(r"\bbytewax_tpu\b", m.name, text)


def dlq_rows(path) -> List[Dict[str, Any]]:
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(autouse=True)
def fresh_faults():
    for pkg in BOTH:
        pkg.faults.reset()
    yield
    for pkg in BOTH:
        pkg.faults.reset()


def io_env(monkeypatch, retries=4, backoff="0.005"):
    monkeypatch.setenv("BYTEWAX_TPU_IO_RETRIES", str(retries))
    monkeypatch.setenv("BYTEWAX_TPU_IO_BACKOFF_S", backoff)


@pytest.mark.parametrize("short", sorted(NAMES))
def test_every_short_name_resolves_in_both(short):
    """Each short name is in both packages, and never crosses them."""
    for pkg in BOTH:
        value = getattr(pkg, short)
        module = getattr(value, "__module__", None) or value.__name__
        assert module.split(".")[0] == pkg.name, (short, module)
