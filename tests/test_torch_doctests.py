"""Run the examples in the torch port's docstrings: the copied host
modules and the operators, whose keyed aggregations, windowed folds,
scans and inference run on the port's device tier (on the CPU here).

Also the coverage checks of ``tests/test_doctests.py``, run on both
packages: the operators module carries at least 20 examples, and every
public operator function and every public connector class has one.
"""

import doctest
import importlib
import inspect
import os

import pytest

from bytewax_tpu_torch.utils import force_platform

MODULES = [
    "bytewax_tpu_torch.connectors.demo",
    "bytewax_tpu_torch.connectors.files",
    "bytewax_tpu_torch.connectors.kafka",
    "bytewax_tpu_torch.connectors.stdio",
    "bytewax_tpu_torch.dataflow",
    "bytewax_tpu_torch.engine.backoff",
    "bytewax_tpu_torch.engine.infer",
    "bytewax_tpu_torch.engine.scan_accel",
    "bytewax_tpu_torch.errors",
    "bytewax_tpu_torch.inputs",
    "bytewax_tpu_torch.models.anomaly",
    "bytewax_tpu_torch.operators",
    "bytewax_tpu_torch.operators.helpers",
    "bytewax_tpu_torch.operators.inference",
    "bytewax_tpu_torch.operators.windowing",
    "bytewax_tpu_torch.ops.scan",
    "bytewax_tpu_torch.ops.text",
    "bytewax_tpu_torch.outputs",
    "bytewax_tpu_torch.recovery",
    "bytewax_tpu_torch.supervise",
    "bytewax_tpu_torch.testing",
    "bytewax_tpu_torch.tracing",
    "bytewax_tpu_torch.visualize",
    "bytewax_tpu_torch.xla",
]

PACKAGES = ("bytewax_tpu", "bytewax_tpu_torch")
OPERATOR_MODULES = ("operators", "operators.helpers", "operators.windowing", "operators.inference")
#: Public connector classes that must carry an example (the Kafka
#: message and error types document the broker-backed classes' IO).
CONNECTORS = {
    "connectors.files": ["CSVSource", "DirSink", "DirSource", "FileSink", "FileSource"],
    "connectors.stdio": ["StdOutSink"],
    "connectors.demo": ["RandomMetricSource"],
    "connectors.kafka": ["KafkaError", "KafkaSinkMessage", "KafkaSourceMessage"],
}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.mark.parametrize("modname", MODULES)
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    results = doctest.testmod(
        mod, verbose=False, optionflags=doctest.NORMALIZE_WHITESPACE
    )
    assert results.attempted > 0
    assert results.failed == 0, f"{results.failed} doctest failures"


def _has_example(obj, name):
    return bool([t for t in doctest.DocTestFinder().find(obj, name=name) if t.examples])


def test_doctest_examples_exist():
    """The operator library carries runnable examples, as many in the
    port as in the JAX package."""
    counts = []
    for pkg in PACKAGES:
        mod = importlib.import_module(f"{pkg}.operators")
        tests = [t for t in doctest.DocTestFinder().find(mod) if t.examples]
        assert len(tests) >= 20, f"only {len(tests)} operators of {pkg} carry examples"
        counts.append(len(tests))
    assert counts[1] == counts[0]


def test_every_public_operator_has_example():
    """Every public operator function of the ``operators`` modules has a
    runnable docstring example, in both packages, and the two packages
    have the same public operators."""
    names = []
    for pkg in PACKAGES:
        missing, found = [], []
        for sub in OPERATOR_MODULES:
            modname = f"{pkg}.{sub}"
            mod = importlib.import_module(modname)
            for name in dir(mod):
                obj = getattr(mod, name)
                if name.startswith("_") or not inspect.isfunction(obj):
                    continue
                if getattr(obj, "__module__", None) != modname:
                    continue
                found.append(f"{sub}.{name}")
                if not _has_example(obj, name):
                    missing.append(modname + "." + name)
        assert not missing, f"public operators without examples: {missing}"
        names.append(found)
    assert names[1] == names[0]


def test_every_connector_has_example():
    """Every public connector class has a runnable docstring example,
    in both packages."""
    for pkg in PACKAGES:
        missing = []
        for sub, classes in CONNECTORS.items():
            mod = importlib.import_module(f"{pkg}.{sub}")
            missing += [f"{pkg}.{sub}.{n}" for n in classes if not _has_example(getattr(mod, n), n)]
        assert not missing, f"connectors without examples: {missing}"
