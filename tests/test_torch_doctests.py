"""Run the examples in the torch port's docstrings: the copied host
modules and the operators, whose keyed aggregations, windowed folds,
scans and inference run on the port's device tier (on the CPU here)."""

import doctest
import importlib
import os

import pytest

from bytewax_tpu_torch.utils import force_platform

MODULES = [
    "bytewax_tpu_torch.connectors.demo",
    "bytewax_tpu_torch.connectors.files",
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
    "bytewax_tpu_torch.xla",
]


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
