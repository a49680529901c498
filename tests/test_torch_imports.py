"""The torch port stands alone: it imports neither jax nor the JAX
package, its device tier never runs silently on the CPU, and its chip
smoke test refuses to run without a card or without the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import utils, xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine.xla import DeviceAggState
from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bytewax_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bytewax_tpu")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    utils.force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_running_a_flow_loads_neither_jax_nor_the_reference():
    code = """
import sys
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
out = []
flow = Dataflow("f")
s = op.input("inp", flow, TestingSource([("a", 1.5), ("b", 2.0), ("a", -1.0)]))
s = xla.stats_final("stats", s)
op.output("out", s, TestingSink(out))
run_main(flow)
assert sorted(out) == [("a", (-1.0, 0.25, 1.5, 2)), ("b", (2.0, 2.0, 2.0, 1))], out
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bytewax_tpu")]
assert not loaded, loaded
print("clean")
"""
    env = dict(os.environ, BYTEWAX_TPU_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")


def _stats_flow(out):
    flow = Dataflow("f")
    s = op.input("inp", flow, TestingSource([("a", 1.0), ("b", 2.0)]))
    s = xla.stats_final("stats", s)
    op.output("out", s, TestingSink(out))
    return flow


def test_device_tier_without_cuda_raises(monkeypatch):
    monkeypatch.delenv("BYTEWAX_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceAggState("sum")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(_stats_flow([]))
    # The host tier needs no device.
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    out = []
    run_main(_stats_flow(out))
    assert sorted(out) == [("a", (1.0, 1.0, 1.0, 1)), ("b", (2.0, 2.0, 2.0, 1))]


def test_unknown_platform_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="BYTEWAX_TPU_PLATFORM"):
        utils.force_platform("tpu")
    monkeypatch.setenv("BYTEWAX_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="BYTEWAX_TPU_PLATFORM"):
        utils.device()
    monkeypatch.setenv("BYTEWAX_TPU_PLATFORM", "cpu")
    assert utils.device() == torch.device("cpu")


def test_distributed_tier_is_not_ported_yet(monkeypatch):
    from bytewax_tpu_torch.engine.sharded_state import make_agg_state

    monkeypatch.setenv("BYTEWAX_TPU_DISTRIBUTED", "1")
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        make_agg_state("sum")
    monkeypatch.delenv("BYTEWAX_TPU_DISTRIBUTED")
    state = make_agg_state("sum")
    state.update(np.array(["k"]), np.array([2.5]))
    assert state.finalize() == [("k", 2.5)]


def _smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_multi_process_cluster_is_not_ported_yet():
    from bytewax_tpu_torch.testing import cluster_main

    with pytest.raises(NotImplementedError, match="queue A item 8"):
        cluster_main(_stats_flow([]), ["127.0.0.1:1", "127.0.0.1:2"], 0)
    # One process with two worker lanes runs.
    out = []
    cluster_main(_stats_flow(out), [], 0, worker_count_per_proc=2)
    assert sorted(out) == [("a", (1.0, 1.0, 1.0, 1)), ("b", (2.0, 2.0, 2.0, 1))]
