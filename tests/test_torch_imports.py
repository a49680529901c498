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


#: Flows that a subprocess runs through the port, one per path: the
#: keyed aggregation, file ingest into wordcount, a windowed fold, and
#: the anomaly detector in both forms (scan, and inference).
FLOWS = {
    "anomaly": """
from bytewax_tpu_torch.models.anomaly import anomaly_flow, anomaly_infer_flow
items = [("s", 1.0), ("s", 2.0), ("s", 9.0)]
run_main(anomaly_flow(TestingSource(items), TestingSink(out)))
inferred = []
run_main(anomaly_infer_flow(TestingSource(items), TestingSink(inferred)))
flags = [[a for _k, (_v, _z, a) in rows] for rows in (out, inferred)]
assert flags == [[False, False, True]] * 2, (out, inferred)
""",
    "stats": """
s = op.input("inp", flow, TestingSource([("a", 1.5), ("b", 2.0), ("a", -1.0)]))
s = xla.stats_final("stats", s)
op.output("out", s, TestingSink(out))
run_main(flow)
assert sorted(out) == [("a", (-1.0, 0.25, 1.5, 2)), ("b", (2.0, 2.0, 2.0, 1))], out
""",
    "files": """
import os, tempfile
from bytewax_tpu_torch.connectors.files import FileSource
from bytewax_tpu_torch.models.wordcount import wordcount_flow
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "words.txt")
    with open(path, "w") as f:
        f.write("a b a\\nB c\\n")
    run_main(wordcount_flow(FileSource(path, columnar=True), TestingSink(out)))
assert sorted(out) == [("a", 2), ("b", 2), ("c", 1)], out
""",
    "windows": """
from datetime import datetime, timedelta, timezone
import bytewax_tpu_torch.operators.windowing as win
align = datetime(2022, 1, 1, tzinfo=timezone.utc)
inp = [align + timedelta(seconds=sec) for sec in (1, 2, 61)]
clock = win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=timedelta(0))
windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
s = op.input("inp", flow, TestingSource(inp))
wo = win.count_window("count", s, clock, windower, key=lambda _x: "all")
op.output("out", wo.down, TestingSink(out))
run_main(flow)
assert sorted(out) == [("all", (0, 2)), ("all", (1, 1))], out
""",
}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_running_a_flow_loads_neither_jax_nor_the_reference(flow):
    code = (
        """
import sys
import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
out = []
flow = Dataflow("f")
"""
        + FLOWS[flow]
        + """
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bytewax_tpu")]
assert not loaded, loaded
print("clean")
"""
    )
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
    """The name dates from the port's refusal of ``proc_count > 1``
    (queue A item 8, ported since): a 2-address ``cluster_main`` now
    forms its TCP mesh and runs, here as two threads of this process,
    with the device tier on each side; and one process with two worker
    lanes runs as before."""
    import socket
    import threading

    from bytewax_tpu_torch.testing import cluster_main

    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    addrs = [f"127.0.0.1:{port}" for port in ports]
    outs, errors = ([], []), []

    def run(proc_id):
        try:
            cluster_main(_stats_flow(outs[proc_id]), addrs, proc_id)
        except BaseException as ex:  # noqa: BLE001
            errors.append((proc_id, ex))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "the 2-process mesh hung"
    assert not errors, errors
    assert sorted(outs[0] + outs[1]) == [("a", (1.0, 1.0, 1.0, 1)), ("b", (2.0, 2.0, 2.0, 1))]
    # One process with two worker lanes runs.
    out = []
    cluster_main(_stats_flow(out), [], 0, worker_count_per_proc=2)
    assert sorted(out) == [("a", (1.0, 1.0, 1.0, 1)), ("b", (2.0, 2.0, 2.0, 1))]


#: A windowed flow, the same in both packages (``PKG`` names one), over
#: 120 rows of 4 stations, with an ABORT sentinel after row 60.
WINDOW_RESUME_FLOW = """
from datetime import datetime, timedelta, timezone
import PKG.operators as op
import PKG.operators.windowing as win
from PKG import xla
from PKG.dataflow import Dataflow
from PKG.recovery import RecoveryConfig
from PKG.testing import TestingSink, TestingSource, run_main

align = datetime(2022, 1, 1, tzinfo=timezone.utc)
rows = [(f"s{i % 4}", xla.TsValue(float(i % 7), align + timedelta(seconds=5 * i))) for i in range(120)]
abort = TestingSource.ABORT()
abort._triggered = SPENT
out = []
flow = Dataflow("win")
s = op.input("inp", flow, TestingSource(rows[:60] + [abort] + rows[60:], batch_size=10))
clock = win.EventClock(ts_getter=xla.column_ts, wait_for_system_duration=timedelta(seconds=5))
windower = win.TumblingWindower(length=timedelta(minutes=1), align_to=align)
op.output("out", win.stats_window("w", s, clock, windower).down, TestingSink(out))
run_main(flow, epoch_interval=timedelta(0), recovery_config=RecoveryConfig(DB))
"""


def test_resuming_a_reference_window_store_loads_neither_jax_nor_the_reference(tmp_path, monkeypatch):
    """The port resumes a window store that the JAX package wrote (its
    rows pickle the JAX package's window classes) without importing
    ``jax`` or ``bytewax_tpu``, and closes the windows that were still
    open at the abort."""
    from bytewax_tpu.recovery import init_db_dir as ref_init_db_dir

    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    ref_init_db_dir(tmp_path, 1)
    namespace = {}
    code = WINDOW_RESUME_FLOW.replace("PKG", "bytewax_tpu").replace("SPENT", "False")
    exec(code.replace("DB", repr(str(tmp_path))), namespace)
    head = namespace["out"]
    assert head
    resume = (
        "import sys\n"
        + WINDOW_RESUME_FLOW.replace("PKG", "bytewax_tpu_torch").replace("SPENT", "True").replace("DB", repr(str(tmp_path)))
        + """
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bytewax_tpu")]
assert not loaded, loaded
assert out, out
print(len(out))
"""
    )
    env = dict(os.environ, BYTEWAX_TPU_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", resume], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    # 120 rows at 5 s a row: 10 one-minute windows of each of the 4
    # stations, each closed once.
    assert len(head) + int(res.stdout.split()[-1]) == 40
