"""The torch port's command line, ``python -m bytewax_tpu_torch.run``:
a flow run through it gives ``run_main``'s output, ``-r``/``-s``/``-b``
resume a recovery store across two runs, and without a CUDA card and
without ``BYTEWAX_TPU_PLATFORM=cpu`` a device-tier flow fails instead
of running on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from bytewax_tpu_torch.utils import force_platform

ROOT = Path(__file__).resolve().parent.parent

FLOW = """
import os

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.testing import TestingSource

ROWS = [(f"k{i % 7}", float(i % 5) * 0.5) for i in range(200)]


def make(out, rows=ROWS):
    flow = Dataflow("cli_df")
    s = op.input("inp", flow, TestingSource(rows, batch_size=16))
    if os.environ.get("CLI_TIER", "device") == "device":
        s = xla.stats_final("stats", s)
        s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    else:
        s = op.stateful_map("sum", s, lambda st, v: ((st or 0.0) + v,) * 2)
        s = op.map("fmt", s, lambda kv: (kv[0], f"{kv[0]}={kv[1]}"))
    op.output("out", s, FileSink(out))
    return flow


flow = make(OUT, ROWS[:120] + [TestingSource.EOF()] + ROWS[120:] if os.environ.get("CLI_EOF") else ROWS)
"""


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _write(tmp_path, out):
    flow_py = tmp_path / "cli_flow.py"
    flow_py.write_text(FLOW.replace("OUT", repr(str(out))))
    return flow_py


def _cli(tmp_path, flow_py, *args, env=None):
    base = dict(os.environ, PYTHONPATH=str(ROOT), BYTEWAX_TPU_PLATFORM="cpu")
    for k in ("BYTEWAX_TPU_FAULTS", "BYTEWAX_TPU_MAX_RESTARTS", "CLI_EOF", "CLI_TIER"):
        base.pop(k, None)
    base.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.run", f"{flow_py}:flow", *args],
        cwd=tmp_path,
        env={k: v for k, v in base.items() if v is not None},
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_cli_run_matches_run_main(tmp_path):
    import importlib.util

    from bytewax_tpu_torch.testing import run_main

    out = tmp_path / "cli_out.txt"
    res = _cli(tmp_path, _write(tmp_path, out))
    assert res.returncode == 0, res.stderr[-2000:]
    cli_lines = sorted(out.read_text().splitlines())

    in_process = tmp_path / "run_main_out.txt"
    spec = importlib.util.spec_from_file_location("cli_flow_mod", _write(tmp_path, tmp_path / "unused.txt"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    run_main(mod.make(str(in_process)))
    assert cli_lines == sorted(in_process.read_text().splitlines())
    assert len(cli_lines) == 7


def test_cli_resumes_a_store(tmp_path):
    """Two CLI runs against one store (``-r db -s 0 -b 0``): the first
    stops at the EOF sentinel after 120 rows, the second resumes the
    running sums from the store and appends the rest, every row once."""
    out = tmp_path / "cli_out.txt"
    flow_py = _write(tmp_path, out)
    db = tmp_path / "db"
    db.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "1"],
        env=env,
        check=True,
        timeout=60,
    )
    args = ("-r", str(db), "-s", "0", "-b", "0")
    knobs = {"CLI_EOF": "1", "CLI_TIER": "host"}
    res = _cli(tmp_path, flow_py, *args, env=knobs)
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(out.read_text().split()) == 120
    res = _cli(tmp_path, flow_py, *args, env=knobs)
    assert res.returncode == 0, res.stderr[-2000:]
    sums, want = {}, []
    for i in range(200):
        key = f"k{i % 7}"
        sums[key] = sums.get(key, 0.0) + float(i % 5) * 0.5
        want.append(f"{key}={sums[key]}")
    assert sorted(out.read_text().split()) == sorted(want)


def test_cli_device_flow_without_a_card_raises(tmp_path):
    out = tmp_path / "cli_out.txt"
    res = _cli(tmp_path, _write(tmp_path, out), env={"BYTEWAX_TPU_PLATFORM": None, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not out.exists() or not out.read_text()
