"""Two-process chaos of the torch port held against the JAX package:
the cluster cases of ``tests/test_chaos.py`` and
``tests/test_io_resilience.py`` that do not overlap collectives (those
are in ``tests/test_torch_chaos_overlap.py``).

Each case writes one flow module for each package (the JAX test's
flow text with the package's imports), spawns each package's own
``python -m <package>.testing -p 2`` cluster on the CPU against a
store of its own, and holds both outputs to the fault-free oracle:
exactly once across an injected worker death and a dropped frame
healed by the stall watchdog.  The three seeded random soaks keep the
JAX package's ``slow`` mark: each runs a minute or more of paced
chaos a package, past what a tier-1 file may take.
"""

import os
import subprocess
from pathlib import Path

import pytest

from tests.test_cluster import _COLUMNAR_SEQ_FLOW, _columnar_seq_oracle
from tests.test_chaos import _SEQ_FLOW, _seq_oracle
from tests.test_io_resilience import _SOAK_FLOW
from tests.test_torch_both import (  # noqa: F401
    BOTH,
    REPO,
    for_pkg,
    fresh_faults,
    port_on_cpu,
    unsharded,
)


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEWAX_TPU_PLATFORM"] = "cpu"
    env["BYTEWAX_TPU_ACCEL"] = "0"
    env.pop("BYTEWAX_TPU_FAULTS", None)
    env.pop("BYTEWAX_TPU_MAX_RESTARTS", None)
    if extra:
        env.update(extra)
    return env


def run_cluster(m, tmp_path, name, flow_text, extra_env, timeout=150, store=True,
                args=("-s", "0", "-b", "0")):
    """Runs ``flow_text`` on a two-process cluster of ``m``'s; returns
    the finished process and the path of the flow's ``FileSink``."""
    d = tmp_path / m.label
    d.mkdir(exist_ok=True)
    flow_py = d / f"{name}.py"
    out_path = str(d / f"{name}_out.txt")
    flow_py.write_text(for_pkg(flow_text, m).format(out_path=out_path))
    cmd = m.module_cmd("testing", f"{flow_py}:flow", "-p", "2", *args)
    if store:
        db = d / f"{name}_db"
        db.mkdir()
        subprocess.run(m.module_cmd("recovery", str(db), "2"), env=_env(), check=True,
                       timeout=60)
        cmd += ["-r", str(db)]
    res = subprocess.run(cmd, env=_env(extra_env), cwd=d, capture_output=True, text=True,
                         timeout=timeout)
    return res, Path(out_path)


def _both_exactly_once(tmp_path, name, flow_text, cap, extra_env, oracle, restarts=None,
                       timeout=150):
    for m in BOTH:
        res, out = run_cluster(m, tmp_path, name, flow_text, {"CHAOS_CAP": str(cap),
                                                              **extra_env}, timeout=timeout)
        assert res.returncode == 0, (m, res.stderr[-3000:])
        if restarts is not None:
            assert res.stderr.count("supervised restart") >= restarts, (m, res.stderr[-3000:])
        assert sorted(out.read_text().split()) == oracle(cap), m


def test_cluster_injected_worker_crash_supervised_exactly_once(tmp_path):
    _both_exactly_once(
        tmp_path, "crash", _SEQ_FLOW, 30,
        {
            "BYTEWAX_TPU_FAULTS": "comm.send:crash:4:1:x1",
            "BYTEWAX_TPU_MAX_RESTARTS": "3",
            "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
        },
        _seq_oracle,
        restarts=1,
    )


def test_cluster_injected_stall_heals_via_watchdog(tmp_path):
    _both_exactly_once(
        tmp_path, "stall", _SEQ_FLOW, 30,
        {
            "BYTEWAX_TPU_FAULTS": "comm.send:drop:4:1:x1",
            "BYTEWAX_TPU_MAX_RESTARTS": "3",
            "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
            "BYTEWAX_TPU_EPOCH_STALL_S": "3",
        },
        _seq_oracle,
        timeout=180,
    )


_SOAK_CHAOS = {
    "CHAOS_PACE_S": "0.03",
    "BYTEWAX_TPU_FAULTS": "random",
    "BYTEWAX_TPU_FAULTS_RATE": "0.05",
    "BYTEWAX_TPU_FAULTS_MIN_GAP_S": "6",
    "BYTEWAX_TPU_FAULTS_KINDS": "delay,crash",
    "BYTEWAX_TPU_FAULT_DELAY_S": "0.02",
    "BYTEWAX_TPU_MAX_RESTARTS": "10",
    "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
    "BYTEWAX_TPU_RESTART_RESET_S": "4",
    "BYTEWAX_TPU_EPOCH_STALL_S": "10",
    "BYTEWAX_TPU_HB_S": "20",
    "BYTEWAX_TPU_DIAL_TIMEOUT_S": "10",
}


@pytest.mark.slow
def test_cluster_chaos_soak_random_faults(tmp_path):
    _both_exactly_once(
        tmp_path, "soak", _SEQ_FLOW, 800,
        {**_SOAK_CHAOS, "BYTEWAX_TPU_FAULTS_SEED": "1711"},
        _seq_oracle,
        restarts=2,
        timeout=280,
    )


@pytest.mark.slow
def test_cluster_chaos_soak_columnar_wire(tmp_path):
    _both_exactly_once(
        tmp_path, "wire_soak", _COLUMNAR_SEQ_FLOW, 200,
        {
            **_SOAK_CHAOS,
            "BYTEWAX_TPU_FAULTS_SEED": "2201",
            "BYTEWAX_TPU_FAULTS_SITES": "comm.send,comm.recv",
        },
        _columnar_seq_oracle,
        restarts=1,
        timeout=280,
    )


@pytest.mark.slow
def test_cluster_io_fault_soak_zero_restarts(tmp_path):
    cap = 200
    env = {
        "SOAK_CAP": str(cap),
        "BYTEWAX_TPU_FAULTS": "random",
        "BYTEWAX_TPU_FAULTS_SEED": "1713",
        "BYTEWAX_TPU_FAULTS_SITES": "source_poll,sink_write",
        "BYTEWAX_TPU_FAULTS_KINDS": "error,delay",
        "BYTEWAX_TPU_FAULTS_RATE": "0.2",
        "BYTEWAX_TPU_FAULTS_MIN_GAP_S": "0.2",
        "BYTEWAX_TPU_FAULT_DELAY_S": "0.01",
        "BYTEWAX_TPU_IO_RETRIES": "8",
        "BYTEWAX_TPU_IO_BACKOFF_S": "0.01",
        "BYTEWAX_TPU_MAX_RESTARTS": "3",
        "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
    }
    want = []
    for part in ("p0", "p1"):
        sums = {}
        for i in range(1, cap + 1):
            key = f"{part}-{i % 4}"
            sums[key] = sums.get(key, 0) + i
            want.append(f"{key}={sums[key]}")
    for m in BOTH:
        res, out = run_cluster(m, tmp_path, "io_soak", _SOAK_FLOW, env, timeout=240)
        assert res.returncode == 0, (m, res.stderr[-3000:])
        assert "supervised restart" not in res.stderr, (m, res.stderr[-3000:])
        assert sorted(out.read_text().split()) == sorted(want), m
