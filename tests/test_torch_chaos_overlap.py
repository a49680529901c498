"""Chaos under overlapped collectives (``BYTEWAX_TPU_GSYNC_OVERLAP=1``)
of the torch port held against the JAX package: the two overlap cases
of ``tests/test_chaos.py`` on each package's own two-process cluster,
on the CPU (the port's collectives over gloo).

A worker dies inside a comm send while sealed rounds ride the
collective lane; the supervisors restart both processes and the
output equals the host oracle exactly once: without a store (sources
replay, the aggregation emits at EOF) and with one (committed epochs
come back through the global tier's round and baseline rows), at depth
1 and at depth 2 with int8 rounds over integer values.  Counts, min
and max exact; means within 1e-6 exact and 5% quantized, as the
reference test holds them.
"""

import subprocess
from pathlib import Path

import pytest

from tests.test_chaos import _GX_STORE_FLOW
from tests.test_cluster import _GX_PACED_FLOW, _gx_paced_oracle
from tests.test_torch_both import (  # noqa: F401
    BOTH,
    for_pkg,
    fresh_faults,
    port_on_cpu,
    unsharded,
)
from tests.test_torch_chaos_cluster import _env

GX_ENV = {
    "BYTEWAX_TPU_ACCEL": "1",
    "BYTEWAX_TPU_DISTRIBUTED": "1",
    "BYTEWAX_TPU_GLOBAL_EXCHANGE": "1",
    "BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG": "1",
    "BYTEWAX_TPU_GSYNC_OVERLAP": "1",
    "BYTEWAX_TPU_INGEST_TARGET_ROWS": "0",
    "GX_PACE_S": "0.1",
    "GX_BATCHES": "5",
    "BYTEWAX_TPU_MAX_RESTARTS": "3",
    "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
    "BYTEWAX_TPU_EPOCH_STALL_S": "15",
}


def _run(m, tmp_path, name, flow_text, extra, store):
    d = tmp_path / m.label
    d.mkdir(exist_ok=True)
    flow_py = d / f"{name}.py"
    out_path = str(d / f"{name}_out.txt")
    flow_py.write_text(for_pkg(flow_text, m).format(out_path=out_path))
    cmd = m.module_cmd("testing", f"{flow_py}:flow", "-p", "2", "-s", "0.2")
    if store:
        db = d / f"{name}_db"
        db.mkdir()
        subprocess.run(m.module_cmd("recovery", str(db), "2"), env=_env(), check=True,
                       timeout=60)
        cmd += ["-r", str(db), "-b", "0"]
    res = subprocess.run(cmd, env=_env({**GX_ENV, **extra}), cwd=d, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, (m, res.stderr[-3000:])
    assert "supervised restart" in res.stderr, (m, res.stderr[-3000:])
    assert res.stderr.count("global-exchange:") >= 2, (m, res.stderr[-2000:])
    got = {}
    for line in Path(out_path).read_text().split():
        key, mn, mean, mx, count = line.split(";")
        assert key not in got, f"key {key} emitted twice by {m}"
        got[key] = (float(mn), float(mean), float(mx), int(count))
    return got


def _check(got, mean_tol):
    oracle = _gx_paced_oracle(batches=5)
    assert set(got) == set(oracle)
    for k, (mn, mean, mx, count) in oracle.items():
        assert got[k][3] == count, (k, got[k])
        assert got[k][0] == mn and got[k][2] == mx, (k, got[k])
        assert abs(got[k][1] - mean) <= mean_tol(mean), (k, got[k])


def test_cluster_overlapped_round_comm_fault_exactly_once(tmp_path):
    extra = {"GX_HOLD_CLOSES": "5", "BYTEWAX_TPU_FAULTS": "comm.send:crash:3:1:x1"}
    outs = [_run(m, tmp_path, "gx_chaos", _GX_PACED_FLOW, extra, store=False) for m in BOTH]
    for got in outs:
        _check(got, lambda mean: 1e-6)
    assert outs[1] == outs[0]


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"BYTEWAX_TPU_GSYNC_DEPTH": "2", "BYTEWAX_TPU_GSYNC_QUANT": "int8", "GX_INTS": "1"},
    ],
    ids=["depth1", "depth2-int8"],
)
def test_cluster_overlap_store_crash_resume_exactly_once(tmp_path, extra):
    name = "gx_store_" + "_".join(extra.values()).replace("int8", "q")
    knobs = {"GX_HOLD_CLOSES": "6", "BYTEWAX_TPU_FAULTS": "comm.send:crash:4:1:x1", **extra}
    outs = [_run(m, tmp_path, name, _GX_STORE_FLOW, knobs, store=True) for m in BOTH]
    for got in outs:
        _check(got, lambda mean: 0.05 * max(abs(mean), 1.0))
    assert {k: (v[0], v[2], v[3]) for k, v in outs[1].items()} == {
        k: (v[0], v[2], v[3]) for k, v in outs[0].items()
    }
