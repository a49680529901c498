"""The outer cluster supervisor / autoscaler of the torch port
(``python -m bytewax_tpu_torch.supervise``), held to
``tests/test_supervise.py``: the six fast cases of the pure decision
logic, the four slow cases that drive real multi-process clusters
(graceful grow and shrink through a drain and relaunch, the live
partial rescale both ways, a crash in the middle of a live move, and a
SIGKILLed child relaunched), each against the host oracle exactly
once; and the supervisor's own contract, that its process imports
neither torch nor jax.  Children run on the CPU
(``BYTEWAX_TPU_PLATFORM=cpu``) with the host tier
(``BYTEWAX_TPU_ACCEL=0``) for a light start.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from bytewax_tpu_torch.engine.driver import derive_rescale_hint
from bytewax_tpu_torch.supervise import (
    ClusterSupervisor,
    decide_scale,
    parse_bounds,
)

ROOT = Path(__file__).resolve().parent.parent

# -- pure decision logic ------------------------------------------------


def test_parse_bounds():
    assert parse_bounds("2:8") == (2, 8)
    assert parse_bounds("3") == (3, 3)
    with pytest.raises(ValueError, match="MIN:MAX"):
        parse_bounds("a:b")
    with pytest.raises(ValueError, match="1 <= MIN <= MAX"):
        parse_bounds("4:2")
    with pytest.raises(ValueError, match="1 <= MIN <= MAX"):
        parse_bounds("0:2")


def test_decide_scale_needs_k_consecutive():
    kw = dict(current=2, min_procs=1, max_procs=4, k=3)
    assert decide_scale([], **kw) is None
    assert decide_scale(["grow", "grow"], **kw) is None
    assert decide_scale(["grow", "grow", "grow"], **kw) == 3
    assert decide_scale(["hold", "grow", "grow", "grow"], **kw) == 3
    assert (
        decide_scale(["shrink", "shrink", "shrink"], **kw) == 1
    )


def test_decide_scale_flapping_never_moves():
    # The hint flapping the supervisor must absorb: grow→hold→grow
    # (and grow→shrink alternation) breaks every streak.
    kw = dict(current=2, min_procs=1, max_procs=4, k=2)
    assert decide_scale(["grow", "hold", "grow"], **kw) is None
    assert decide_scale(["grow", "shrink", "grow"], **kw) is None
    assert (
        decide_scale(
            ["grow", "hold", "grow", "hold", "grow"], **kw
        )
        is None
    )
    # ...and only an unbroken tail moves.
    assert decide_scale(["hold", "grow", "grow"], **kw) == 3


def test_decide_scale_respects_bounds():
    assert (
        decide_scale(
            ["grow"] * 3, current=4, min_procs=1, max_procs=4, k=3
        )
        is None
    )
    assert (
        decide_scale(
            ["shrink"] * 3, current=1, min_procs=1, max_procs=4, k=3
        )
        is None
    )
    # One step at a time, even with a long streak.
    assert (
        decide_scale(
            ["grow"] * 10, current=2, min_procs=1, max_procs=8, k=3
        )
        == 3
    )


def test_decide_scale_barrier_veto_interaction():
    # The engine's barrier veto (derive_rescale_hint: a
    # barrier-dominated process's loud signals are skew, not
    # saturation) emits "hold" — which must reset the supervisor's
    # grow streak, so a cluster that goes barrier-bound mid-streak
    # is never grown.
    loud = dict(
        worker_count=2,
        epoch_interval_s=10.0,
        close_p99_s=6.0,
        stall_s_per_close=0.0,
        restores_per_close=0.0,
    )
    advices = [
        derive_rescale_hint(**loud)[0],
        derive_rescale_hint(**loud)[0],
        derive_rescale_hint(
            **loud, phase_fractions={"barrier": 0.7, "host": 0.3}
        )[0],
    ]
    assert advices == ["grow", "grow", "hold"]
    assert (
        decide_scale(
            advices, current=2, min_procs=1, max_procs=4, k=3
        )
        is None
    )
    assert (
        decide_scale(
            advices, current=2, min_procs=1, max_procs=4, k=2
        )
        is None
    )


def test_scaling_bounds_require_recovery_dir():
    # A scale move without a recovery store would be a restart from
    # scratch (empty state, source replayed): refused up front.
    with pytest.raises(ValueError, match="recovery"):
        ClusterSupervisor("x:flow", min_procs=1, max_procs=2)
    # Fixed-size supervision (relaunch-only) stays legal stateless.
    sup = ClusterSupervisor("x:flow", min_procs=2, max_procs=2)
    assert sup.current == 2


_SUPERVISOR_IMPORTS = """
import sys

from bytewax_tpu_torch.run import _create_arg_parser
from bytewax_tpu_torch.supervise import ClusterSupervisor, autoscale_main

args = _create_arg_parser().parse_args(["flow.py:flow", "--autoscale", "2:2"])
sup = ClusterSupervisor(args.import_str, min_procs=2, max_procs=2)
cmd = sup._child_cmd()
assert cmd[1:3] == ["-m", "bytewax_tpu_torch.run"], cmd
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "bytewax_tpu"))
assert not loaded, loaded
print("clean")
"""


def test_supervisor_process_imports_neither_torch_nor_jax():
    """The supervisor is HTTP polls and process management: its import
    path (the CLI's ``--autoscale`` parser and ``ClusterSupervisor``)
    loads no torch, no jax and nothing of the JAX package, and its
    children run the port's CLI."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _SUPERVISOR_IMPORTS],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["clean"]


# -- real multi-process clusters ----------------------------------------


_SEQ_FLOW = '''
import os
from datetime import datetime, timedelta, timezone

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.connectors.files import FileSink
from bytewax_tpu_torch.inputs import FixedPartitionedSource, StatefulSourcePartition


class _Part(StatefulSourcePartition):
    def __init__(self, name, resume):
        self._name = name
        self._i = resume or 0
        self._awake = None

    def next_batch(self):
        if self._i >= int(os.environ["SUPERVISE_CAP"]):
            raise StopIteration()
        self._i += 1
        delay_ms = float(os.environ.get("SUPERVISE_DELAY_MS", "0"))
        if delay_ms:
            self._awake = datetime.now(timezone.utc) + timedelta(
                milliseconds=delay_ms
            )
        return [(f"{{self._name}}-{{self._i % 8}}", float(self._i % 13))]

    def next_awake(self):
        return self._awake

    def snapshot(self):
        return self._i


class SeqSource(FixedPartitionedSource):
    def list_parts(self):
        return ["p0", "p1"]

    def build_part(self, step_id, name, resume):
        return _Part(name, resume)


flow = Dataflow("supervise_df")
s = op.input("inp", flow, SeqSource())
s = op.stateful_map("ema", s, lambda st, v: (
    (v if st is None else st + 0.3 * (v - st),) * 2
))
s = op.map("fmt", s, lambda kv: (kv[0], f"{{kv[0]}}={{kv[1]:.3f}}"))
op.output("out", s, FileSink({out_path!r}))
'''


def _seq_oracle(cap):
    want = []
    for part in ("p0", "p1"):
        emas = {}
        for i in range(1, cap + 1):
            key = f"{part}-{i % 8}"
            v = float(i % 13)
            prev = emas.get(key)
            emas[key] = v if prev is None else prev + 0.3 * (v - prev)
            want.append(f"{key}={emas[key]:.3f}")
    return sorted(want)


def _child_env(cap, delay_ms):
    return {
        "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "BYTEWAX_TPU_PLATFORM": "cpu",
        "BYTEWAX_TPU_ACCEL": "0",  # keep subprocess startup light
        "SUPERVISE_CAP": str(cap),
        "SUPERVISE_DELAY_MS": str(delay_ms),
    }


def _make_sup(
    tmp_path,
    monkeypatch,
    *,
    name,
    cap,
    delay_ms,
    min_procs,
    max_procs,
    procs,
    hint_fn,
    extra_env=None,
):
    flow_py = tmp_path / f"{name}.py"
    out = tmp_path / f"{name}_out.txt"
    flow_py.write_text(_SEQ_FLOW.format(out_path=str(out)))
    db = tmp_path / f"{name}_db"
    db.mkdir()
    subprocess.run(
        [sys.executable, "-m", "bytewax_tpu_torch.recovery", str(db), "2"],
        env={**os.environ, **_child_env(cap, delay_ms)},
        check=True,
        timeout=60,
    )
    monkeypatch.setenv("BYTEWAX_TPU_AUTOSCALE_POLL_S", "0.2")
    monkeypatch.setenv("BYTEWAX_TPU_AUTOSCALE_HYSTERESIS", "2")
    monkeypatch.setenv("BYTEWAX_TPU_AUTOSCALE_COOLDOWN_S", "0")
    monkeypatch.setenv("BYTEWAX_TPU_AUTOSCALE_STOP_TIMEOUT_S", "60")
    sup = ClusterSupervisor(
        f"{flow_py}:flow",
        min_procs=min_procs,
        max_procs=max_procs,
        procs=procs,
        recovery_dir=str(db),
        snapshot_interval_s=0,
        backup_interval_s=0,
        env={**_child_env(cap, delay_ms), **(extra_env or {})},
        hint_fn=hint_fn,
        log_dir=str(tmp_path / f"{name}_logs"),
        workdir=str(tmp_path),
    )
    return sup, out


def _child_logs(tmp_path, name):
    return "".join(
        p.read_text(errors="replace")
        for p in sorted(Path(tmp_path).glob(f"{name}_logs/child-*.log"))
    )


@pytest.mark.slow
@pytest.mark.parametrize(
    "p_from,p_to,advice",
    [(2, 3, "grow"), (3, 2, "shrink")],
    ids=["grow-2to3", "shrink-3to2"],
)
def test_autoscale_elasticity_exactly_once(
    tmp_path, monkeypatch, p_from, p_to, advice
):
    # A running stateful cluster receives a grow (resp. shrink)
    # decision for K consecutive polls on the LEGACY restart path
    # (BYTEWAX_TPU_AUTOSCALE_LIVE=0): the supervisor gracefully
    # drains it (stop vote on the epoch-close round, snapshots
    # committed), relaunches at the new size with the startup
    # migration, and the completed run's output equals the host
    # oracle exactly-once.
    monkeypatch.setenv("BYTEWAX_TPU_AUTOSCALE_LIVE", "0")
    name = f"auto_{p_from}to{p_to}"
    cap = 500
    sup, out = _make_sup(
        tmp_path,
        monkeypatch,
        name=name,
        cap=cap,
        delay_ms=8,
        min_procs=min(p_from, p_to),
        max_procs=max(p_from, p_to),
        procs=p_from,
        hint_fn=lambda: advice,
    )
    with sup:
        rc = sup.run()
    logs = _child_logs(tmp_path, name)
    assert rc == 0, logs[-3000:]
    assert (advice, p_from, p_to) in sup.actions
    assert sup.current == p_to
    # The move really was the graceful path + startup migration, not
    # a crash-and-replay: the children logged the rescale, and no
    # hard relaunch action fired.
    assert "rescaled recovery store" in logs, logs[-3000:]
    assert all(a[0] != "relaunch" for a in sup.actions)
    assert sorted(out.read_text().split()) == _seq_oracle(cap), (
        f"output diverged from oracle across the {p_from}->{p_to} move"
    )


@pytest.mark.slow
@pytest.mark.parametrize(
    "p_from,p_to,advice",
    [(2, 3, "grow"), (3, 2, "shrink")],
    ids=["grow-2to3", "shrink-3to2"],
)
def test_live_rescale_moves_without_bouncing_survivors(
    tmp_path, monkeypatch, p_from, p_to, advice
):
    # The live partial-rescale path (the default; docs/recovery.md
    # "Live partial rescale"): the membership change rides an epoch
    # close — the joiner boots while the cluster keeps serving, the
    # survivors re-enter run startup IN-PROCESS (same pids before and
    # after), the retiree exits cleanly after the agreed close, and
    # the completed run's output equals the host oracle exactly-once
    # in both directions.  Non-moving workers must close at least one
    # epoch DURING the move (the supervisor samples a survivor's
    # epoch before spawning/posting and after completion).
    name = f"live_{p_from}to{p_to}"
    cap = 500
    sup, out = _make_sup(
        tmp_path,
        monkeypatch,
        name=name,
        cap=cap,
        delay_ms=8,
        min_procs=min(p_from, p_to),
        max_procs=max(p_from, p_to),
        procs=p_from,
        hint_fn=lambda: advice,
    )
    with sup:
        rc = sup.run()
    logs = _child_logs(tmp_path, name)
    assert rc == 0, logs[-3000:]
    assert (advice, p_from, p_to) in sup.actions
    assert sup.current == p_to
    move = sup.last_live_move
    assert move is not None, (
        "the move fell back to the restart path:\n" + logs[-3000:]
    )
    # Survivors were never bounced: every pre-move pid that survived
    # the resize is still the same OS process afterwards.
    surviving = min(p_from, p_to)
    assert (
        move["pids_after"][:surviving]
        == move["pids_before"][:surviving]
    )
    # The non-moving workers kept closing epochs during the move:
    # the agreed reconfiguration itself rides an epoch close, so the
    # survivor's epoch strictly advances between the two samples.
    assert move["epoch_before"] is not None
    assert move["epoch_after"] is not None
    assert move["epoch_after"] > move["epoch_before"], move
    # In-process re-entry, not a relaunch — and the delta migration
    # ran (the rescale log line comes from the surviving proc 0 /
    # the rebuilt coordinator, not a fresh process).
    assert "live reconfigure agreed" in logs, logs[-3000:]
    assert "rescaled recovery store" in logs, logs[-3000:]
    assert all(a[0] != "relaunch" for a in sup.actions)
    assert sorted(out.read_text().split()) == _seq_oracle(cap), (
        f"output diverged from oracle across the live "
        f"{p_from}->{p_to} move"
    )


@pytest.mark.slow
def test_live_rescale_crash_mid_partial_migration_exactly_once(
    tmp_path, monkeypatch
):
    # Chaos on the LIVE move, through the real pinned fault site: the
    # coordinator (proc 0, the one process that runs the delta
    # migration) takes an injected CRASH at rescale_migrate inside
    # the store transaction during its in-process re-entry.  The
    # rolled-back migration retries under the in-process supervisor
    # WITH the agreed membership (proc 0 never leaves the process);
    # the NON-coordinator peers — blocked in the post-"fcfg" gsync
    # wait behind the migration — observe the torn mesh, restart
    # in-process against the new address list, and the re-formed
    # cluster completes the move: output equals the host oracle
    # exactly-once.
    name = "live_crash"
    cap = 500
    sup, out = _make_sup(
        tmp_path,
        monkeypatch,
        name=name,
        cap=cap,
        delay_ms=8,
        min_procs=2,
        max_procs=3,
        procs=2,
        hint_fn=lambda: "grow",
        extra_env={
            "BYTEWAX_TPU_FAULTS": "rescale_migrate:crash:*:0:x1",
            "BYTEWAX_TPU_MAX_RESTARTS": "3",
            "BYTEWAX_TPU_RESTART_BACKOFF_S": "0.1",
        },
    )
    with sup:
        rc = sup.run()
    logs = _child_logs(tmp_path, name)
    assert rc == 0, logs[-3000:]
    assert ("grow", 2, 3) in sup.actions
    # The crash really fired mid-move and was healed by the
    # in-process supervisor — not by the outer relaunch path.
    assert "supervised restart" in logs, logs[-3000:]
    assert "rescaled recovery store" in logs, logs[-3000:]
    assert all(a[0] != "relaunch" for a in sup.actions)
    assert sorted(out.read_text().split()) == _seq_oracle(cap), (
        "output diverged from oracle across the crash-mid-migration "
        "live move"
    )


@pytest.mark.slow
def test_supervisor_relaunches_sigkilled_child_exactly_once(
    tmp_path, monkeypatch
):
    # Chaos: SIGKILL one child mid-epoch (a real OS fault through no
    # engine seam).  The outer supervisor relaunches it; the peer
    # observes the socket close and restarts under its in-process
    # supervisor; the re-formed cluster resumes from the last
    # committed epoch and the final output is exactly-once.
    name = "sigkill"
    cap = 500
    sup, out = _make_sup(
        tmp_path,
        monkeypatch,
        name=name,
        cap=cap,
        delay_ms=8,
        min_procs=2,
        max_procs=2,
        procs=2,
        hint_fn=lambda: "hold",
    )
    results = []
    with sup:
        thread = threading.Thread(
            target=lambda: results.append(sup.run()), daemon=True
        )
        thread.start()
        # Wait for real progress (output flowing => mid-epoch, both
        # children up), then kill one child outright.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if (
                out.exists()
                and len(out.read_text().split()) > 20
                and len(sup.children) == 2
                and all(p.poll() is None for p in sup.children)
            ):
                break
            time.sleep(0.05)
        else:
            pytest.fail("cluster never made progress")
        os.kill(sup.children[1].pid, signal.SIGKILL)
        thread.join(timeout=180)
        assert not thread.is_alive(), "supervisor wedged after SIGKILL"
    logs = _child_logs(tmp_path, name)
    assert results == [0], logs[-3000:]
    assert ("relaunch", 2, 2) in sup.actions
    assert sorted(out.read_text().split()) == _seq_oracle(cap), (
        "output diverged from oracle across the SIGKILL + relaunch"
    )
