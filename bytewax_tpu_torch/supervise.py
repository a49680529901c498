"""Self-healing cluster supervisor + autoscaler (the outer loop).

``python -m bytewax_tpu_torch.supervise my_flow:flow --autoscale 2:8``
(equivalently ``python -m bytewax_tpu_torch.run my_flow:flow --autoscale
2:8``) spawns the whole cluster and closes the autoscaling loop over
primitives the engine already has:

- **Watch**: children are waited on and their ``/healthz`` /
  ``/status`` planes polled.  A hard-dead child (OOM kill, SIGKILL, a
  crash that out-ran its in-process restart budget) is relaunched in
  place with capped jittered backoff; its peers detect the socket
  close, restart under their own in-process supervisors
  (``BYTEWAX_TPU_MAX_RESTARTS``), and the mesh re-forms at the
  handshake — the outer supervisor closes the hole where a hard-dead
  process left peers wedged until the stall watchdog fired.
- **Decide**: the engine's ``rescale_hint`` advice is sampled every
  ``BYTEWAX_TPU_AUTOSCALE_POLL_S``; only
  ``BYTEWAX_TPU_AUTOSCALE_HYSTERESIS`` *consecutive* identical
  grow/shrink samples inside the ``--autoscale MIN:MAX`` bounds and
  past the ``BYTEWAX_TPU_AUTOSCALE_COOLDOWN_S`` cooldown trigger a
  move (:func:`decide_scale` — flapping advice never does).
- **Act**: a coordinated move defaults to the **live partial
  rescale** (docs/recovery.md "Live partial rescale";
  ``BYTEWAX_TPU_AUTOSCALE_LIVE=0`` opts out): the joiner boots while
  the cluster keeps serving, the membership change is posted
  (``POST /reconfigure``) and agreed on an epoch-close sync round,
  survivors re-enter run startup in-process, the retiree exits after
  the agreed close, and the store migration rewrites only
  changed-route keys.  A live move that cannot complete falls back
  to the legacy whole-cluster path: graceful drain-to-stop
  (``POST /stop`` — any one process's vote stops the whole cluster
  at the next epoch close, snapshots committed, zero replayed
  epochs; SIGTERM is the fallback, SIGKILL the
  ``BYTEWAX_TPU_AUTOSCALE_STOP_TIMEOUT_S`` escalation — extended
  while a child reports the ``migrating`` health state) followed by
  a relaunch at the new size with ``BYTEWAX_TPU_RESCALE=1``, so the
  startup migration re-shards the keyed state (docs/recovery.md).

Process-local by contract: the supervisor is HTTP polls, a
connect-and-close listener probe, and OS process management only —
it never constructs a comm mesh, never touches a send primitive or a
sync round, and never imports torch or touches CUDA (the children
import the dataflow and own the card).
``tests/test_torch_supervise.py`` pins the import side in a fresh
interpreter.
"""

import argparse
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.backoff import Backoff, seeded_rng

__all__ = [
    "ClusterSupervisor",
    "autoscale_main",
    "decide_scale",
    "parse_bounds",
]

logger = logging.getLogger("bytewax_tpu_torch")

#: Grace given to SIGTERM'd children before SIGKILL (seconds).
_TERM_GRACE_S = 10.0
#: HTTP timeout for one /status / /stop call (seconds).
_HTTP_TIMEOUT_S = 2.0
#: Whole-cluster relaunch attempts per failure burst before giving up
#: (burst-scoped like the in-process restart budget: a healthy
#: ``BYTEWAX_TPU_RESTART_RESET_S`` window resets it).
_CLUSTER_RELAUNCH_BUDGET = 5


def parse_bounds(spec: str) -> Tuple[int, int]:
    """Parse an ``--autoscale MIN:MAX`` process-count bound.

    >>> from bytewax_tpu_torch.supervise import parse_bounds
    >>> parse_bounds("2:8")
    (2, 8)
    """
    lo_s, sep, hi_s = spec.partition(":")
    try:
        lo, hi = int(lo_s), int(hi_s if sep else lo_s)
    except ValueError:
        msg = f"--autoscale expects MIN:MAX (got {spec!r})"
        raise ValueError(msg) from None
    if not 1 <= lo <= hi:
        msg = f"--autoscale bounds must satisfy 1 <= MIN <= MAX (got {spec!r})"
        raise ValueError(msg)
    return lo, hi


def decide_scale(
    history: Sequence[str],
    *,
    current: int,
    min_procs: int,
    max_procs: int,
    k: int,
) -> Optional[int]:
    """Pure hysteresis over recent ``rescale_hint`` advice samples:
    the target process count, or ``None`` for no move.

    Only ``k`` *consecutive* identical ``grow``/``shrink`` samples
    (the most recent ``k``) trigger, and only within the bounds — so
    flapping advice (``grow``→``hold``→``grow``) never moves the
    cluster, and a barrier-vetoed ``hold`` in the window resets the
    streak.  Moves are one process at a time: each relaunch pays a
    full drain + migration, and the next hysteresis window measures
    the new size before stepping again.

    >>> from bytewax_tpu_torch.supervise import decide_scale
    >>> decide_scale(["grow", "grow"], current=2, min_procs=1,
    ...              max_procs=4, k=2)
    3
    >>> decide_scale(["grow", "hold", "grow"], current=2, min_procs=1,
    ...              max_procs=4, k=2) is None
    True
    """
    if k <= 0 or len(history) < k:
        return None
    tail = list(history)[-k:]
    if all(a == "grow" for a in tail) and current < max_procs:
        return current + 1
    if all(a == "shrink" for a in tail) and current > min_procs:
        return current - 1
    return None


def _post_stop(port: int) -> bool:
    """``POST /stop`` to one child's API plane; True when the child
    acknowledged the drain request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stop", data=b"", method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=_HTTP_TIMEOUT_S) as rsp:
            return json.loads(rsp.read() or b"{}").get(
                "stopping", False
            )
    except (urllib.error.URLError, OSError, ValueError):
        return False


def _post_reconfigure(
    port: int, addresses: List[str], wpp: Optional[int]
) -> bool:
    """``POST /reconfigure`` one child's pending membership target
    (docs/recovery.md "Live partial rescale"); True when the child
    acknowledged.  Idempotent — the live move re-posts every watch
    tick until the cluster-wide agreement lands."""
    body: Dict[str, Any] = {"addresses": addresses}
    if wpp is not None:
        body["workers_per_process"] = wpp
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/reconfigure",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=_HTTP_TIMEOUT_S) as rsp:
            return json.loads(rsp.read() or b"{}").get(
                "reconfiguring", False
            )
    except (urllib.error.URLError, OSError, ValueError):
        return False


def _comm_port_listening(address: str) -> bool:
    """Whether something is LISTENING on a cluster comm address — the
    probe the live move uses to know a joining process has reached
    its mesh handshake (its listener binds before anything else; the
    supervisor's own port holder never listens, so a refused connect
    means the child is not there yet).  The joiner's accept loop
    tolerates the immediately-closed probe connection."""
    host, _, port = address.rpartition(":")
    try:
        sock = socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=0.5
        )
    except OSError:
        return False
    try:
        sock.close()
    except OSError:
        pass
    return True


def _get_status(port: int) -> Optional[Dict[str, Any]]:
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/status", timeout=_HTTP_TIMEOUT_S
        ) as rsp:
            return json.loads(rsp.read())
    except (urllib.error.URLError, OSError, ValueError):
        return None


def _get_health(port: int) -> Optional[Dict[str, Any]]:
    """``GET /healthz``; a 503 (starting / draining) still returns
    its payload — only an unanswering plane is ``None``."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz",
            timeout=_HTTP_TIMEOUT_S,
        ) as rsp:
            return json.loads(rsp.read())
    except urllib.error.HTTPError as ex:
        try:
            return json.loads(ex.read())
        except ValueError:
            return None
    except (urllib.error.URLError, OSError, ValueError):
        return None


class ClusterSupervisor:
    """Spawn, watch, heal, and resize one dataflow cluster.

    ``hint_fn`` (tests, embedders) overrides how the scale advice is
    sampled; the default polls any answering child's ``/status`` for
    ``rescale_hint.advice``.  ``env`` is overlaid on every child's
    environment; ``log_dir`` redirects each child's stderr/stdout to
    ``child-<i>.log`` files (appended across relaunches);
    ``workdir`` is the children's working directory (default:
    inherit the supervisor's — set it when flows use relative paths
    or to keep the API server's ``dataflow.json`` dump out of the
    invoking directory).
    """

    def __init__(
        self,
        import_str: str,
        *,
        min_procs: int,
        max_procs: int,
        procs: Optional[int] = None,
        workers_per_process: Optional[int] = None,
        recovery_dir: Optional[str] = None,
        snapshot_interval_s: Optional[float] = None,
        backup_interval_s: Optional[float] = None,
        env: Optional[Dict[str, str]] = None,
        hint_fn: Optional[Callable[[], Optional[str]]] = None,
        log_dir: Optional[str] = None,
        workdir: Optional[str] = None,
    ):
        if not 1 <= min_procs <= max_procs:
            msg = f"need 1 <= min {min_procs} <= max {max_procs}"
            raise ValueError(msg)
        if min_procs != max_procs and recovery_dir is None:
            # A scale move without a recovery store is not a rescale
            # — it is a restart from scratch: the relaunched flow
            # would start with empty state and re-read the whole
            # source, duplicating output mid-stream.  Fixed-size
            # supervision (min == max: relaunch-only) stays legal.
            msg = (
                "--autoscale with MIN != MAX requires a recovery "
                "directory (-r): scale moves carry keyed state "
                "through the store's startup migration; without one "
                "a relaunch replays the source from the beginning"
            )
            raise ValueError(msg)
        self.import_str = import_str
        self.min_procs = min_procs
        self.max_procs = max_procs
        self.wpp = workers_per_process
        self.recovery_dir = recovery_dir
        self.snapshot_interval_s = snapshot_interval_s
        self.backup_interval_s = backup_interval_s
        self.env_extra = dict(env or {})
        self.hint_fn = hint_fn
        self.log_dir = log_dir
        self.workdir = workdir
        self.current = min(max(procs or min_procs, min_procs), max_procs)

        self.poll_s = float(
            os.environ.get("BYTEWAX_TPU_AUTOSCALE_POLL_S", "2") or 2
        )
        self.hysteresis = max(
            1,
            int(
                os.environ.get("BYTEWAX_TPU_AUTOSCALE_HYSTERESIS", "3")
                or 3
            ),
        )
        self.cooldown_s = float(
            os.environ.get("BYTEWAX_TPU_AUTOSCALE_COOLDOWN_S", "30")
            or 30
        )
        self.stop_timeout_s = float(
            os.environ.get(
                "BYTEWAX_TPU_AUTOSCALE_STOP_TIMEOUT_S", "60"
            )
            or 60
        )
        #: Live partial rescale (docs/recovery.md): a scale move is an
        #: epoch-boundary membership change — the joiner boots while
        #: the cluster keeps serving, survivors re-enter run startup
        #: in-process, and only changed-route keys migrate.  Default
        #: on; ``BYTEWAX_TPU_AUTOSCALE_LIVE=0`` forces every move
        #: down the legacy whole-cluster drain-to-stop + relaunch
        #: path (also the automatic fallback when a live move cannot
        #: complete).
        self.live = os.environ.get(
            "BYTEWAX_TPU_AUTOSCALE_LIVE", "1"
        ) not in ("", "0")
        #: Diagnostics of the most recent completed live move
        #: (tests/bench): action, sizes, surviving pids, and a
        #: surviving child's epoch sampled before/after — epochs
        #: advancing across the move proves the non-moving workers
        #: kept closing epochs while it happened.
        self.last_live_move: Optional[Dict[str, Any]] = None
        # Relaunch flap control: the burst-scoped restart-budget
        # pattern the in-process supervisor uses — capped jittered
        # exponential backoff that resets after a healthy window.
        self._reset_s = float(
            os.environ.get("BYTEWAX_TPU_RESTART_RESET_S", "300") or 300
        )
        base = float(
            os.environ.get("BYTEWAX_TPU_RESTART_BACKOFF_S", "0.5")
            or 0.5
        )
        self._backoff = Backoff(base, rng=seeded_rng("autoscale", 0))
        self._last_fault_at = float("-inf")

        self.children: List[subprocess.Popen] = []
        self.addresses: List[str] = []
        self._holders: List[socket.socket] = []
        self.api_base_port: Optional[int] = None
        #: (action, from_procs, to_procs) log of every act taken.
        self.actions: List[Tuple[str, int, int]] = []
        self._history: List[str] = []
        self._last_scale_at = float("-inf")
        #: (rank, epoch) of the last counted advice sample — the
        #: epoch dedup that makes hysteresis count distinct closes.
        self._last_sample_marker: Optional[Tuple[int, Any]] = None
        self._generation = 0
        self._stop_event = threading.Event()

    # -- process management ------------------------------------------------

    def _close_holders(self) -> None:
        for s in self._holders:
            try:
                s.close()
            except OSError:
                pass
        self._holders = []

    def _hold_port(self) -> socket.socket:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("127.0.0.1", 0))
        return s

    def _alloc_ports(self, n: int) -> List[str]:
        """Allocate and HOLD ``n`` comm ports (``SO_REUSEPORT``, not
        listening — children rebind them via
        ``BYTEWAX_TPU_REUSEPORT=1``, and holding them for the whole
        generation keeps a relaunched child's slot rebindable), plus
        one fresh API base port."""
        self._close_holders()
        addresses = []
        for _ in range(n):
            s = self._hold_port()
            self._holders.append(s)
            addresses.append(f"127.0.0.1:{s.getsockname()[1]}")
        # The API plane binds base+rank without REUSEPORT, so the
        # base is probed-and-released (the webserver degrades loudly
        # if something grabs it in between).
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        self.api_base_port = probe.getsockname()[1]
        probe.close()
        return addresses

    def _child_env(self, proc_id: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.env_extra)
        env["BYTEWAX_TPU_REUSEPORT"] = "1"
        if self.addresses:
            env["BYTEWAX_ADDRESSES"] = ";".join(self.addresses)
            env["BYTEWAX_PROCESS_ID"] = str(proc_id)
        else:
            env.pop("BYTEWAX_ADDRESSES", None)
            env.pop("BYTEWAX_PROCESS_ID", None)
        if self.wpp:
            env["BYTEWAX_WORKERS_PER_PROCESS"] = str(self.wpp)
        env["BYTEWAX_DATAFLOW_API_ENABLED"] = "1"
        env["BYTEWAX_DATAFLOW_API_PORT"] = str(self.api_base_port)
        # Peers must self-heal while a hard-dead child is relaunched
        # (they observe its socket close and restart in place); honor
        # an explicit setting, default the budget on otherwise.
        env.setdefault("BYTEWAX_TPU_MAX_RESTARTS", "3")
        if self._generation > 0 and self.recovery_dir:
            # Relaunches may change the worker count; the startup
            # migration is a no-op when it did not.
            env["BYTEWAX_TPU_RESCALE"] = "1"
        return env

    def _child_cmd(self) -> List[str]:
        cmd = [sys.executable, "-m", "bytewax_tpu_torch.run", self.import_str]
        if self.recovery_dir is not None:
            cmd += ["-r", str(self.recovery_dir)]
            if self.snapshot_interval_s is not None:
                cmd += ["-s", str(self.snapshot_interval_s)]
            if self.backup_interval_s is not None:
                cmd += ["-b", str(self.backup_interval_s)]
        return cmd

    def _spawn_child(self, proc_id: int) -> subprocess.Popen:
        out: Any = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(  # noqa: SIM115 - handle owned by the child
                os.path.join(self.log_dir, f"child-{proc_id}.log"),
                "ab",
            )
        try:
            return subprocess.Popen(
                self._child_cmd(),
                env=self._child_env(proc_id),
                cwd=self.workdir,
                stdout=out,
                stderr=out,
            )
        finally:
            if out is not None:
                out.close()

    def _launch(self, n: int) -> None:
        # A one-process cluster runs the plain run_main path (no
        # comm mesh, no addresses); _alloc_ports(0) still rotates the
        # API base port for the new generation.
        self.addresses = self._alloc_ports(n) if n > 1 else (
            self._alloc_ports(0)
        )
        self.children = [self._spawn_child(i) for i in range(n)]
        self.current = n
        #: Scale decisions wait until every child of this generation
        #: has reported ready once: acting on a cluster mid-startup
        #: would SIGTERM processes that have not installed handlers
        #: yet (a kill, not a drain) and sample meaningless hints.
        self._all_ready = False
        self._last_sample_marker = None
        logger.info(
            "supervisor launched %d process(es) (generation %d)",
            n,
            self._generation,
        )

    def _wait_children(self, timeout_s: float) -> bool:
        """True when every child exited within ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        for p in self.children:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.05))
            except subprocess.TimeoutExpired:
                return False
        return True

    def _any_migrating(self) -> bool:
        """Whether any live child reports the ``migrating`` health
        state — a rescale migration (or a peer waiting behind one) in
        progress.  That is live progress, not a wedged child: the
        stop/retire escalation ladders extend their deadlines instead
        of SIGKILLing a mid-migration store transaction."""
        for rank, p in enumerate(self.children):
            if p.poll() is not None:
                continue
            health = _get_health((self.api_base_port or 0) + rank)
            if health is not None and health.get("state") == "migrating":
                return True
        return False

    def _stop_cluster(self) -> None:
        """Coordinated graceful stop: one ``POST /stop`` is enough
        (the vote rides the epoch-close sync round cluster-wide);
        SIGTERM every child as the fallback, escalating to SIGKILL
        after the stop timeout.  A child mid-migration extends the
        escalation deadline (bounded) — killing the store transaction
        would only force the next generation to redo it."""
        posted = False
        for rank in range(len(self.children)):
            if self.children[rank].poll() is not None:
                continue
            if _post_stop((self.api_base_port or 0) + rank):
                posted = True
                break
        if not posted:
            for p in self.children:
                if p.poll() is None:
                    try:
                        p.terminate()
                    except OSError:
                        pass
        stopped = self._wait_children(self.stop_timeout_s)
        extensions = 0
        while not stopped and extensions < 5 and self._any_migrating():
            logger.info(
                "children still migrating; extending graceful-stop "
                "wait (%d)",
                extensions + 1,
            )
            extensions += 1
            stopped = self._wait_children(self.stop_timeout_s)
        if not stopped:
            logger.warning(
                "graceful stop timed out after %.0fs; escalating",
                self.stop_timeout_s,
            )
            for p in self.children:
                if p.poll() is None:
                    try:
                        p.terminate()
                    except OSError:
                        pass
            if not self._wait_children(_TERM_GRACE_S):
                for p in self.children:
                    if p.poll() is None:
                        try:
                            p.kill()
                        except OSError:
                            pass
                self._wait_children(_TERM_GRACE_S)

    # -- decisions ---------------------------------------------------------

    def _poll_advice(self) -> Optional[str]:
        """One FRESH advice sample, or ``None``.  Samples are deduped
        by the reporting process's epoch: the hint derives from
        cumulative per-epoch-close counters, so two polls inside one
        epoch would re-derive the same measurement and hysteresis
        must not count them twice — ``k`` consecutive samples means
        ``k`` distinct epoch closes agreeing.  ``hint_fn`` (tests,
        embedders) bypasses the dedup — its samples are taken to be
        fresh by contract."""
        if self.hint_fn is not None:
            return self.hint_fn()
        for rank in range(len(self.children)):
            status = _get_status((self.api_base_port or 0) + rank)
            if status is None:
                continue
            hint = status.get("rescale_hint") or {}
            advice = hint.get("advice")
            if advice not in ("grow", "shrink", "hold"):
                continue
            marker = (rank, status.get("epoch"))
            if marker == self._last_sample_marker:
                return None  # no epoch closed since the last sample
            self._last_sample_marker = marker
            return advice
        return None

    def _note_fault(self) -> float:
        """Burst-scoped backoff bookkeeping for a relaunch: a healthy
        window since the last fault resets the ladder; returns the
        delay to sleep before acting."""
        now = time.monotonic()
        if now - self._last_fault_at >= self._reset_s:
            self._backoff.reset()
        self._last_fault_at = now
        return self._backoff.next_delay()

    def _scale_to(self, target: int, reason: str = "") -> None:
        """One confirmed scale move.  The live partial-rescale path is
        the default (docs/recovery.md "Live partial rescale"): the
        cluster keeps serving while the membership change rides an
        epoch close and only changed-route keys migrate.  Anything
        that keeps a live move from completing — a joiner that never
        reaches its handshake, a child whose control plane is gone,
        the agreement not landing before the timeout — falls back to
        the legacy whole-cluster drain-to-stop + relaunch, which is
        also what ``BYTEWAX_TPU_AUTOSCALE_LIVE=0`` forces."""
        if self.live and self.recovery_dir is not None:
            try:
                if self._scale_to_live(target, reason):
                    return
            except Exception:  # noqa: BLE001 - fall back, never die
                logger.exception("live scale move failed")
            logger.warning(
                "live scale move did not complete; falling back to "
                "the drain-to-stop path"
            )
        self._scale_to_restart(target, reason)

    def _scale_to_restart(self, target: int, reason: str = "") -> None:
        """The legacy stop-the-world move: coordinated graceful drain
        of the WHOLE cluster, then a relaunch at the new size (the
        startup migration re-shards the keyed state)."""
        action = "grow" if target > self.current else "shrink"
        logger.warning(
            "autoscale %s: %d -> %d process(es) (%s)",
            action,
            self.current,
            target,
            reason or "hint",
        )
        _flight.note_autoscale(action, self.current, target, reason)
        self.actions.append((action, self.current, target))
        self._stop_cluster()
        codes = [p.returncode for p in self.children]
        if any(c != 0 for c in codes):
            logger.warning(
                "children exited %s during the drain; the relaunch "
                "resumes from the last committed epoch",
                codes,
            )
        self._history.clear()
        self._last_scale_at = time.monotonic()
        self._generation += 1
        self._launch(target)

    def _live_move_done(self, old: int, target: int) -> bool:
        """Whether the posted membership change has fully landed: all
        retirees exited cleanly, and every member of the new cluster
        reports ready at the new process count."""
        for rank in range(target, old):
            if self.children[rank].poll() is None:
                return False
        want_count = max(target, 1)
        for rank in range(target):
            health = _get_health((self.api_base_port or 0) + rank)
            if health is None or not health.get("ready"):
                return False
            status = _get_status((self.api_base_port or 0) + rank)
            if (
                status is None
                or status.get("proc_count") != want_count
            ):
                return False
        return True

    def _scale_to_live(self, target: int, reason: str = "") -> bool:
        """The live partial-rescale move (docs/recovery.md): spawn the
        joiner (grow) while the cluster keeps serving, wait until it
        reaches its mesh handshake, then post the new membership to
        every existing child — the change agrees on an epoch-close
        sync round, survivors re-enter run startup in-process, the
        retiree (shrink) exits after the agreed close, and the store
        migration moves only changed-route keys.  True when the move
        fully landed; False (after cleaning up any joiner) tells the
        caller to fall back to the drain-to-stop path."""
        action = "grow" if target > self.current else "shrink"
        old = self.current
        logger.warning(
            "autoscale %s (live): %d -> %d process(es) (%s)",
            action,
            old,
            target,
            reason or "hint",
        )
        # Survivors keep their comm slots; grow appends freshly-held
        # ports (from 1 process there is no mesh yet — all slots are
        # fresh).  A 1-address list below means "no mesh" to the
        # children, same as the launch path's empty list.
        new_addresses = list(self.addresses[:target])
        while len(new_addresses) < max(target, 2) and target > 1:
            s = self._hold_port()
            self._holders.append(s)
            new_addresses.append(
                f"127.0.0.1:{s.getsockname()[1]}"
            )
        move: Dict[str, Any] = {
            "action": action,
            "from_procs": old,
            "to_procs": target,
            "pids_before": [p.pid for p in self.children],
            "epoch_before": (
                (_get_status(self.api_base_port or 0) or {}).get(
                    "epoch"
                )
            ),
        }
        self._generation += 1
        self.addresses = new_addresses

        def abort_live() -> bool:
            # Reap this attempt's joiners before falling back: a
            # handshake-blocked joiner has no run loop to drain, so
            # leaving it in self.children would make the fallback's
            # graceful stop burn its whole timeout waiting on a
            # process that can never exit cooperatively.
            for p in self.children[old:]:
                if p.poll() is None:
                    try:
                        p.terminate()
                    except OSError:
                        pass
            for p in self.children[old:]:
                try:
                    p.wait(timeout=_TERM_GRACE_S)
                except subprocess.TimeoutExpired:
                    try:
                        p.kill()
                    except OSError:
                        pass
            del self.children[old:]
            return False

        # Joiners boot while the old cluster keeps processing — their
        # interpreter/torch startup is OUTSIDE the service interruption.
        for rank in range(old, target):
            self.children.append(self._spawn_child(rank))
        deadline = time.monotonic() + self.stop_timeout_s
        for rank in range(old, target):
            while not _comm_port_listening(new_addresses[rank]):
                if (
                    self.children[rank].poll() is not None
                    or time.monotonic() > deadline
                ):
                    logger.warning(
                        "joiner %d never reached its mesh handshake",
                        rank,
                    )
                    return abort_live()
                time.sleep(0.05)
        # Post the target to every pre-move child (the retiree too:
        # its vote is part of the agreement).  Re-post every tick —
        # idempotent — until the move lands, so one lost POST just
        # defers the agreement to a later epoch close.  Fresh budget:
        # the joiner's interpreter/torch boot above must not eat the
        # agreement-and-rebuild window (a modest stop timeout sized
        # for the drain path would otherwise make every live move
        # fall back before it could land).
        deadline = time.monotonic() + self.stop_timeout_s
        extensions = 0
        while True:
            for rank in range(old):
                if self.children[rank].poll() is None:
                    _post_reconfigure(
                        (self.api_base_port or 0) + rank,
                        new_addresses,
                        self.wpp,
                    )
            if self._live_move_done(old, target):
                break
            if time.monotonic() > deadline:
                if extensions < 5 and self._any_migrating():
                    # A migration in flight is live progress, not a
                    # wedge: extend (bounded — a store transaction
                    # hung on dead storage must still fall back
                    # eventually) rather than abandon a mid-move
                    # cluster.
                    extensions += 1
                    deadline = time.monotonic() + self.stop_timeout_s
                    continue
                logger.warning(
                    "live move did not land within %.0fs",
                    self.stop_timeout_s,
                )
                return abort_live()
            time.sleep(0.2)
        # Retirees exited cleanly; drop them and their comm slots.
        self.children = self.children[:max(target, 1)]
        for s in self._holders[target:]:
            try:
                s.close()
            except OSError:
                pass
        del self._holders[target:]
        move["pids_after"] = [p.pid for p in self.children]
        move["epoch_after"] = (
            (_get_status(self.api_base_port or 0) or {}).get("epoch")
        )
        self.last_live_move = move
        _flight.note_autoscale(
            action, old, target, f"live:{reason or 'hint'}"
        )
        self.actions.append((action, old, target))
        self._history.clear()
        self._last_scale_at = time.monotonic()
        self.current = target
        self._all_ready = False
        self._last_sample_marker = None
        logger.warning(
            "live %s complete: %d -> %d process(es), surviving "
            "children untouched",
            action,
            old,
            target,
        )
        return True

    def request_stop(self) -> None:
        """Ask the supervisor to gracefully stop the cluster and
        return from :meth:`run` (signal handlers, embedders)."""
        self._stop_event.set()

    # -- the watch loop ----------------------------------------------------

    def run(self) -> int:
        """Spawn the cluster and supervise it until it completes (all
        children exit 0 → returns 0), the relaunch budget is
        exhausted (returns 1), or a stop is requested (graceful stop,
        returns 0)."""
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(
                    sig, lambda *_a: self.request_stop()
                )
        except ValueError:
            pass  # not the main thread (tests, embedders)
        self._launch(self.current)
        try:
            while True:
                if self._stop_event.wait(self.poll_s):
                    self._stop_cluster()
                    return 0

                codes = [p.poll() for p in self.children]
                if all(c is not None for c in codes):
                    if all(c == 0 for c in codes):
                        logger.info("cluster completed cleanly")
                        return 0
                    # Whole cluster down (beyond the in-process
                    # budgets): burst-scoped whole-cluster relaunch.
                    delay = self._note_fault()
                    if self._backoff.failures > _CLUSTER_RELAUNCH_BUDGET:
                        logger.error(
                            "cluster crash-looped %d times; giving up",
                            self._backoff.failures - 1,
                        )
                        return 1
                    logger.warning(
                        "cluster died (%s); relaunching %d "
                        "process(es) in %.2fs",
                        codes,
                        self.current,
                        delay,
                    )
                    _flight.note_autoscale(
                        "relaunch",
                        self.current,
                        self.current,
                        "cluster died",
                    )
                    self.actions.append(
                        ("relaunch", self.current, self.current)
                    )
                    time.sleep(delay)
                    self._generation += 1
                    self._launch(self.current)
                    continue

                for rank, code in enumerate(codes):
                    if code is None or code == 0:
                        # Alive — or a clean exit racing cluster EOF.
                        continue
                    # Hard-dead child (OOM kill, SIGKILL, exhausted
                    # in-process budget): relaunch it in place; its
                    # peers already observed the socket close and are
                    # restarting under their own supervisors.
                    delay = self._note_fault()
                    logger.warning(
                        "child %d died (exit %s); relaunching in "
                        "%.2fs",
                        rank,
                        code,
                        delay,
                    )
                    _flight.note_autoscale(
                        "relaunch",
                        self.current,
                        self.current,
                        f"child {rank} exit {code}",
                    )
                    self.actions.append(
                        ("relaunch", self.current, self.current)
                    )
                    time.sleep(delay)
                    self.children[rank] = self._spawn_child(rank)
                    # The cluster is mid-restart (the new child is
                    # importing, its peers are re-forming the mesh):
                    # re-gate scale decisions on every child
                    # reporting ready again, and drop pre-fault
                    # advice — a stale grow streak acting now would
                    # SIGTERM children that have no handlers yet (a
                    # kill, not a drain).
                    self._all_ready = False
                    self._history.clear()

                if not self._all_ready:
                    self._all_ready = all(
                        (
                            _get_health(
                                (self.api_base_port or 0) + rank
                            )
                            or {}
                        ).get("ready", False)
                        for rank in range(len(self.children))
                    )
                    continue

                advice = self._poll_advice()
                if advice is None:
                    # No fresh sample this tick (the status plane is
                    # not answering): never act on a stale streak —
                    # a cluster whose current state is unknown must
                    # not be drained on minutes-old advice.
                    continue
                self._history.append(advice)
                if len(self._history) > 64:
                    del self._history[:-32]
                target = decide_scale(
                    self._history,
                    current=self.current,
                    min_procs=self.min_procs,
                    max_procs=self.max_procs,
                    k=self.hysteresis,
                )
                if (
                    target is not None
                    and time.monotonic() - self._last_scale_at
                    >= self.cooldown_s
                ):
                    self._scale_to(target, reason=advice)
        finally:
            self._close_holders()

    def __enter__(self) -> "ClusterSupervisor":
        return self

    def __exit__(self, *_exc: Any) -> None:
        # Never leak children: terminate whatever is still alive.
        for p in self.children:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        self._wait_children(_TERM_GRACE_S)
        self._close_holders()


def autoscale_main(
    import_str: str,
    bounds: str,
    *,
    workers_per_process: Optional[int] = None,
    recovery_directory: Optional[Any] = None,
    snapshot_interval: Optional[Any] = None,
    backup_interval: Optional[Any] = None,
    procs: Optional[int] = None,
) -> int:
    """Entry point behind ``--autoscale MIN:MAX`` (both CLIs)."""
    lo, hi = parse_bounds(bounds)

    def _seconds(v: Any) -> Optional[float]:
        if v is None:
            return None
        total = getattr(v, "total_seconds", None)
        return float(total() if total is not None else v)

    with ClusterSupervisor(
        import_str,
        min_procs=lo,
        max_procs=hi,
        procs=procs,
        workers_per_process=workers_per_process,
        recovery_dir=(
            str(recovery_directory)
            if recovery_directory is not None
            else None
        ),
        snapshot_interval_s=_seconds(snapshot_interval),
        backup_interval_s=_seconds(backup_interval),
    ) as sup:
        return sup.run()


def _main() -> None:
    parser = argparse.ArgumentParser(
        prog="python -m bytewax_tpu_torch.supervise",
        description="Supervise and autoscale a bytewax_tpu_torch cluster "
        "(docs/deployment.md 'Running under the autoscaler')",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "import_str",
        type=str,
        help="Dataflow import string, e.g. src.flow:flow (imported "
        "by the children, not by the supervisor)",
    )
    parser.add_argument(
        "--autoscale",
        type=str,
        required=True,
        metavar="MIN:MAX",
        help="Process-count bounds, e.g. 2:8",
    )
    parser.add_argument(
        "--procs",
        type=int,
        default=None,
        help="Initial process count (default MIN)",
    )
    parser.add_argument(
        "-w",
        "--workers-per-process",
        type=int,
        default=None,
        help="Worker lanes per child process",
    )
    parser.add_argument(
        "-r",
        "--recovery-directory",
        type=Path,
        default=None,
        help="Recovery partition directory (required for rescale to "
        "carry state across moves)",
    )
    parser.add_argument(
        "-s",
        "--snapshot-interval",
        type=float,
        default=None,
        help="Epoch/snapshot interval in seconds",
    )
    parser.add_argument(
        "-b",
        "--backup-interval",
        type=float,
        default=None,
        help="Snapshot GC delay in seconds",
    )
    args = parser.parse_args()
    sys.exit(
        autoscale_main(
            args.import_str,
            args.autoscale,
            workers_per_process=args.workers_per_process,
            recovery_directory=args.recovery_directory,
            snapshot_interval=args.snapshot_interval,
            backup_interval=args.backup_interval,
            procs=args.procs,
        )
    )


if __name__ == "__main__":
    _main()
