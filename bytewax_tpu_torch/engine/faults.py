"""Deterministic, env-configurable fault injection for chaos testing.

The engine threads named *fault sites* through its hot paths (cluster
frame send/receive, device-tier dispatch, snapshot write/commit, the
epoch-close barrier).  Each site is a single :func:`fire` call that is
a no-op unless a fault plan is armed via ``BYTEWAX_TPU_FAULTS``, so
production runs pay one attribute check per site.

Plan syntax — comma-separated specs::

    BYTEWAX_TPU_FAULTS="site:kind:epoch[:proc][:xN]"

- ``site``: one of :data:`SITES` (``comm.send``, ``comm.recv``,
  ``device_dispatch``, ``residency_restore``, ``source_poll``,
  ``sink_write``, ``snapshot.write``, ``snapshot.commit``,
  ``snapshot_seal``, ``rescale_migrate``, ``params_swap``,
  ``barrier``).
- ``kind``: ``delay`` (sleep ``BYTEWAX_TPU_FAULT_DELAY_S``, default
  0.05s), ``drop`` (suppress the frame — only meaningful at
  ``comm.send``; breaks the barrier's in-flight accounting on purpose,
  so the stall watchdog must heal it), ``error`` (raise
  :class:`bytewax_tpu_torch.errors.DeviceFault` at ``device_dispatch`` and
  ``residency_restore`` — the retryable device-path sites —
  :class:`~bytewax_tpu_torch.errors.TransientSourceError` /
  :class:`~bytewax_tpu_torch.errors.TransientSinkError` at ``source_poll``
  / ``sink_write`` — the connector-edge retry sites —
  :class:`InjectedFault` elsewhere), ``crash`` (raise
  :class:`InjectedCrash` — simulated sudden process death: the driver
  unwinds *without* an abort broadcast, so peers discover it exactly
  like a real kill).
- ``epoch``: ``N`` (fires while the current epoch is N), ``N+``
  (every epoch >= N), or ``*`` (always).
- ``proc`` (optional): only that process id; default all.
- ``xN`` (optional): fire at most N times in this process (counts
  persist across supervised restarts — the plan is process-global).

Random soak mode::

    BYTEWAX_TPU_FAULTS="random"
    BYTEWAX_TPU_FAULTS_SEED=7        # deterministic per (seed, proc)
    BYTEWAX_TPU_FAULTS_RATE=0.01     # Bernoulli per fire() check
    BYTEWAX_TPU_FAULTS_KINDS=delay,crash  # optional kind pool
    BYTEWAX_TPU_FAULTS_SITES=source_poll,sink_write  # optional site pool
    BYTEWAX_TPU_FAULTS_MIN_GAP_S=2   # wall-clock floor between fires

``BYTEWAX_TPU_FAULTS_SITES`` restricts the random soak to a subset of
:data:`SITES` (default: all of them) — e.g. a connector-edge soak
fires only ``source_poll``/``sink_write`` so every drawn fault lands
in the I/O retry ladder instead of the supervisor.

The min-gap (default 1s) keeps chaos frequency a *wall-clock* rate:
site check frequency varies by orders of magnitude with the epoch
interval (at interval 0 the control plane fires thousands of
``comm.send`` checks per second), and an un-gapped Bernoulli draw at
that rate is a crash storm that outruns recovery instead of a soak.

Every firing lands in the flight-recorder ring (``fault_injected``
events) and the ``bytewax_fault_injected_count`` Prometheus family, so
chaos runs are auditable after the fact.
"""

import os
import random
import time
from typing import Any, List, Optional

from bytewax_tpu_torch.engine import flight as _flight

__all__ = [
    "InjectedCrash",
    "InjectedFault",
    "SITES",
    "configure",
    "fire",
    "reset",
    "set_epoch",
]

#: Every site the engine threads a :func:`fire` call through.
#: ``rescale_migrate`` fires inside the rescale-on-resume store
#: transaction, before any row moves, so a mid-migration fault rolls
#: back whole and retries cleanly under the supervisor.
#: ``source_poll``/``sink_write`` are the connector-edge sites
#: (docs/recovery.md "Connector-edge resilience"): fired immediately
#: before a source partition's ``next_batch`` / a sink partition's
#: ``write_batch``, before any offset advances or byte lands, so an
#: injected transient error is retry-safe by construction.
#: ``snapshot_seal`` fires at the epoch-close drain point, after the
#: consistent delta is sealed in memory but before it is handed to
#: anything durable (the inline write under the sync path, the
#: committer lane under ``BYTEWAX_TPU_CKPT_ASYNC=1``) — a crash there
#: proves the seal→commit window resumes from the previous durable
#: close (docs/recovery.md "Asynchronous incremental checkpoints").
#: ``params_swap`` fires at the agreed epoch close, before any infer
#: runtime installs the pending params update and before the pending
#: target is consumed — a crash there restarts with the target intact
#: (module state survives supervised in-process restarts), so the swap
#: commits exactly once at the next agreed close (docs/inference.md).
SITES = (
    "comm.send",
    "comm.recv",
    "device_dispatch",
    "residency_restore",
    "source_poll",
    "sink_write",
    "snapshot.write",
    "snapshot.commit",
    "snapshot_seal",
    "rescale_migrate",
    "params_swap",
    "barrier",
)

#: Sites on the device-dispatch path: ``kind=error`` raises a
#: retryable :class:`~bytewax_tpu_torch.errors.DeviceFault` (fired before
#: any device state mutates — the driver retries the delivery, then
#: demotes) instead of a plain :class:`InjectedFault`.
_DEVICE_SITES = ("device_dispatch", "residency_restore")

#: Connector-edge sites: ``kind=error`` raises the matching typed
#: transient error (retried by the driver's I/O retry ladder —
#: exhaustion escalates to the supervisor) instead of a plain
#: :class:`InjectedFault`; ``kind=crash`` stays an abrupt
#: :class:`InjectedCrash` like everywhere else.
_IO_SITES = ("source_poll", "sink_write")

_KINDS = ("delay", "drop", "error", "crash")

#: Kinds the random soak mode may draw per site.  ``drop`` is excluded
#: by default (it deliberately wedges the epoch barrier and needs the
#: stall watchdog armed to heal); opt in via BYTEWAX_TPU_FAULTS_KINDS.
_RANDOM_DEFAULT_KINDS = ("delay", "crash")


class InjectedFault(RuntimeError):
    """An injected runtime fault (``kind=error``); restartable by the
    supervisor so chaos runs exercise the recovery path."""

    def __init__(self, site: str, kind: str, epoch: Optional[int]):
        super().__init__(
            f"injected fault at {site!r} (kind={kind}, epoch={epoch})"
        )
        self.site = site
        self.kind = kind
        self.epoch = epoch

    def __reduce__(self):
        # BaseException's reduce replays self.args (the formatted
        # message) into __init__, which wants (site, kind, epoch) —
        # rebuild from the fields so the error survives pickling
        # across process boundaries.
        return (type(self), (self.site, self.kind, self.epoch))


class InjectedCrash(InjectedFault):
    """Simulated sudden process death (``kind=crash``): the driver
    unwinds abruptly — comm sockets close with no abort broadcast —
    and the supervisor restarts from the last committed epoch."""


class _Spec:
    __slots__ = ("site", "kind", "epoch", "epoch_plus", "proc", "left")

    def __init__(self, raw: str):
        parts = raw.strip().split(":")
        if len(parts) < 3:
            msg = (
                f"bad fault spec {raw!r}: want site:kind:epoch[:proc][:xN]"
            )
            raise ValueError(msg)
        self.site, self.kind = parts[0], parts[1]
        if self.site not in SITES:
            msg = f"unknown fault site {self.site!r}; known: {SITES}"
            raise ValueError(msg)
        if self.kind not in _KINDS:
            msg = f"unknown fault kind {self.kind!r}; known: {_KINDS}"
            raise ValueError(msg)
        ep = parts[2]
        self.epoch_plus = ep.endswith("+")
        self.epoch = None if ep == "*" else int(ep.rstrip("+"))
        self.proc: Optional[int] = None
        self.left: Optional[int] = None
        for extra in parts[3:]:
            if extra.startswith("x"):
                self.left = int(extra[1:])
            else:
                self.proc = int(extra)

    def matches(self, site: str, epoch: int, proc: int) -> bool:
        if site != self.site or (self.left is not None and self.left <= 0):
            return False
        if self.proc is not None and proc != self.proc:
            return False
        if self.epoch is None:
            return True
        return epoch >= self.epoch if self.epoch_plus else epoch == self.epoch


class _Plan:
    def __init__(self, env: str, proc_id: int):
        self.env = env
        #: Full env fingerprint this plan was built from (set by
        #: configure); satellite-var changes re-arm the plan too.
        self.fingerprint = env
        self.proc_id = proc_id
        self.specs: List[_Spec] = []
        self.rng: Optional[random.Random] = None
        self.rate = 0.0
        self.random_kinds = _RANDOM_DEFAULT_KINDS
        self.random_sites: Optional[frozenset] = None
        self.min_gap_s = 0.0
        self.last_fire = 0.0
        if env.strip() == "random":
            seed = int(os.environ.get("BYTEWAX_TPU_FAULTS_SEED", "0"))
            self.rate = float(
                os.environ.get("BYTEWAX_TPU_FAULTS_RATE", "0.01")
            )
            self.min_gap_s = float(
                os.environ.get("BYTEWAX_TPU_FAULTS_MIN_GAP_S", "1.0")
            )
            kinds = os.environ.get("BYTEWAX_TPU_FAULTS_KINDS")
            if kinds:
                self.random_kinds = tuple(
                    k.strip() for k in kinds.split(",") if k.strip()
                )
            sites = os.environ.get("BYTEWAX_TPU_FAULTS_SITES")
            if sites:
                picked = frozenset(
                    s.strip() for s in sites.split(",") if s.strip()
                )
                unknown = picked - set(SITES)
                if unknown:
                    msg = (
                        f"unknown fault site(s) {sorted(unknown)} in "
                        f"BYTEWAX_TPU_FAULTS_SITES; known: {SITES}"
                    )
                    raise ValueError(msg)
                self.random_sites = picked
            # Per-process stream so every process draws its own
            # deterministic fault schedule.  (A str seed: tuple seeds
            # raise TypeError on Python 3.11+.)
            self.rng = random.Random(f"{seed}:{proc_id}")
        else:
            self.specs = [
                _Spec(raw) for raw in env.split(",") if raw.strip()
            ]

    def pick(self, site: str, epoch: int) -> Optional[str]:
        """The kind to inject at this site right now, or None."""
        if self.rng is not None:
            if (
                self.random_sites is not None
                and site not in self.random_sites
            ):
                return None
            now = time.monotonic()
            if now - self.last_fire < self.min_gap_s:
                return None
            if self.rng.random() >= self.rate:
                return None
            self.last_fire = now
            return self.rng.choice(self.random_kinds)
        for spec in self.specs:
            if spec.matches(site, epoch, self.proc_id):
                if spec.left is not None:
                    spec.left -= 1
                return spec.kind
        return None


#: Armed plan for this process (None = injection off — the common
#: case; fire() is then one global read + None check).
_plan: Optional[_Plan] = None
_epoch: int = 0


def _fingerprint() -> str:
    """Everything the plan is built from: the spec string plus the
    random-mode satellite vars, so changing any of them re-arms."""
    return "\x00".join(
        os.environ.get(k, "")
        for k in (
            "BYTEWAX_TPU_FAULTS",
            "BYTEWAX_TPU_FAULTS_SEED",
            "BYTEWAX_TPU_FAULTS_RATE",
            "BYTEWAX_TPU_FAULTS_KINDS",
            "BYTEWAX_TPU_FAULTS_SITES",
            "BYTEWAX_TPU_FAULTS_MIN_GAP_S",
        )
    )


def configure(proc_id: int) -> None:
    """(Re-)arm the injector from the environment for this process.

    Called at driver construction.  Spec fire-counts (``xN``) persist
    across supervised restarts in the same process: the plan is only
    rebuilt when the fault environment itself changes, so a one-shot
    crash does not re-fire after the restart it caused.
    """
    global _plan
    env = os.environ.get("BYTEWAX_TPU_FAULTS", "")
    if not env.strip():
        _plan = None
        return
    fp = _fingerprint()
    if (
        _plan is not None
        and _plan.fingerprint == fp
        and _plan.proc_id == proc_id
    ):
        return
    _plan = _Plan(env, proc_id)
    _plan.fingerprint = fp


def reset() -> None:
    """Forget the armed plan (tests: re-arm with fresh fire-counts)."""
    global _plan
    _plan = None


def set_epoch(epoch: int) -> None:
    """Driver hook: the current epoch, consulted by epoch-scoped specs."""
    global _epoch
    _epoch = epoch


def fire(site: str, **ctx: Any) -> Optional[str]:
    """Run the fault site ``site``.

    Returns None (no fault), sleeps in place (``delay``), returns
    ``"drop"`` (caller suppresses the frame), or raises
    (``error``/``crash``).  Firings are recorded in the flight ring
    and the ``bytewax_fault_injected_count`` metric before they take
    effect.
    """
    plan = _plan
    if plan is None:
        return None
    kind = plan.pick(site, _epoch)
    if kind is None:
        return None
    _flight.note_fault(site, kind, epoch=_epoch, **ctx)
    if kind == "delay":
        time.sleep(
            float(os.environ.get("BYTEWAX_TPU_FAULT_DELAY_S", "0.05"))
        )
        return None
    if kind == "drop":
        return "drop"
    if kind == "crash":
        raise InjectedCrash(site, kind, _epoch)
    if site in _DEVICE_SITES:
        from bytewax_tpu_torch.errors import DeviceFault

        raise DeviceFault(
            f"injected device fault at {site!r}, epoch {_epoch} "
            f"(step {ctx.get('step')!r})"
        )
    if site in _IO_SITES:
        from bytewax_tpu_torch.errors import (
            TransientSinkError,
            TransientSourceError,
        )

        cls = (
            TransientSourceError
            if site == "source_poll"
            else TransientSinkError
        )
        raise cls(
            f"injected transient I/O fault at {site!r}, epoch "
            f"{_epoch} (step {ctx.get('step')!r}, part "
            f"{ctx.get('part')!r})"
        )
    raise InjectedFault(site, kind, _epoch)
