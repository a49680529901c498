"""The one backoff implementation: seeded, jittered, capped.

Three engine surfaces retry with backoff — the cluster handshake's
dial loop (:mod:`bytewax_tpu_torch.engine.comm`), the restart supervisor
(``driver._supervised``), and the connector-edge I/O retry
(``docs/recovery.md`` "Connector-edge resilience").  They all share
this module so the backoff properties are provable in one place:

- **Exponential with a cap**: attempt ``k`` (1-based) sleeps
  ``min(base * 2**(k-1), cap)`` before jitter, so retries back off
  but never beyond the cap.
- **Jittered**: the slept delay is the capped curve times a factor
  drawn uniformly from ``[0.5, 1.5)``.  Without it every process of a
  crashed cluster sleeps the *identical* deterministic delay and
  redials simultaneously — a thundering-herd handshake (and one
  dial-timeout round) on every generation bump.
- **Seeded per (label, proc)**: schedules are deterministic per
  process (reproducible chaos runs) but desynchronized across the
  cluster and across unrelated retry surfaces in one process.
"""

import random
from typing import Optional

__all__ = ["Backoff", "backoff_delay", "seeded_rng"]

#: Default delay ceiling (seconds) — the supervisor's historical cap.
DEFAULT_CAP_S = 30.0


def seeded_rng(label: str, proc_id: int = 0) -> random.Random:
    """A deterministic jitter stream for one retry surface of one
    process.  ``label`` keeps unrelated surfaces (restart supervisor,
    dial loop, I/O retry) on independent streams so one surface's
    draws never perturb another's schedule.

    >>> from bytewax_tpu_torch.engine.backoff import seeded_rng
    >>> seeded_rng("eg", 0).random() == seeded_rng("eg", 0).random()
    True
    >>> seeded_rng("eg", 0).random() == seeded_rng("eg", 1).random()
    False
    """
    return random.Random(f"bytewax-{label}:{proc_id}")


def backoff_delay(
    base: float,
    attempt: int,
    rng: Optional[random.Random] = None,
    cap: float = DEFAULT_CAP_S,
) -> float:
    """Delay (seconds) before retry ``attempt`` (1-based): the capped
    exponential curve ``min(base * 2**(attempt-1), cap)``, jittered by
    a uniform ``[0.5, 1.5)`` factor from ``rng`` (``None`` = no
    jitter, for callers that pre-seeded determinism into the base).

    >>> from bytewax_tpu_torch.engine.backoff import backoff_delay
    >>> [backoff_delay(1.0, a, cap=4.0) for a in (1, 2, 3, 4)]
    [1.0, 2.0, 4.0, 4.0]
    """
    # Clamp the exponent: attempt counts are unbounded (a quarantined
    # partition reprobes forever), and 2**1100 overflows float before
    # min() could cap it.
    delay = min(base * (2 ** min(attempt - 1, 64)), cap)
    if rng is not None:
        delay *= 0.5 + rng.random()
    return delay


class Backoff:
    """A per-resource retry ladder: ``next_delay()`` walks the capped
    jittered curve, ``reset()`` snaps back to the base after a
    success.  One instance per retried resource (a source partition,
    a sink partition) keeps consecutive-failure counts where the
    escalation decision needs them.

    >>> from bytewax_tpu_torch.engine.backoff import Backoff
    >>> b = Backoff(0.5, cap=2.0)
    >>> [round(b.next_delay(), 2) for _ in range(3)]
    [0.5, 1.0, 2.0]
    >>> b.failures
    3
    >>> b.reset()
    >>> b.failures
    0
    """

    __slots__ = ("base", "cap", "rng", "failures")

    def __init__(
        self,
        base: float,
        cap: float = DEFAULT_CAP_S,
        rng: Optional[random.Random] = None,
    ):
        self.base = base
        self.cap = cap
        self.rng = rng
        self.failures = 0

    def next_delay(self) -> float:
        """Record one more failure and return the delay before the
        next attempt."""
        self.failures += 1
        return backoff_delay(
            self.base, self.failures, rng=self.rng, cap=self.cap
        )

    def reset(self) -> None:
        """A success: the next failure starts the ladder over."""
        self.failures = 0
