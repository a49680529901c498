"""BTX-GSYNC positive fixture: an inference runtime agreeing a params
swap per delivery.

Swap agreement is an epoch-close concern — the pending-params vote
rides the existing "fstat" gsync payload at the globally-ordered
close.  This runtime instead enters a sync round from ``update`` (a
per-batch surface), hidden behind a helper AND a bound-method alias
so no line spells the primitive as a call — yet any peer that did
not receive the same delivery deadlocks in the rogue round.
"""


class EagerSwapInfer:
    def __init__(self, driver):
        self.driver = driver
        self.generation = 0

    def _agree_swap(self, digest):
        vote = self.driver.global_sync
        return vote(("swap-round", self.generation), digest)

    def update(self, keys, values):
        self._agree_swap(len(keys))
        return []
