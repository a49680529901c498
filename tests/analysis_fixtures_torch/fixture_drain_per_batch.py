"""BTX-DRAIN positive fixture: an eviction reachable from a per-batch
path.

``process`` -> ``_maybe_trim`` -> ``evict_to_budget`` never passes
through a drain point, so a deferred fold still in flight on the
pipeline worker could reference the slot this eviction reclaims — the
exact single-schedule race the drain-point discipline exists to
prevent.  Also exercises the pipeline-receiver drain seed: a raw
``flush()`` on a ``DevicePipeline`` from a per-batch helper.
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class TinyManager:
    def __init__(self, budget):
        self.budget = budget
        self.resident = {}

    def over_budget(self):
        return len(self.resident) > self.budget

    def evict_to_budget(self, epoch):
        while self.over_budget():
            self.resident.popitem()


class EagerStep:
    def __init__(self):
        self.res = TinyManager(64)
        self.pipe = DevicePipeline("eager")

    def process(self, port, entries):
        self._fold(entries)
        self._maybe_trim()

    def _fold(self, entries):
        for _w, items in entries:
            self.pipe.push(lambda: items, lambda res: None)

    def _maybe_trim(self):
        # Per-batch eviction with NO pipeline quiesce first: flagged.
        if self.res.over_budget():
            self.res.evict_to_budget(0)

    def on_batch(self, items):
        # Per-batch raw pipeline drain (not at a drain point): the
        # worker-owned fold structures are read mid-stream.
        self.pipe.flush()
        return items


class UnflushedSyncStep:
    def __init__(self, driver):
        self.driver = driver

    def pre_close(self):
        # Gsync round with NO pipeline flush first — and the
        # primitive hides behind a bound-method alias, so only the
        # alias-aware flush-before-sync check can see it.
        gs = self.driver.global_sync
        gs("tag", None)
