"""BTX-LANE positive fixture: an un-cataloged lane.

The module is otherwise disciplined — the lane uses a cataloged
ledger phase and the module drains it (flush + shutdown) — so the
ONE finding is the catalog-closure violation: a ``DevicePipeline``
construction site no ``contracts.LANES`` entry names.  A new ordered
off-main-thread lane must never appear silently.
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class SneakyStep:
    def __init__(self):
        self._pipe = DevicePipeline("sneaky", depth=2, phase="device")

    def process(self, port, entries):
        def task():
            return entries

        def finalize(res):
            pass

        self._pipe.push(task, finalize)

    def finalize(self):
        self._pipe.flush()
        self._pipe.shutdown()
