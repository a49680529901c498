"""BTX-RACE positive fixture: a worker/main shared attribute
smuggled through a bound-method alias.

The task handed to ``DevicePipeline.push`` runs on the worker
thread; it binds ``self._bump`` to a local first, so no line inside
the task ever spells ``self.<anything> = ...`` — only callable
tracing into the submission plus bound-method alias resolution can
see that the worker lane WRITES ``self._tally`` while the per-batch
main path reads it to route.  The attribute is pinned in no
``SHARED_STATE`` inventory, so the finding must carry BOTH witness
chains (the worker path through the alias and the main read path).
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class RacyStep:
    def __init__(self):
        self._pipe = DevicePipeline("racy", depth=2, phase="device")
        self._tally = 0

    def _bump(self, n):
        # The worker-side write: reached only through the alias.
        self._tally = self._tally + n

    def process(self, port, entries):
        # The main-side read: per-batch routing keyed on the tally.
        lane = self._tally % 2

        def task():
            bump = self._bump
            bump(len(entries))
            return entries, lane

        def finalize(res):
            pass

        self._pipe.push(task, finalize)

    def finalize(self):
        self._pipe.flush()
        self._pipe.shutdown()
