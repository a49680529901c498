"""BTX-LANE positive fixture: an un-fenced lane.

The module constructs a ``DevicePipeline`` and flushes it on the hot
path, but NOTHING in the module ever calls ``.shutdown()`` or
``.drop_pending()`` on a pipeline-denoting receiver — at teardown the
worker thread is abandoned with whatever it still holds.  The
module-local drain check fires on fixtures too (the tree half of the
fence proof additionally demands reachability from the pinned
run-ending closes).
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class ForgetfulStep:
    def __init__(self):
        self._pipe = DevicePipeline("forgetful", depth=2, phase="device")

    def process(self, port, entries):
        def task():
            return entries

        def finalize(res):
            pass

        self._pipe.push(task, finalize)

    def drain(self):
        # Flushes in-flight work... and then never tears down.
        self._pipe.flush()
