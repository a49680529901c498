"""BTX-THREAD positive fixture: a worker-lane task that aliases its
way to the raw cluster send surface.

The task handed to ``DevicePipeline.push`` runs on the pipeline's
worker thread; binding the bound send method to a local first means
no line ever spells a literal receiver-dot-send call — only
callable-argument tracing into the thread submission plus
bound-method alias resolution can see that the worker lane reaches
the send surface.
"""

from bytewax_tpu_torch.engine.comm import Comm
from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class LeakyStep:
    def __init__(self, listen, peers, proc_id):
        self.comm = Comm(listen, peers, proc_id)
        self._pipe = DevicePipeline("leaky")

    def process(self, port, entries):
        def task():
            # A "helpful" progress report from the device phase: an
            # uncounted frame sent OFF the main thread — exactly the
            # race/protocol violation BTX-THREAD exists to catch.
            s = self.comm.send
            s(0, ("report_msg", len(entries)))
            return entries

        def finalize(res):
            pass

        self._pipe.push(task, finalize)
