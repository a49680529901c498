"""BTX-LANE positive fixture: a lane constructed under a ledger
phase no catalog entry pins.

The phase string at the construction site decides which ledger
bucket the lane's seconds land in — ``derive_rescale_hint``'s
fraction signals are only as honest as those buckets.  A lane that
invents its own phase name silently bleeds its wall time into a
bucket no observer knows to read (docs/observability.md's phase
table lists exactly the cataloged phases).
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class MisbucketedStep:
    def __init__(self):
        self._pipe = DevicePipeline("turbo", depth=2, phase="turbo_lane")

    def process(self, port, entries):
        def task():
            return entries

        def finalize(res):
            pass

        self._pipe.push(task, finalize)

    def finalize(self):
        self._pipe.flush()
        self._pipe.shutdown()
