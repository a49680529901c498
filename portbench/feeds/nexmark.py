"""The NEXMark stream's blocks as columnar batches of int64
``event_type``, ``auction``, ``bidder``, ``price`` and ``date_time``
columns (the string fields ``url``, ``channel`` and ``extra``, which
q5 never reads, are projected away, as a columnar source with
projection pushed into it would), handed over as fast as the engine
pulls them (a closed loop)."""

import time

from bytewax_tpu_torch.engine.arrays import ArrayBatch

from portbench.sources import Part, Source

GENERATOR = "nexmark"
KEYS = ("batch_rows", "ring")


class Feed:
    def __init__(self, stream, traffic: dict, workdir):
        self.stream = stream

    def source(self, handed, seconds: float, max_blocks=None) -> Source:
        stream = self.stream

        def make():
            state = {"b": 0}

            def nxt():
                t0 = handed.start()
                b = state["b"]
                if (max_blocks is not None and b >= max_blocks) or (b and time.perf_counter() - t0 >= seconds):
                    raise StopIteration()
                batch = ArrayBatch(stream.columns(b))
                handed.add(b, stream.batch_rows)
                state["b"] = b + 1
                return batch

            return Part(nxt)

        return Source(make)

    def close(self) -> None:
        pass
