"""The ticks stream's blocks as columnar ``key``/``ts`` batches,
handed over as fast as the engine pulls them (a closed loop)."""

import time

from bytewax_tpu_torch.engine.arrays import ArrayBatch

from portbench.sources import Part, Source

GENERATOR = "ticks"
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
