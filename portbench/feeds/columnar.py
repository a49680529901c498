"""Dictionary-encoded columnar batches (int16 station id, int16
deci-degrees, ``value_scale`` 0.1) handed over as fast as the engine
pulls them, a closed loop; each batch a fresh copy of a ring entry,
as a real source hands over new buffers."""

import time

from bytewax_tpu_torch.engine.arrays import ArrayBatch

from portbench.sources import Part, Source

KEYS = ("batch_rows", "ring")


class Feed:
    def __init__(self, stream, traffic: dict, workdir):
        self.stream = stream

    def source(self, handed, seconds: float, max_blocks=None) -> Source:
        """Hand blocks 0, 1, ... until ``seconds`` have passed since
        the first (or ``max_blocks`` were handed)."""
        stream = self.stream

        def make():
            state = {"b": 0}

            def nxt():
                t0 = handed.start()
                b = state["b"]
                if max_blocks is not None and b >= max_blocks:
                    raise StopIteration()
                if b and time.perf_counter() - t0 >= seconds:
                    raise StopIteration()
                batch = ArrayBatch(stream.columns(b), key_vocab=stream.stations.names, value_scale=0.1)
                handed.add(b, stream.batch_rows)
                state["b"] = b + 1
                return batch

            return Part(nxt)

        return Source(make)

    def close(self) -> None:
        pass
