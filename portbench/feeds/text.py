"""1BRC text: each ring entry written at set-up as one file of
``<station>;<temp>`` lines (one decimal) under the run's ``TMPDIR``;
the files are read in turn, again and again, each through the port's
``FileSource(columnar=True)`` in ``chunk_bytes`` chunks, a closed
loop that stops at the first file boundary past the window."""

import shutil
import time

import numpy as np

from portbench.sources import Part, Source

GENERATOR = "brc"
KEYS = ("batch_rows", "ring", "chunk_bytes")


def text_file(stream, r: int) -> bytes:
    """Ring entry ``r`` as 1BRC text."""
    blk = stream.blocks[r]
    names = np.array([s.encode("utf-8") + b";" for s in stream.stations.names.tolist()], dtype=object)
    temps = np.array([f"{q / 10:.1f}\n".encode() for q in range(-999, 1000)], dtype=object)
    parts = np.empty(2 * len(blk.ids), dtype=object)
    parts[0::2] = names[blk.ids]
    parts[1::2] = temps[blk.deci.astype(np.int64) + 999]
    return b"".join(parts.tolist())


class Feed:
    def __init__(self, stream, traffic: dict, workdir):
        self.stream = stream
        self.chunk_bytes = int(traffic["chunk_bytes"])
        self.dir = workdir
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        self.paths = []
        for r in range(stream.ring):
            path = workdir / f"measurements-{r:03d}.txt"
            path.write_bytes(text_file(stream, r))
            self.paths.append(path)

    def source(self, handed, seconds: float, max_blocks=None) -> Source:
        """``handed`` logs each file as it is finished."""
        from bytewax_tpu_torch.connectors.files import FileSource

        paths, lines = self.paths, self.stream.batch_rows
        chunk_bytes = self.chunk_bytes

        def make():
            state = {"i": 0, "part": None}

            def open_next():
                src = FileSource(paths[state["i"] % len(paths)], columnar=True, chunk_bytes=chunk_bytes)
                state["part"] = src.build_part("inp", src.list_parts()[0], None)

            def nxt():
                if handed.first is None:
                    handed.start()
                    open_next()
                while True:
                    try:
                        return state["part"].next_batch()
                    except StopIteration:
                        state["part"].close()
                        handed.add(state["i"] % len(paths), lines)
                        state["i"] += 1
                        if max_blocks is not None and state["i"] >= max_blocks:
                            raise
                        if time.perf_counter() - handed.first >= seconds:
                            raise
                        open_next()

            return Part(nxt)

        return Source(make)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
