"""Ticks (a configuration's ``"generator": "ticks"``): seeded
``(key, event time)`` events whose keys keep rising, for a test of a
configuration that is not 1BRC.

Global event ``i`` happens at ``t0_us + i * step_us`` and goes to the
key ``i // per_key`` plus a seeded jitter below ``keys_ahead``: new
keys arrive all the time and old ones go quiet.  Block ``b`` holds
events ``b * batch_rows`` onward and takes its jitter from ring entry
``b % ring``; the seed changes the jitter, never the sizes.
"""

import numpy as np

__all__ = ["Stream"]


class Stream:
    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.cfg = cfg
        self.batch_rows = int(traffic["batch_rows"])
        self.ring = int(traffic["ring"])
        rng = np.random.default_rng(abs(int(seed)))
        self.jitter = rng.integers(0, int(cfg["keys_ahead"]), size=(self.ring, self.batch_rows))

    def events(self, blocks) -> tuple:
        """``(key, ts_us)`` int64 arrays of the given global blocks, in
        order."""
        blocks = np.asarray(blocks, dtype=np.int64).reshape(-1, 1)
        i = blocks * self.batch_rows + np.arange(self.batch_rows)
        key = i // int(self.cfg["per_key"]) + self.jitter[blocks[:, 0] % self.ring]
        ts = int(self.cfg["t0_us"]) + i * int(self.cfg["step_us"])
        return key.ravel(), ts.ravel()

    def columns(self, b: int) -> dict:
        """Global block ``b`` as the port's columns: string keys and
        int64 event times in microseconds."""
        key, ts = self.events([b])
        return {"key": np.char.add("k", key.astype(str)), "ts": ts}
