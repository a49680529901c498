"""The 1BRC generator (a configuration's ``"generator": "brc"``).

Every row of a 1BRC cell comes from here, from the seed alone: a
station id and a reading in deci-degrees.  A configuration file fixes
the stations (how many, their UTF-8 names, each one's mean, how they
are drawn) and the readings; a traffic file fixes the batch size and
the ring of distinct batches, and names the feed (``feeds/<feed>.py``)
that hands them to the port.  The seed changes the values, never the
sizes, so every seed does the same amount of work.  A value of the
configuration that the generator does not implement is refused, never
ignored.

Adapted from ``bytewax_tpu_torch/models/brc.py`` ``generate_batches``
(a sound generator, but program code the benchmark must not depend
on), changed to the 1BRC ``CreateMeasurements`` shape: each station
has its own mean, readings are gaussian around it with a fixed
standard deviation, rounded to 0.1 and clipped to +-99.9.
"""

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["RowBlock", "Stations", "Stream", "stations_of"]

# Characters station names are made of, with their UTF-8 widths
# (1, 2 and 3 bytes); never ';' or '\n'.
_ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ -'"
_WIDE = "éèöüñçåøßíóúâêô"
_CJK = "北京東南西都市川山"


@dataclass
class Stations:
    """The key set: ``names`` (a ``U`` array, index = station id) and
    each station's mean reading in deci-degrees."""

    names: np.ndarray
    mean_deci: np.ndarray


def _name(rng: np.random.RandomState, n_bytes: int, ascii_only: bool = False) -> str:
    """A name of exactly ``n_bytes`` UTF-8 bytes."""
    out, used = [], 0
    while used < n_bytes:
        left = n_bytes - used
        u = 1.0 if ascii_only else rng.rand()
        if left >= 3 and u < 0.03:
            ch = _CJK[rng.randint(len(_CJK))]
        elif left >= 2 and u < 0.12:
            ch = _WIDE[rng.randint(len(_WIDE))]
        else:
            ch = _ASCII[rng.randint(len(_ASCII))]
        # No name starts or ends with a space: a reader may strip it.
        if ch == " " and (used == 0 or left == 1):
            ch = "x"
        out.append(ch)
        used += len(ch.encode("utf-8"))
    return "".join(out)


def stations_of(cfg: dict, seed: int) -> Stations:
    """The configuration's stations for ``seed``: unique names whose
    byte lengths follow ``name_bytes.bands`` (share, shortest,
    longest), the first name as short and the second as long as the
    configuration allows, that one in ASCII (so the longest line, which
    sets the width of a decoded text chunk, is the same for every
    seed); means uniform over ``station_mean_c``."""
    rng = np.random.RandomState(_sub_seed(seed, 1))
    n = int(cfg["stations"])
    spec = cfg["name_bytes"]
    shares = np.array([b[0] for b in spec["bands"]], dtype=np.float64)
    band = rng.choice(len(shares), size=n, p=shares / shares.sum())
    lo = np.array([b[1] for b in spec["bands"]])[band]
    hi = np.array([b[2] for b in spec["bands"]])[band]
    lengths = lo + (rng.rand(n) * (hi - lo + 1)).astype(np.int64)
    lengths[0] = spec["min"]
    if n > 1:
        lengths[1] = spec["max"]
    seen = set()
    names = []
    for i, k in enumerate(lengths.tolist()):
        name = _name(rng, k, ascii_only=i == 1)
        while name in seen:
            name = _name(rng, k, ascii_only=i == 1)
        seen.add(name)
        names.append(name)
    mean = cfg["station_mean_c"]
    mean_deci = rng.uniform(mean["low"], mean["high"], size=n) * 10.0
    return Stations(np.array(names), mean_deci)


def _sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for numpy's legacy generator, from a seed of any
    size and a stream number."""
    mask = 2**64 - 1
    seq = np.random.SeedSequence([int(seed) & mask, (int(seed) >> 64) & mask, stream])
    return int(seq.generate_state(1)[0])


@dataclass
class RowBlock:
    """One ring entry: station ids (int16) and readings (int16
    deci-degrees)."""

    ids: np.ndarray
    deci: np.ndarray


def _draw(cfg: dict, rng: np.random.RandomState, n_keys: int, n: int) -> np.ndarray:
    """``n`` station ids by the configuration's ``station_draw``:
    ``"uniform"``, or ``{"zipf": s}``, where the station of rank ``r``
    (a seeded order) is drawn in proportion to ``r ** -s``."""
    draw = cfg["station_draw"]
    if draw == "uniform":
        return rng.randint(0, n_keys, size=n)
    if isinstance(draw, dict) and set(draw) == {"zipf"} and float(draw["zipf"]) > 0:
        weight = np.arange(1, n_keys + 1, dtype=np.float64) ** -float(draw["zipf"])
        rank = rng.permutation(n_keys)
        return rank[rng.choice(n_keys, size=n, p=weight / weight.sum())]
    msg = f"station_draw {draw!r}: the generator draws 'uniform' or {{'zipf': s}} only"
    raise ValueError(msg)


class Stream:
    """The row stream of one cell and seed.

    Global block ``b`` holds rows ``b * batch_rows`` onward and takes
    its ids and readings from ring entry ``b % ring``.  Made once at
    set-up, in a few large numpy calls."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        if cfg.get("reading_decimals") != 1:
            msg = f"reading_decimals {cfg.get('reading_decimals')!r}: readings are int16 tenths, 1 decimal only"
            raise ValueError(msg)
        self.cfg = cfg
        self.seed = int(seed)
        self.stations = stations_of(cfg, seed)
        self.batch_rows = int(traffic["batch_rows"])
        self.ring = int(traffic["ring"])
        n_keys = len(self.stations.names)
        if n_keys >= 2**15:
            msg = f"{n_keys} stations do not fit the int16 id column"
            raise ValueError(msg)
        rng = np.random.RandomState(_sub_seed(seed, 2))
        n = self.batch_rows * self.ring
        ids = _draw(cfg, rng, n_keys, n).astype(np.int16)
        sd = float(cfg["reading_sd_c"]) * 10.0
        clip = int(round(float(cfg["reading_clip_c"]) * 10))
        deci = np.clip(
            np.round(self.stations.mean_deci[ids] + rng.randn(n) * sd), -clip, clip
        ).astype(np.int16)
        self.blocks: List[RowBlock] = []
        for r in range(self.ring):
            sl = slice(r * self.batch_rows, (r + 1) * self.batch_rows)
            self.blocks.append(RowBlock(ids[sl].copy(), deci[sl].copy()))

    def columns(self, b: int) -> Dict[str, np.ndarray]:
        """Fresh arrays of global block ``b`` (new buffers, as a real
        source hands over)."""
        blk = self.blocks[b % self.ring]
        return {"key_id": blk.ids.copy(), "value": blk.deci.copy()}

    def rows_of(self, blocks) -> tuple:
        """``(ids, deci)`` of the given global blocks in order, for the
        reference's tests."""
        blocks = np.asarray(blocks, dtype=np.int64) % self.ring
        ids = np.concatenate([self.blocks[r].ids for r in blocks.tolist()])
        deci = np.concatenate([self.blocks[r].deci for r in blocks.tolist()])
        return ids, deci
