"""NEXMark events (a configuration's ``"generator": "nexmark"``), by the
rules of Apache Beam's ``NexmarkConfiguration`` and its generator
(``sdks/java/testing/nexmark``, ``GeneratorConfig``,
``AuctionGenerator``, ``BidGenerator``, ``PersonGenerator``), which the
Flink NEXMark suite (github.com/nexmark/nexmark) ports.

Global event ``n`` is a person, an auction or a bid by ``n mod 50``
(1 : 3 : 46), happens at ``t0_ms + n * inter_event_delay_us // 1000``
milliseconds (Beam's millisecond clock), and carries ids that follow
from ``n`` alone: auction ids rise through the whole stream.  A bid
goes to the first auction of the newest group of
``hot_auction_group`` with probability ``1 - 1 / hot_auction_ratio``,
and otherwise to one drawn uniformly over the
``num_in_flight_auctions`` newest auctions plus ``auction_id_lead``
ahead; its bidder and price follow the same generator.  The random
draws of block ``b`` (events ``b * batch_rows`` onward) come from ring
entry ``b % ring``, made from the seed, so the seed changes the draws
and never the sizes.
"""

import numpy as np

__all__ = ["EVENT_TYPES", "Stream"]

#: ``event_type`` codes: Beam's person, auction and bid.
EVENT_TYPES = {"person": 0, "auction": 1, "bid": 2}

#: The configuration keys this generator reads, with the only values
#: it implements where Beam's rules fix them.
_FIXED = {"person_proportion": 1, "auction_proportion": 3, "bid_proportion": 46}


class Stream:
    def __init__(self, cfg: dict, traffic: dict, seed: int):
        for key, value in _FIXED.items():
            if cfg[key] != value:
                msg = f"{key} {cfg[key]!r}: the nexmark generator implements {value} only"
                raise ValueError(msg)
        self.cfg = cfg
        self.batch_rows = int(traffic["batch_rows"])
        self.ring = int(traffic["ring"])
        shape = (self.ring, self.batch_rows)
        rng = np.random.default_rng(abs(int(seed)))
        # Beam: ``random.nextInt(hotAuctionRatio) > 0`` picks the hot
        # auction, ``nextInt(hotBiddersRatio) > 0`` the hot bidder.
        self.hot_auction = rng.integers(0, int(cfg["hot_auction_ratio"]), size=shape) > 0
        self.hot_bidder = rng.integers(0, int(cfg["hot_bidders_ratio"]), size=shape) > 0
        self.u_auction = rng.random(shape)
        self.u_bidder = rng.random(shape)
        self.u_price = rng.random(shape)

    def _n(self, blocks) -> np.ndarray:
        """Global event numbers of ``blocks``, ``[len(blocks), batch_rows]``."""
        blocks = np.asarray(blocks, dtype=np.int64).reshape(-1, 1)
        return blocks * self.batch_rows + np.arange(self.batch_rows, dtype=np.int64)

    def events(self, blocks) -> dict:
        """Every event of the given global blocks, in order, as int64
        columns: ``event_type``, ``auction`` (a bid's auction, an
        auction's own id, 0 for a person), ``bidder`` (a bid's bidder,
        a person's own id, 0 for an auction), ``price`` (a bid's, in
        cents; 0 otherwise) and ``date_time`` (microseconds since the
        epoch)."""
        cfg = self.cfg
        n = self._n(blocks)
        r = np.asarray(blocks, dtype=np.int64) % self.ring
        total = _FIXED["person_proportion"] + _FIXED["auction_proportion"] + _FIXED["bid_proportion"]
        epoch, off = np.divmod(n, total)
        person = off < _FIXED["person_proportion"]
        auction_ev = ~person & (off < _FIXED["person_proportion"] + _FIXED["auction_proportion"])
        bid = ~person & ~auction_ev
        kind = np.where(person, EVENT_TYPES["person"],
                        np.where(auction_ev, EVENT_TYPES["auction"], EVENT_TYPES["bid"]))
        # Beam's lastBase0AuctionId / lastBase0PersonId.
        per_a = _FIXED["auction_proportion"]
        last_auction = np.where(
            person, (epoch - 1) * per_a + per_a - 1,
            np.where(auction_ev, epoch * per_a + off - _FIXED["person_proportion"], epoch * per_a + per_a - 1),
        )
        last_person = epoch * _FIXED["person_proportion"]

        # A bid's auction: the hot one, or one of the in-flight ones
        # plus the lead (Beam's nextBase0AuctionId).
        group = int(cfg["hot_auction_group"])
        hot_auction = (last_auction // group) * group
        lo = np.maximum(last_auction - int(cfg["num_in_flight_auctions"]), 0)
        span = last_auction - lo + 1 + int(cfg["auction_id_lead"])
        cold_auction = lo + np.floor(self.u_auction[r] * span).astype(np.int64)
        bid_auction = np.where(self.hot_auction[r], hot_auction, cold_auction)
        # A bid's bidder (Beam's BidGenerator and nextBase0PersonId).
        pgroup = int(cfg["hot_bidder_group"])
        hot_bidder = (last_person // pgroup) * pgroup + 1
        active = np.minimum(last_person + 1, int(cfg["num_active_people"]))
        pspan = active + int(cfg["person_id_lead"])
        cold_bidder = last_person + 1 - active + np.floor(self.u_bidder[r] * pspan).astype(np.int64)
        bid_bidder = np.where(self.hot_bidder[r], hot_bidder, cold_bidder)
        # Beam's PriceGenerator: Math.round(10 ^ (u * 6) * 100) cents.
        price = np.floor(10.0 ** (self.u_price[r] * 6.0) * 100.0 + 0.5).astype(np.int64)

        first_a, first_p = int(cfg["first_auction_id"]), int(cfg["first_person_id"])
        out = {
            "event_type": kind,
            "auction": np.where(bid, bid_auction + first_a, np.where(auction_ev, last_auction + first_a, 0)),
            "bidder": np.where(bid, bid_bidder + first_p, np.where(person, last_person + first_p, 0)),
            "price": np.where(bid, price, 0),
            "date_time": (int(cfg["t0_ms"]) + n * int(cfg["inter_event_delay_us"]) // 1000) * 1000,
        }
        return {k: np.ascontiguousarray(v, dtype=np.int64).ravel() for k, v in out.items()}

    def columns(self, b: int) -> dict:
        """Global block ``b`` as the port's int64 columns."""
        return self.events([b])
