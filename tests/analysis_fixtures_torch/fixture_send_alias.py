"""BTX-SEND positive fixture: an alias-smuggled raw send.

``c = self.comm`` then ``c.send(...)`` never puts a ``comm``-named
receiver on the call line, so the regex scan this analyzer replaced
(``_RAW_SEND_STRICT`` in the old tests/test_comm_invariants.py)
provably missed it — the resolver's alias tracking must not.
"""


class RogueOperator:
    def __init__(self, driver):
        self.comm = driver.comm

    def process(self, port, entries):
        c = self.comm
        shipper = c
        for w, items in entries:
            # An uncounted data frame: breaks the epoch barrier's
            # count-matched quiescence check.
            shipper.send(w, ("deliver", 0, "up", (w, items)))
