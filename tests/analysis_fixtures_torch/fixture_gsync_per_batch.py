"""BTX-GSYNC positive fixture: a collective reachable from a
per-batch path.

The sync round hides behind a helper AND a bound-method alias, so no
line matches the old ``global_sync\\s*\\(`` regex outside an
allowlisted file — yet ``process`` (a per-batch surface) transitively
enters a collective sync round, which deadlocks every peer that did
not receive the same delivery.
"""


class EagerExchange:
    def __init__(self, driver):
        self.driver = driver

    def _sync_now(self, payload):
        do_sync = self.driver.global_sync
        return do_sync(("rogue-round", 0), payload)

    def process(self, port, entries):
        for _w, items in entries:
            self._sync_now(len(items))
