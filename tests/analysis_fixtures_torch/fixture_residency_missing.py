"""BTX-SNAPSHOT positive fixtures for the residency pairing: a
device-tier state class reachable from a dispatch-table factory that
implements ``extract_keys`` with no ``inject_keys`` (stranded
evictions), and a ``global_exchange = True`` tier that implements the
residency surface at all (per-process eviction would desynchronize
the collective step shapes)."""


class HalfResidentState:
    """Evicts but cannot restore: extract_keys with no inject_keys."""

    def demotion_snapshots(self):
        return []

    def extract_keys(self, keys):
        return [(k, None) for k in keys]

    def update(self, keys, values):
        return []


class EvictingGlobalState:
    """Collective tier that wrongly exposes the residency surface."""

    global_exchange = True

    def extract_keys(self, keys):
        return []

    def inject_keys(self, items):
        pass


class HalfResidentSpec:
    def make_state(self):
        return HalfResidentState()


def make_agg_state(kind):
    return EvictingGlobalState()
