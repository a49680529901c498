"""BTX-SNAPSHOT positive fixture: a device-tier state class reachable
from a dispatch-table factory with no ``demotion_snapshots()``."""


class OrphanDeviceState:
    """No demotion_snapshots and not global_exchange: demotion would
    strand this state on a faulted device."""

    def update(self, keys, values):
        return []


class OrphanAccelSpec:
    def make_state(self):
        return OrphanDeviceState()
