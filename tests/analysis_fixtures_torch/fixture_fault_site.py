"""BTX-FAULT positive fixture: an unknown fault site, and a device
mutation ordered before the fire."""

from bytewax_tpu_torch.engine import faults as _faults


class SloppyDispatch:
    def _process_device(self, entries):
        pass

    def dispatch(self, entries):
        # Unknown site: evades the pinned inventory.
        _faults.fire("device_dispatchx", step="s")

    def dispatch_late_fire(self, entries):
        # Mutates device state BEFORE the fault site: a DeviceFault
        # raised here would not be retryable.
        self._process_device(entries)
        _faults.fire("device_dispatch", step="s")

    def _spin_helper(self, entries):
        # Not itself a mutator name — but reaches one.
        self._process_device(entries)

    def dispatch_hidden_mutation(self, entries):
        # The mutation hides one call-graph hop away (the dispatch-
        # pipeline indirection shape): only the reachability walk
        # sees it.
        self._spin_helper(entries)
        _faults.fire("device_dispatch", step="s")
