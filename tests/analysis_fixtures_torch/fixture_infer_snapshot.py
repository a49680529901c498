"""BTX-SNAPSHOT positive fixture: an inference broadcast-params state
class reachable from a spec factory with no ``demotion_snapshots()``.

The streaming-inference subsystem (docs/inference.md) keeps the params
pytree as broadcast device state; on repeated DeviceFault the step
demotes to the host apply, which only works if the state class can
drain the params row (and its swap generation) as host-format
snapshots.  This one can't — demotion would strand the broadcast
params on the faulted device.
"""


class BroadcastParamsState:
    """Batched forward pass over a broadcast params pytree; scores
    flow per-delivery but the params generation never drains
    host-side."""

    def __init__(self, params):
        self.params = params
        self.generation = 0

    def install_params(self, params, generation):
        self.params = params
        self.generation = generation

    def update(self, keys, values):
        return []


class EagerInferSpec:
    def make_state(self):
        return BroadcastParamsState({"w": 1.0})
