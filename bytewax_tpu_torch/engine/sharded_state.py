"""Tier selection for keyed aggregation and scan state.

The JAX package picks, most-capable first, a global-mesh exchange
tier, a per-process mesh-sharded tier, or a single-device slot table.
The port has the single-device slot table only: one H100 never
reaches the other two, and their multi-GPU counterparts are a later
part of the port.
"""

import os

from bytewax_tpu_torch.engine.xla import DeviceAggState

__all__ = ["make_agg_state", "make_scan_state"]


def _refuse_distributed(what: str) -> None:
    if os.environ.get("BYTEWAX_TPU_DISTRIBUTED") == "1":
        msg = (
            "BYTEWAX_TPU_DISTRIBUTED=1: the torch port has no "
            f"distributed {what} tier yet (ROADMAP queue A item 9, "
            "multi-GPU tiers); unset it to run single-device"
        )
        raise NotImplementedError(msg)


def make_agg_state(kind: str, driver=None) -> DeviceAggState:
    """Build aggregation state for one stateful step: a single-device
    slot table on the device :func:`bytewax_tpu_torch.utils.device`
    selects.

    ``BYTEWAX_TPU_DISTRIBUTED=1`` asks for the cluster-wide exchange
    tier, which the port does not have yet; it raises rather than
    silently giving each process a private table.
    """
    _refuse_distributed("aggregation")
    return DeviceAggState(kind)


def make_scan_state(scan_kind):
    """Build ``stateful_map`` scan state for one step: a single-device
    slot table on :func:`bytewax_tpu_torch.utils.device`.
    ``BYTEWAX_TPU_DISTRIBUTED=1`` raises, as for aggregations."""
    from bytewax_tpu_torch.engine.scan_accel import DeviceScanState

    _refuse_distributed("scan")
    return DeviceScanState(scan_kind)
