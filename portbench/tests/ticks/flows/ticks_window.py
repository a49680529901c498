"""Events per key in sliding event-time windows: the port's
``count_window`` over columnar ``key``/``ts`` batches, which lowers to
the device window tier (``engine/window_accel.py``)."""

from datetime import datetime, timedelta, timezone

import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as win
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine.arrays import column_ts


def build(source, sinks: dict, cfg: dict, params: dict) -> Dataflow:
    """``sinks["down"]`` receives ``(key, (window id, count))``."""
    align = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(microseconds=int(cfg["t0_us"]))
    # The clock's watermark also runs on with the host's time: the wait
    # keeps a key's next event on time across a slow batch.
    wait = timedelta(microseconds=int(cfg["wait_us"]))
    clock = win.EventClock(ts_getter=column_ts, wait_for_system_duration=wait)
    windower = win.SlidingWindower(
        length=timedelta(microseconds=int(cfg["window_us"])),
        offset=timedelta(microseconds=int(cfg["offset_us"])),
        align_to=align,
    )
    flow = Dataflow("portbench_ticks")
    s = op.input("inp", flow, source)
    wo = win.count_window("count", s, clock, windower, key=lambda x: x)
    op.output("down", wo.down, sinks["down"])
    return flow
