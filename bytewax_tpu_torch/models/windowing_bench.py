"""Event-time windowing benchmark flow (reference:
``examples/benchmark_windowing.py``): fold_window over 1-minute
tumbling windows, event timestamps, 2 keys."""

import random
from datetime import datetime, timedelta, timezone

import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as w
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.operators.windowing import EventClock, TumblingWindower
from bytewax_tpu_torch.outputs import Sink

__all__ = ["ALIGN_TO", "make_input", "windowing_bench_flow"]

ALIGN_TO = datetime(2022, 1, 1, tzinfo=timezone.utc)


def make_input(batch_size: int, batch_count: int):
    return [
        ALIGN_TO + timedelta(seconds=i) for i in range(batch_size)
    ] * batch_count


def windowing_bench_flow(source, sink: Sink, n_keys: int = 2) -> Dataflow:
    clock = EventClock(
        ts_getter=lambda x: x,
        wait_for_system_duration=timedelta(seconds=0),
    )
    windower = TumblingWindower(align_to=ALIGN_TO, length=timedelta(minutes=1))
    rand = random.Random(42)

    flow = Dataflow("bench")
    wo = (
        op.input("in", flow, source)
        .then(op.key_on, "key-on", lambda _: str(rand.randrange(0, n_keys)))
        .then(
            w.fold_window,
            "fold-window",
            clock,
            windower,
            list,
            lambda acc, x: (acc.append(x), acc)[1],
            lambda a, b: a + b,
        )
    )
    flat = op.flat_map("flatten-window", wo.down, lambda kv: iter(kv[1]))
    filtered = op.filter("filter_all", flat, lambda _x: False)
    op.output("out", filtered, sink)
    return flow
