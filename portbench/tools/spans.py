"""One traced run of a cell, read by the program's own profiler ranges.

    python3 -m portbench.tools.spans --cell brc-10k.columnar --seed 7 \\
        --seconds 50 [--out spans.jsonl] [--cost]

Runs the cell once with ``--trace 1`` (in this process) and adds to
its result line what the trace holds of the ranges ``bytewax.<name>``
that the program opens while the profiler records (engine phases and
spans, on every thread):

- ``device_side``: names of device-timeline events that start with
  ``bytewax.`` (a range mirrored onto the device; there should be
  none);
- ``ranges``: for each range name inside the window, its count, the
  threads it ran on, its summed seconds, the seconds their union
  covers, and the device's idle seconds inside that union;
- ``counters``: the window's deltas of the program's span and device
  time counters, beside the trace's ``fold_s``.

``--cost`` first times the span helper alone on this host: host
microseconds a use with the profiler off and on.  Needs a CUDA card,
like ``portbench.run``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
_PREFIX = "bytewax."


def _overlap_us(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the intersection of two sets of disjoint sorted
    intervals (µs)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i, 0], b[j, 0])
        hi = min(a[i, 1], b[j, 1])
        if hi > lo:
            total += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total


def read_ranges(prof, busy_pairs, w0: float, w1: float) -> dict:
    """The ``bytewax.*`` ranges of a finished profile inside
    ``[w0, w1]`` (profiler µs), against the device's busy union."""
    from torch.autograd import DeviceType

    from portbench.devtrace import _union

    events = list(prof.events())
    device_side = sorted({e.name for e in events if e.device_type == DeviceType.CUDA and e.name.startswith(_PREFIX)})
    busy = _union(np.array(busy_pairs, dtype=np.float64).reshape(-1, 2))
    found = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.name.startswith(_PREFIX):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            found.setdefault(e.name, []).append((s, t, e.thread))
    ranges = {}
    for name, rs in sorted(found.items()):
        iv = _union(np.array([(s, t) for s, t, _ in rs], dtype=np.float64))
        covered = float((iv[:, 1] - iv[:, 0]).sum())
        ranges[name] = {
            "count": len(rs),
            "threads": len({th for _, _, th in rs}),
            "sum_s": sum(t - s for s, t, _ in rs) * 1e-6,
            "union_s": covered * 1e-6,
            "device_idle_s": (covered - _overlap_us(iv, busy)) * 1e-6,
        }
    return {"device_side": device_side, "ranges": ranges}


def span_cost(n: int = 200_000) -> dict:
    """Host µs a use of ``flight.span`` with the profiler off and on,
    and of the bare guard (``open_range`` off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bytewax_tpu_torch.engine import flight

    def per_use(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def use_span():
        with flight.span("cost_probe"):
            pass

    out = {"empty_us": per_use(lambda: None), "open_range_off_us": per_use(lambda: flight.open_range("cost_probe"))}
    out["span_off_us"] = per_use(use_span)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_on_us"] = per_use(use_span)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.tools.spans")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import devtrace, run

    if not torch.cuda.is_available():
        print("portbench.tools.spans: no CUDA card", file=sys.stderr)
        return 2
    line = {"cell": args.cell, "seed": args.seed, "power": run._power_limit(), "torch": torch.__version__}
    if args.cost:
        line["span_cost"] = span_cost()

    summary = devtrace.Tracer.summary
    extra = {}

    def reading(self):
        from torch.autograd import DeviceType

        out = summary(self)
        events = list(self._prof.events())
        marks = sorted(e.time_range.start for e in events if e.name == devtrace._MARK)
        busy = [
            (e.time_range.start, e.time_range.end)
            for e in events
            if e.device_type == DeviceType.CUDA and not e.name.startswith(devtrace._OURS)
        ]
        extra.update(read_ranges(self._prof, busy, marks[0], marks[-1]))
        return out

    devtrace.Tracer.summary = reading
    try:
        got = run.run_cell(ROOT, args.cell, args.seed, args.seconds, True)
    finally:
        devtrace.Tracer.summary = summary
    ctx = got["context"]
    result = got["result"]
    line.update(
        correct=result["correct"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        device=result["device"],
        device_ops=result["breakdown"]["device_ops"],
        idle_gaps=result["breakdown"]["idle_gaps"],
        fold_s=ctx.info.get("fold_device_s"),
        rows=ctx.rows,
        window_s=ctx.window_s,
        counters={k: v for k, v in (ctx.counters or {}).items() if k.endswith("_seconds") or k.startswith("device_transfer")},
        **extra,
    )
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
