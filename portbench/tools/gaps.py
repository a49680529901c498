"""One run of a window cell, as ``python3 -m portbench.run`` makes it,
with the wall-clock gaps between the device window tier's ingests
taken beside it.  ``EventClock``'s watermark runs on with the system
clock, so a row that is in order in event time turns late once two
ingests of its key lie further apart than the clock's wait.

    python3 -m portbench.tools.gaps --workload nexmark-q5.events \\
        --seed 7 --seconds 50 --trace 0

Prints what ``portbench.run`` prints (its info line holds the window's
full collections: ``gc_full``, ``gc_full_s``, ``gc_full_max_s``), then
one line ``{"portbench_gaps": {...}}``: for each window state of the
measured flow, its ingests, the widest gap between two of them, the
three widest, and when the widest began (seconds after the first).
"""

import json
import sys
import time


def widest(times: list, n: int = 3) -> dict:
    """The ingests of one window state and the widest gaps between
    them."""
    gaps = sorted(((b - a, a) for a, b in zip(times, times[1:])), reverse=True)
    return {
        "ingests": len(times),
        "widest_gap_s": gaps[0][0] if gaps else 0.0,
        "widest_at_s": gaps[0][1] - times[0] if gaps else None,
        "gaps_s": [g for g, _a in gaps[:n]],
    }


def main(argv=None) -> int:
    import bytewax_tpu_torch.testing as testing
    from bytewax_tpu_torch.engine import window_accel as wa

    from portbench import run

    flows = []
    run_main = testing.run_main

    def counted_run_main(flow, *args, **kwargs):
        flows.append([])
        return run_main(flow, *args, **kwargs)

    ingest = wa.DeviceWindowAggState._ingest

    def timed_ingest(self, *args, **kwargs):
        states = flows[-1]
        for state, times in states:
            if state is self:
                break
        else:
            times = []
            states.append((self, times))
        times.append(time.perf_counter())
        return ingest(self, *args, **kwargs)

    testing.run_main = counted_run_main
    wa.DeviceWindowAggState._ingest = timed_ingest
    try:
        rc = run.main(argv)
    finally:
        testing.run_main = run_main
        wa.DeviceWindowAggState._ingest = ingest
    # The first flow is the warm-up; the last is the measured window.
    states = flows[-1] if len(flows) > 1 else []
    print(json.dumps({"portbench_gaps": [widest(times) for _state, times in states]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
