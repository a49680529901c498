"""The traced run's device timeline, read with ``torch.profiler``.

:class:`Tracer` wraps the measured window of a ``--trace 1`` run.  It
puts the engine's fold dispatch (``ops.fold_kernel.fold``, which every
keyed aggregation and window fold calls) inside a
``record_function("portbench.fold")`` range from outside the program,
records the main thread's epoch-ledger phases as the engine reports
them (``engine.flight.note_phase``), and profiles CPU and CUDA activity
on every thread.  :meth:`Tracer.summary` reduces the trace to:

- ``busy_s``: the union of all device activity (kernels, copies,
  memsets) inside the window, and ``window_s``, its length;
- ``fold_s``: the device time of every kernel launched under the fold
  range, whatever its name (the activities inside the range's span on
  the device's timeline), and ``fold_calls``;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: the device's idle time by the ledger phase the main
  thread was in (the innermost one), largest first.
"""

import time
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Tracer"]

FOLD_RANGE = "portbench.fold"
_MARK = "portbench.mark"
_OURS = "portbench."


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merge ``[start, end]`` rows (sorted or not) into disjoint
    intervals."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    starts = iv[new, 0]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]]
    return np.stack([starts, ends], axis=1)


def _inside(acts, ranges: np.ndarray) -> Tuple[float, int]:
    """Device time (µs) and number of the activities that lie within
    one of the ``ranges`` (``[start, end]`` µs, the fold range's span
    on the device's timeline)."""
    if not len(ranges) or not acts:
        return 0.0, 0
    ranges = _union(ranges)
    starts = np.array([e.time_range.start for e in acts], dtype=np.float64)
    ends = np.array([e.time_range.end for e in acts], dtype=np.float64)
    k = np.searchsorted(ranges[:, 0], starts, side="right") - 1
    ok = k >= 0
    kk = np.maximum(k, 0)
    ok &= ends <= ranges[kk, 1] + 1.0
    return float((ends - starts)[ok].sum()), int(ok.sum())


class Tracer:
    """Profile one measured window; see the module's docstring."""

    def __init__(self):
        self._prof = None
        self._cuda = False
        self._undo: List[tuple] = []
        self._phases: List[Tuple[str, float, float]] = []
        self._marks: List[float] = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from bytewax_tpu_torch.engine import flight
        from bytewax_tpu_torch.ops import fold_kernel

        fold = fold_kernel.fold

        def ranged_fold(*args, **kwargs):
            with record_function(FOLD_RANGE):
                return fold(*args, **kwargs)

        note = flight.note_phase
        phases = self._phases

        def noting(phase, step_id, seconds, gross=None, t0=None, lane=0):
            if lane == 0 and t0 is not None:
                phases.append((phase, t0, gross if gross is not None else seconds))
            return note(phase, step_id, seconds, gross=gross, t0=t0, lane=lane)

        self._undo = [(fold_kernel, "fold", fold), (flight, "note_phase", note)]
        fold_kernel.fold = ranged_fold
        flight.note_phase = noting
        kwargs = {}
        try:
            kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True
            )
        except (AttributeError, TypeError):
            pass
        self._record_function = record_function
        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=activities, **kwargs)
        self._prof.__enter__()
        self._mark()
        return self

    def _mark(self) -> None:
        self._marks.append(time.monotonic())
        with self._record_function(_MARK):
            pass

    def __exit__(self, *exc):
        import torch

        try:
            if self._cuda:
                torch.cuda.synchronize()
            self._mark()
        finally:
            self._prof.__exit__(*exc)
            for obj, name, fn in self._undo:
                setattr(obj, name, fn)
        return False

    def summary(self) -> Dict[str, object]:
        from torch.autograd import DeviceType

        events = list(self._prof.events())
        marks = sorted(e.time_range.start for e in events if e.name == _MARK)
        w0, w1 = marks[0], marks[-1]
        # Profiler µs -> time.monotonic() s.
        offset = self._marks[0] - w0 * 1e-6
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        # The profiler mirrors each range on the device's timeline (a
        # user annotation spanning the kernels launched in it): those
        # are spans, not activity.
        ranges = np.array(
            [(e.time_range.start, e.time_range.end) for e in dev if e.name == FOLD_RANGE],
            dtype=np.float64,
        ).reshape(-1, 2)
        acts = [e for e in dev if not e.name.startswith(_OURS)]
        iv = np.array(
            [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in acts],
            dtype=np.float64,
        ).reshape(-1, 2)
        iv = iv[iv[:, 1] > iv[:, 0]]
        busy = _union(iv)
        busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
        by_name: Dict[str, float] = {}
        for e in acts:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        folds = [e for e in events if e.name == FOLD_RANGE and e.device_type == DeviceType.CPU]
        fold_us, fold_kernels = _inside(acts, ranges)
        gaps = self._gaps(busy, w0, w1, offset)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy_us * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "fold_s": fold_us * 1e-6,
            "fold_calls": len(folds),
            "fold_kernels": fold_kernels,
            "device_ops": [[name[:160], us * 1e-6] for name, us in top],
            "idle_gaps": gaps,
        }

    def _gaps(self, busy: np.ndarray, w0: float, w1: float, offset: float) -> list:
        """Idle device time inside the window, by the innermost ledger
        phase the main thread was in (sampled every 20 µs)."""
        edges = np.r_[w0, busy.ravel(), w1] if len(busy) else np.array([w0, w1])
        idle = edges.reshape(-1, 2)
        idle = idle[idle[:, 1] > idle[:, 0]]
        if not len(idle):
            return []
        step = 20.0
        n = np.maximum(np.ceil((idle[:, 1] - idle[:, 0]) / step).astype(np.int64), 1)
        width = (idle[:, 1] - idle[:, 0]) / n
        first = np.repeat(idle[:, 0], n)
        rank = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        pts = first + (rank + 0.5) * np.repeat(width, n)
        wts = np.repeat(width, n) * 1e-6
        pts_mono = pts * 1e-6 + offset
        label = np.full(len(pts), -1, dtype=np.int64)
        names = sorted({p for p, _t, _d in self._phases})
        code = {p: i for i, p in enumerate(names)}
        # Longest first, so the innermost phase is written last.
        for phase, t0, dur in sorted(self._phases, key=lambda x: -x[2]):
            lo = np.searchsorted(pts_mono, t0, side="left")
            hi = np.searchsorted(pts_mono, t0 + dur, side="right")
            label[lo:hi] = code[phase]
        totals = np.bincount(label + 1, weights=wts, minlength=len(names) + 1)
        out = [["outside_ledger_phases", float(totals[0])]] + [
            [names[i], float(totals[i + 1])] for i in range(len(names))
        ]
        out = [kv for kv in out if kv[1] > 0]
        return sorted(out, key=lambda kv: -kv[1])[:10]

