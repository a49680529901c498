"""Run one benchmark cell of the PyTorch and CUDA port once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name, so a new
configuration, cell, traffic mix or metric is a new file:

- ``portbench/configs/<config>.json``: the deployment (the generator
  that makes its data, the data's shape, guarantees, the limits of the
  comparison);
- ``portbench/traffic/<traffic>.json``: the generator's batch size and
  ring, and the feed that hands the rows over, with its parameters;
- ``portbench/cells/<cell>.json``: the flow, its parameters, program
  knobs, the kernels the window must launch, warm-up and the fold's
  row bytes;
- ``portbench/generators/<generator>.py``, ``portbench/feeds/<feed>.py``,
  ``portbench/flows/<flow>.py``, ``portbench/reference/<config>.py``
  (which packs the sink's items, works out the expected results and
  judges them), ``portbench/metrics/<metric>.py``.

A run makes its inputs from the seed, warms up on this cell's own
shapes, measures for ``--seconds``, checks every result at the sink
against the plain reference, and prints one JSON line.  It needs CUDA
cards: without them, or when the window did not run on them (a
demotion to the host tier, no launch of a kernel the cell names), it
exits non-zero and prints no result.
"""

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from datetime import timedelta
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bytewax_tpu")
#: What every ``reference/<config>.py`` gives the run.
REFERENCE = ("expect", "pack", "canon", "judge")


def _process_age_s() -> Optional[float]:
    """Seconds since this process started, from ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


_AGE = _process_age_s()
#: The process's start on the ``perf_counter`` clock.
PROCESS_START = time.perf_counter() - (_AGE if _AGE is not None else 0.0)


class BenchError(RuntimeError):
    """The run cannot give a result (no card, a missing file, a
    forbidden module)."""


# -- finding things by name ------------------------------------------------


def _read_json(path: Path) -> dict:
    if not path.is_file():
        msg = f"{path} is missing"
        raise BenchError(msg)
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the module at ``path`` (names may hold '-' and '.')."""
    if not path.is_file():
        msg = f"{path} is missing"
        raise BenchError(msg)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one workload of ``BENCHMARK.json`` names."""

    name: str
    bench: dict
    workload: dict
    cfg: dict
    traffic: dict
    spec: dict
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, kind: str) -> list:
        """This cell's metrics of ``end_to_end`` or ``per_layer``."""
        return [
            m for m in self.bench[kind]
            if "workloads" not in m or self.name in m["workloads"]
        ]

    def module(self, folder: str, name: str):
        return load_module(self.bench_dir / folder / f"{name}.py", f"portbench_{folder}_{name}")

    def generator(self):
        """The configuration's generator's ``Stream`` class."""
        return self.module("generators", self.cfg["generator"]).Stream

    def feed(self):
        """The traffic's feed class, its parameters checked against the
        ones the feed reads, its generator against the
        configuration's."""
        params = {k: v for k, v in self.traffic.items() if k not in ("feed", "why")}
        mod = self.module("feeds", self.traffic["feed"])
        if set(params) != set(mod.KEYS):
            msg = (f"traffic {self.workload['traffic']!r} gives {sorted(params)}; "
                   f"feed {self.traffic['feed']!r} reads {sorted(mod.KEYS)}")
            raise BenchError(msg)
        if getattr(mod, "GENERATOR", None) != self.cfg["generator"]:
            msg = (f"feed {self.traffic['feed']!r} reads generator {getattr(mod, 'GENERATOR', None)!r}; "
                   f"configuration {self.workload['config']!r} names {self.cfg['generator']!r}")
            raise BenchError(msg)
        return mod.Feed

    def reference(self, *extra: str):
        """The configuration's plain reference, with every function of
        ``REFERENCE`` (and of ``extra``)."""
        mod = self.module("reference", self.workload["config"])
        lacks = [f for f in REFERENCE + extra if not callable(getattr(mod, f, None))]
        if lacks:
            msg = f"reference {self.workload['config']!r} has no {', '.join(lacks)}"
            raise BenchError(msg)
        return mod


def find_cell(root: Path, name: str, overrides: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its
    configuration, traffic and cell files; ``overrides`` (tests and
    tools only) replaces keys of ``cfg``, ``traffic`` or ``spec``."""
    bench = _read_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        msg = f"BENCHMARK.json has no workload {name!r}"
        raise BenchError(msg)
    wl = found[0]
    bench_dir = root / bench["paths"][0]
    cfg = _read_json(bench_dir / "configs" / f"{wl['config']}.json")
    traffic = _read_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    spec = _read_json(bench_dir / "cells" / f"{name}.json")
    for part, values in (overrides or {}).items():
        {"cfg": cfg, "traffic": traffic, "spec": spec}[part].update(values)
    gen = cfg.get("generator")
    if not gen:
        msg = f"configuration {wl['config']!r} names no generator (\"generator\": a module of generators/)"
        raise BenchError(msg)
    if not (bench_dir / "generators" / f"{gen}.py").is_file():
        msg = f"configuration {wl['config']!r} names generator {gen!r}: generators/{gen}.py is missing"
        raise BenchError(msg)
    return Cell(name, bench, wl, cfg, traffic, spec, bench_dir)


# -- the run -----------------------------------------------------------------


@dataclass
class Context:
    """What a metric reader may read; a field is None where the run
    has nothing of the kind."""

    cell: Cell
    setup_s: float
    window_s: float
    rows: int
    phases: Optional[Dict[str, float]] = None
    counters: Optional[Dict[str, float]] = None
    trace: Optional[dict] = None
    fold_bytes: Optional[float] = None
    peak_bytes_per_s: Optional[float] = None
    info: Dict[str, Any] = field(default_factory=dict)


def _set_env(cell: Cell, device: str) -> None:
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if device == "cpu":
        os.environ["BYTEWAX_TPU_PLATFORM"] = "cpu"
    else:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    for k, v in cell.spec.get("knobs", {}).items():
        os.environ[k] = str(v)


def _check_program(root: Path) -> None:
    """The port must be the checkout's own."""
    try:
        import bytewax_tpu_torch
    except ImportError as ex:
        msg = f"the checkout holds no bytewax_tpu_torch ({ex})"
        raise BenchError(msg) from None

    where = Path(bytewax_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        msg = f"bytewax_tpu_torch comes from {where}, not from the checkout {root}"
        raise BenchError(msg)


def _sinks(cell: Cell, ref, stream):
    from portbench.sources import TimedSink

    def packer(name):
        return lambda items: ref.pack(name, items, stream)

    return {name: TimedSink(packer(name)) for name in cell.spec.get("sinks", ["down"])}


def _launches(names) -> Dict[str, int]:
    """Launches so far of the port's kernels ``ops.<name>``."""
    out = {}
    for name in names:
        mod = importlib.import_module(f"bytewax_tpu_torch.ops.{name}")
        out[name] = int(mod.launches)
    return out


def off_card(counters: Dict[str, float], launches: Dict[str, int], on_card: bool) -> list:
    """Why the window's work did not run on the card, from the
    window's counter and launch deltas: a demotion to the host tier,
    or a kernel the cell names that never launched.  Empty when it
    did."""
    why = []
    if counters.get("demotion_count", 0):
        why.append(f"{counters['demotion_count']:g} demotion(s) to the host tier in the window")
    if on_card:
        why += [f"no launch of ops.{k} in the window" for k, n in launches.items() if n <= 0]
    return why


def _cpu_s() -> float:
    """The process's CPU seconds so far, every thread's."""
    t = os.times()
    return t.user + t.system


def _slice_rates(handed, last: float, width: float = 10.0) -> list:
    """Rows a second handed over in each ``width``-second slice of the
    window (the last slice runs on to the last result)."""
    if handed.first is None or not handed.times:
        return []
    per = handed.rows / len(handed.times)
    span = last - handed.first
    n = max(1, int(span // width))
    counts = [0] * n
    for t in handed.times:
        counts[min(n - 1, int((t - handed.first) // width))] += 1
    spans = [width] * (n - 1) + [span - width * (n - 1)]
    return [round(c * per / s) if s > 0 else None for c, s in zip(counts, spans)]


class _GcWatch:
    """Counts the interpreter's full collections in the window and how
    long they paused it (an observation only; collection is left as
    the program has it)."""

    def __init__(self):
        self.pauses = []
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append(time.perf_counter() - self._t0)
            self._t0 = None

    def undo(self) -> dict:
        gc.callbacks.remove(self._cb)
        return {"gc_full": len(self.pauses), "gc_full_s": sum(self.pauses),
                "gc_full_max_s": max(self.pauses, default=0.0)}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None, tmp: Optional[Path] = None,
             fault=None) -> dict:
    """One run of cell ``name``; returns ``{"result": <the JSON line's
    object>, "context": Context, "verdict": Verdict}``.  ``device``
    ``cpu`` (tests only) runs the port's device tier on the CPU;
    ``fault`` (tests only) is called with no argument after the
    warm-up and returns an undo function: it breaks the timed path.
    Raises :class:`BenchError` where the window did not run on the
    card."""
    cell = find_cell(root, name, overrides)
    _set_env(cell, device)
    import torch

    on_card = device != "cpu"
    _check_program(ROOT)
    from bytewax_tpu_torch.engine import flight
    from bytewax_tpu_torch.testing import run_main

    from portbench import roofline
    from portbench.sources import Handed

    feed_cls = cell.feed()
    stream_cls = cell.generator()
    ref = cell.reference()
    flows = cell.module("flows", cell.spec["flow"])
    stream = stream_cls(cell.cfg, cell.traffic, seed)
    workdir = Path(tmp or tempfile.gettempdir()) / f"portbench_{cell.name}"
    feed = feed_cls(stream, cell.traffic, workdir)
    # bytewax's default epoch interval unless the cell sets one.
    epoch = cell.spec.get("epoch_interval_s")
    run_kwargs = {} if epoch is None else {"epoch_interval": timedelta(seconds=float(epoch))}
    params = cell.spec.get("flow_params", {})

    # Warm-up: this cell's flow over its first blocks, at full speed.
    warm_flow = flows.build(
        feed.source(Handed(), float("inf"), max_blocks=int(cell.spec["warmup_blocks"])),
        _sinks(cell, ref, stream), cell.cfg, params,
    )
    run_main(warm_flow, **run_kwargs)
    del warm_flow
    gc.collect()
    if on_card:
        torch.cuda.synchronize()

    # The measured window.
    handed = Handed()
    sinks = _sinks(cell, ref, stream)
    flow = flows.build(feed.source(handed, seconds), sinks, cell.cfg, params)
    kernels = cell.spec.get("card_kernels", [])
    phases0 = dict(flight.RECORDER.phase_totals)
    counters0 = dict(flight.RECORDER.counters)
    launches0 = _launches(kernels)
    undo_fault = fault() if fault is not None else None
    gcw = _GcWatch()
    cpu0 = _cpu_s()
    tracer = None
    # The device's timeline is read in every run of a cell whose
    # end-to-end metrics come from it, and in every traced run.
    traced = trace or any(m["source"] == "device_trace" for m in cell.metrics("end_to_end"))
    try:
        if traced:
            from portbench.devtrace import Tracer

            tracer = Tracer().__enter__()
        try:
            run_main(flow, **run_kwargs)
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
    finally:
        gc_info = gcw.undo()
        cpu_s = _cpu_s() - cpu0
        if undo_fault is not None:
            undo_fault()
    if on_card:
        torch.cuda.synchronize()
    last = max((s.last for s in sinks.values() if s.last is not None), default=time.perf_counter())
    window_s = last - handed.first
    setup_s = handed.first - PROCESS_START
    memory_peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    phases = {
        k: v - phases0.get(k, 0.0) for k, v in flight.RECORDER.phase_totals.items()
    }
    counters = {
        k: v - counters0.get(k, 0) for k, v in flight.RECORDER.counters.items()
        if isinstance(v, (int, float))
    }
    launches = {k: n - launches0[k] for k, n in _launches(kernels).items()}
    trace_summary = tracer.summary() if tracer is not None else None
    del flow, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    feed.close()
    why = off_card(counters, launches, on_card)
    if why:
        msg = "the window did not run on the card: " + "; ".join(why)
        raise BenchError(msg)

    # The reference, once the window has closed and the program's state
    # is freed.
    got = ref.canon({name: s.rows() for name, s in sinks.items()}, stream)
    want = ref.expect(stream, handed, cell.spec)
    verdict = ref.judge(got, want, cell.cfg["limits"])
    del got, want

    ctx = Context(cell=cell, setup_s=setup_s, window_s=window_s, rows=handed.rows)
    ctx.info.update(gc_info)
    ctx.info["cpu_s"] = cpu_s
    ctx.info["slice_rates"] = _slice_rates(handed, last)
    ctx.info["launches"] = launches
    ctx.phases, ctx.counters = phases, counters
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    if traced:
        ctx.trace = trace_summary
        if hasattr(flows, "fold_bytes"):
            ctx.fold_bytes = flows.fold_bytes(stream, handed.block, cell.spec)
        ctx.peak_bytes_per_s = roofline.peak_bytes_per_s(kind)
        ctx.info["fold_calls"] = trace_summary["fold_calls"]
        ctx.info["fold_kernels"] = trace_summary["fold_kernels"]
        ctx.info["fold_device_s"] = trace_summary["fold_s"]
        ctx.info["fold_bytes"] = ctx.fold_bytes

    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": kind,
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {
        "correct": verdict.correct,
        "attempted": verdict.attempted,
        "failed": verdict.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {
            "device_ops": trace_summary["device_ops"],
            "idle_gaps": trace_summary["idle_gaps"],
        }
    result["checks"] = {
        name: {"value": value, "limit": limit} for name, (value, limit) in verdict.checks.items()
    }
    ctx.info.update(rows=handed.rows, window_s=window_s, setup_s=setup_s, seed=seed, cell=name)
    return {"result": result, "context": ctx, "verdict": verdict}


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole (``bytewax_tpu_torch`` is not ``bytewax_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError) as ex:
        return f"not read ({type(ex).__name__})"
    return res.stdout.strip() or f"not read (exit {res.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = find_cell(ROOT, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            msg = f"the cell needs {cell.chips} CUDA card(s); torch finds {found}"
            raise BenchError(msg)
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    except BenchError as ex:
        print(f"portbench: {ex}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    result, ctx = out["result"], out["context"]
    info = dict(ctx.info, power=_power_limit())
    print(json.dumps({"portbench_info": info}))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
