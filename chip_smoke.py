#!/usr/bin/env python3
"""Drive the torch port (``bytewax_tpu_torch``) on one CUDA card and
check it.

Phases, each of which raises on any failure:

1. build  — compile every kernel of the main path from the sources in
   this checkout (``nvcc``, ``sm_90a``);
2. kernel — hold the segment-fold kernel against its plain PyTorch
   version on the card: every aggregation kind, float32 and int32,
   all three row sources, 2^20 rows, capacity 1024 and 16384; time
   both at the main path's shapes;
3. main   — the 1BRC keyed aggregation (``brc_flow_columnar``) through
   ``run_main`` at 32·2^20 rows in 2^20-row micro-batches, over 413
   and over 10,000 stations, checked against a float64 numpy
   reference and against the kernel's launch count;
4. items  — the itemized paths (``brc_flow`` over Python tuples,
   ``count_final`` over strings), float32 and int32 state;
5. report — one ``{"kernels": [...]}`` line.

Every result line is JSON and carries the card's name and power
limit.  The last line is ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: Where every tensor of the run lives.
DEV = "cuda"
#: Phase 3: the 1BRC run's rows and micro-batch rows.
ROWS = 32 << 20
BATCH_ROWS = 1 << 20
#: Rows per kernel check in phase 2, and itemized rows in phase 4.
KERNEL_ROWS = 1 << 20
ITEM_ROWS = 1 << 20
#: The card's memory rate (H100 SXM data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (H100 SXM data sheet).
F32_OPS_PER_S = 67e12


def _card() -> dict:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    name, _, limit = out.partition(",")
    return {"line": out, "name": name.strip(), "power_limit": limit.strip()}


def _emit(card: dict, phase: str, **fields) -> None:
    rec = {"phase": phase, "card": card["name"], "power_limit": card["power_limit"]}
    rec.update(fields)
    print(json.dumps(rec), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2 -----------------------------------------------------------------


def _inputs(capacity: int, dtype, n: int, gen):
    """Random rows for every source: slots over the whole table (the
    scratch slot included), an id->slot table that sends some ids to
    scratch, and values with both signs."""
    import torch

    dev = DEV
    n_map = min(capacity, 30000)
    ext_to_slot = torch.randint(
        0, capacity, (n_map,), generator=gen, device=dev, dtype=torch.int32
    )
    ext_to_slot[-1] = capacity - 1
    slots = torch.randint(0, capacity, (n,), generator=gen, device=dev, dtype=torch.int32)
    ext = torch.randint(0, n_map, (n,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randint(-999, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    packed = torch.stack([ext, q]).to(torch.int16).contiguous()
    if dtype == torch.float32:
        vals = torch.randn(n, generator=gen, device=dev) * 50.0
    else:
        vals = torch.randint(-1000, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    return {
        "slots": slots,
        "ext16": ext.to(torch.int16),
        "ext32": ext,
        "packed": packed,
        "vals": vals,
        "ext_to_slot": ext_to_slot,
    }


def _fold(seg, which: str, kind, state, inp, scale: float, plain: bool):
    """One fold through the kernel (``plain=False``) or the plain
    version, for row source ``which``."""
    if which == "slot":
        slots, vals = inp["slots"], inp["vals"]
    elif which in ("ext16", "ext32"):
        if not plain:
            return seg.update_fields_vocab(
                kind, state, inp["ext_to_slot"], inp[which], inp["vals"]
            )
        slots, vals = seg.slots_of(inp["ext_to_slot"], inp[which]), inp["vals"]
    else:
        if not plain:
            return seg.update_fields_packed(
                kind, state, inp["ext_to_slot"], inp["packed"], scale
            )
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0])
        vals = seg.dequantize(inp["packed"], scale)
    if plain:
        return seg.fold_plain(kind, state, slots, vals)
    return seg.update_fields(kind, state, slots, vals)


def _rows_of(seg, which, inp, scale, capacity, dtype):
    """The (slot, value) rows a source folds, as the plain version
    sees them, with the scratch rows masked out."""
    import torch

    if which == "slot":
        slots, vals = inp["slots"].long(), inp["vals"]
    elif which in ("ext16", "ext32"):
        slots, vals = seg.slots_of(inp["ext_to_slot"], inp[which]).long(), inp["vals"]
    else:
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0]).long()
        vals = seg.dequantize(inp["packed"], scale)
    vals = vals.to(dtype)
    valid = (slots >= 0) & (slots < capacity - 1)
    return slots[valid], vals[valid]


def phase_kernel(card: dict, n: int) -> dict:
    import torch

    from bytewax_tpu_torch.ops import fold_kernel
    from bytewax_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    scale = 0.1
    worst_ratio = 0.0
    worst_abs = 0.0
    checked = 0
    for capacity in (1024, 16384):
        for dtype in (torch.float32, torch.int32):
            inp = _inputs(capacity, dtype, n, gen)
            for which in ("slot", "ext16", "ext32", "packed"):
                slots, vals = _rows_of(seg, which, inp, scale, capacity, dtype)
                n_k = torch.zeros(capacity, dtype=torch.float64, device=DEV)
                n_k.index_add_(0, slots, torch.ones_like(slots, dtype=torch.float64))
                abs_k = torch.zeros(capacity, dtype=torch.float64, device=DEV)
                abs_k.index_add_(0, slots, vals.double().abs())
                for kind_name, kind in seg.AGG_KINDS.items():
                    base = seg.init_fields(kind, capacity, dtype, DEV)
                    # Start from a table that already holds state: fold
                    # the slot rows once with the plain version.
                    seg.fold_plain(kind, base, inp["slots"], inp["vals"])
                    got = {k: v.clone() for k, v in base.items()}
                    want = {k: v.clone() for k, v in base.items()}
                    _fold(seg, which, kind, got, inp, scale, plain=False)
                    _fold(seg, which, kind, want, inp, scale, plain=True)
                    torch.cuda.synchronize()
                    for name, (_init, op_name) in kind.fields.items():
                        g, w = got[name], want[name]
                        tag = f"{kind_name}/{name}/{which}/{dtype}/cap{capacity}"
                        if op_name != "add" or name == "count" or dtype == torch.int32:
                            if not torch.equal(g, w):
                                bad = int((g != w).sum())
                                msg = f"kernel != plain at {bad} slots: {tag}"
                                raise AssertionError(msg)
                            continue
                        # Two summation orders of n_k terms (plus the
                        # state's own value) differ by at most
                        # 2·n·2^-24·Σ|x| per slot.
                        base_abs = base[name].double().abs()
                        bound = 2.0 * (n_k + 1) * 2.0**-24 * (abs_k + base_abs)
                        diff = (g.double() - w.double()).abs()
                        worst_abs = max(worst_abs, float(diff.max()))
                        if bool((diff > bound).any()):
                            msg = f"float sum outside the two-order bound: {tag}"
                            raise AssertionError(msg)
                        nz = bound > 0
                        if bool(nz.any()):
                            worst_ratio = max(
                                worst_ratio, float((diff[nz] / bound[nz]).max())
                            )
                    checked += 1
    _emit(
        card,
        "kernel",
        checked_cases=checked,
        rows=n,
        max_abs_err=worst_abs,
        max_sum_err_over_bound=worst_ratio,
        launches_while_checking=fold_kernel.launches,
    )
    return {"max_abs_err": worst_abs, "max_sum_err_over_bound": worst_ratio}


def _time_main_shapes(card: dict, n: int, capacity: int, n_stations: int) -> dict:
    """Kernel, plain version and library call at the 1BRC main path's
    shapes: stats over packed rows, float32, one 2^20-row batch."""
    import torch

    from bytewax_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    kind = seg.AGG_KINDS["stats"]
    scale = 0.1
    n_map = n_stations + 1
    ext_to_slot = torch.arange(n_map, dtype=torch.int32, device=DEV)
    ext_to_slot[-1] = capacity - 1
    ids = torch.randint(0, n_stations, (n,), generator=gen, device=DEV, dtype=torch.int32)
    q = torch.randint(-999, 1000, (n,), generator=gen, device=DEV, dtype=torch.int32)
    packed = torch.stack([ids, q]).to(torch.int16).contiguous()
    state = seg.init_fields(kind, capacity, torch.float32, DEV)
    reps = 50
    ms = _time_ms(
        lambda: seg.update_fields_packed(kind, state, ext_to_slot, packed, scale), reps
    )
    plain_ms = _time_ms(
        lambda: seg.fold_plain(
            kind,
            state,
            seg.slots_of(ext_to_slot, packed[0]),
            seg.dequantize(packed, scale),
        ),
        reps,
    )
    # Yardstick only (the port never calls it on the card):
    # scatter_reduce_ per field over the already gathered and
    # dequantized rows.
    slots = seg.slots_of(ext_to_slot, packed[0]).long()
    vals = seg.dequantize(packed, scale)
    ones = torch.ones_like(vals)
    reduce_of = {"min": "amin", "max": "amax", "sum": "sum", "count": "sum"}

    def library():
        for name, arr in state.items():
            src = ones if name == "count" else vals
            arr.scatter_reduce_(0, slots, src, reduce_of[name], include_self=True)

    library_ms = _time_ms(library, reps)
    n_fields = len(kind.fields)
    bytes_moved = 4 * n + 4 * n_map + 2 * 4 * n_fields * capacity
    ops = (1 + n_fields) * n  # one dequant multiply, one combine per field
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    res = {
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes"
        if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations",
    }
    _emit(card, "kernel_time", rows=n, capacity=capacity, stations=n_stations, **res)
    return res


# -- phase 3 -----------------------------------------------------------------


def _reference(batches, n_stations: int):
    """Per-station min/max/sum/count in exact integer deci-degrees,
    from the same batches."""
    import numpy as np

    span = 1999  # deci-degrees -999..999
    hist = np.zeros(n_stations * span, dtype=np.int64)
    total = np.zeros(n_stations, dtype=np.int64)
    for b in batches:
        ids = b.numpy("key_id").astype(np.int64)
        q = b.numpy("value").astype(np.int64)
        hist += np.bincount(ids * span + (q + 999), minlength=hist.size)
        total += np.bincount(ids, weights=q, minlength=n_stations).astype(np.int64)
    hist = hist.reshape(n_stations, span)
    count = hist.sum(axis=1)
    seen = hist > 0
    mn = seen.argmax(axis=1) - 999
    mx = span - 1 - seen[:, ::-1].argmax(axis=1) - 999
    vocab = batches[0].key_vocab
    return {
        str(vocab[i]): (mn[i] * 0.1, total[i] * 0.1 / count[i], mx[i] * 0.1)
        for i in range(n_stations)
        if count[i]
    }


def _demotions() -> float:
    from bytewax_tpu_torch._metrics import step_demotion_count

    return sum(
        s.value
        for m in step_demotion_count.collect()
        for s in m.samples
        if s.name.endswith("_total")
    )


def phase_main(card: dict, rows: int, batch_rows: int, n_stations: int, times: dict):
    import torch

    import bytewax_tpu_torch.engine.sharded_state as sharded_state
    from bytewax_tpu_torch.engine import flight
    from bytewax_tpu_torch.models.brc import (
        ArrayBatchSource,
        brc_flow_columnar,
        generate_batches,
    )
    from bytewax_tpu_torch.ops import fold_kernel
    from bytewax_tpu_torch.testing import TestingSink, run_main

    batches = generate_batches(rows, batch_rows, n_stations, seed=0)
    want = _reference(batches, n_stations)
    states = []
    make = sharded_state.make_agg_state

    def recording_make(kind, driver=None):
        state = make(kind, driver=driver)
        states.append(state)
        return state

    sharded_state.make_agg_state = recording_make
    out = []
    demoted_before = _demotions()
    phases_before = dict(flight.RECORDER.phase_totals)
    try:
        flow = brc_flow_columnar(ArrayBatchSource(batches), TestingSink(out))
        torch.cuda.synchronize()
        fold_kernel.launches = 0
        t0 = time.perf_counter()
        run_main(flow)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fold_kernel.launches
    finally:
        sharded_state.make_agg_state = make
    # The engine's epoch ledger: seconds per phase over this run
    # ("device" is the pipeline worker's fold phase, host-timed; it
    # overlaps the main thread's phases).
    phases = {
        name: total - phases_before.get(name, 0.0)
        for name, total in flight.RECORDER.phase_totals.items()
    }
    got = dict(out)
    if set(got) != set(want):
        msg = f"stations differ: {len(got)} out, {len(want)} expected"
        raise AssertionError(msg)
    worst_mean = 0.0
    for station, (mn, mean, mx) in want.items():
        gmn, gmean, gmx = got[station]
        if gmn != round(mn, 1) or gmx != round(mx, 1):
            msg = f"{station}: min/max {gmn}/{gmx} != {round(mn, 1)}/{round(mx, 1)}"
            raise AssertionError(msg)
        worst_mean = max(worst_mean, abs(gmean - mean))
    if worst_mean > 0.1:
        msg = f"rounded mean off by {worst_mean}"
        raise AssertionError(msg)
    if launches < len(batches):
        msg = f"{launches} kernel launches for {len(batches)} batches"
        raise AssertionError(msg)
    demoted = _demotions() - demoted_before
    if demoted:
        msg = f"{demoted} steps demoted to the host tier"
        raise AssertionError(msg)
    if len(states) != 1 or states[0].device.type != DEV:
        msg = f"device state not on cuda: {[s.device for s in states]}"
        raise AssertionError(msg)
    _emit(
        card,
        "main",
        flow="brc_flow_columnar",
        rows=rows,
        batch_rows=batch_rows,
        stations=n_stations,
        table_capacity=states[0].capacity,
        seconds=seconds,
        rows_per_s=rows / seconds,
        kernel_launches=launches,
        kernel_ms_per_launch=times["ms"],
        plain_ms=times["plain_ms"],
        library_ms=times["library_ms"],
        bound_ms=times["bound_ms"],
        max_abs_mean_err=worst_mean,
        step_demotions=demoted,
        phase_seconds=phases,
        # Kernel time over wall time, from the two measured numbers
        # (host→device copies not included).
        kernel_busy_share=launches * times["ms"] * 1e-3 / seconds,
    )
    return launches


# -- phase 4 -----------------------------------------------------------------


def phase_items(card: dict, n: int) -> int:
    import numpy as np

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.models.brc import ArrayBatchSource, brc_flow
    from bytewax_tpu_torch.ops import fold_kernel
    from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main

    rng = np.random.RandomState(2)
    ids = rng.randint(0, 413, size=n)
    q = rng.randint(-999, 1000, size=n).astype(np.int16)
    vocab = np.array([f"station_{i:04d}" for i in range(413)])
    items = [(vocab[i], v * 0.1) for i, v in zip(ids.tolist(), q.tolist())]
    chunk = 1 << 16
    batches = [items[i : i + chunk] for i in range(0, n, chunk)]
    out = []
    fold_kernel.launches = 0
    run_main(brc_flow(ArrayBatchSource(batches), TestingSink(out)))
    f32_launches = fold_kernel.launches
    want = _reference(
        [ArrayBatch({"key_id": ids, "value": q}, key_vocab=vocab, value_scale=0.1)],
        len(vocab),
    )
    got = dict(out)
    if set(got) != set(want) or f32_launches == 0:
        msg = f"itemized brc: {len(got)} stations, {f32_launches} launches"
        raise AssertionError(msg)
    for station, (mn, mean, mx) in want.items():
        gmn, gmean, gmx = got[station]
        if (gmn, gmx) != (round(mn, 1), round(mx, 1)) or abs(gmean - mean) > 0.1:
            msg = f"itemized stats wrong for {station}: {got[station]}"
            raise AssertionError(msg)

    words = [f"w{i % 997}" for i in range(n // 4)]
    out = []
    flow = Dataflow("count")
    s = op.input("inp", flow, TestingSource(words, batch_size=4096))
    s = op.count_final("count", s, lambda w: w)
    op.output("out", s, TestingSink(out))
    fold_kernel.launches = 0
    run_main(flow)
    i32_launches = fold_kernel.launches
    want = {}
    for w in words:
        want[w] = want.get(w, 0) + 1
    if dict(out) != want or i32_launches == 0:
        msg = f"count_final wrong or not on the kernel ({i32_launches} launches)"
        raise AssertionError(msg)
    _emit(
        card,
        "items",
        brc_items=n,
        brc_launches=f32_launches,
        count_items=len(words),
        count_launches=i32_launches,
    )
    return f32_launches + i32_launches


def main() -> int:
    if not (HERE / "bytewax_tpu_torch" / "csrc" / "segment_fold.cu").exists():
        print(
            "chip_smoke.py must run from a checkout of the repository "
            "(bytewax_tpu_torch/ not found beside it)",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch finds none", file=sys.stderr)
        return 1
    os.environ.pop("BYTEWAX_TPU_PLATFORM", None)  # the card, never the CPU
    card = _card()

    from bytewax_tpu_torch.ops import fold_kernel

    t0 = time.perf_counter()
    fold_kernel.build()
    ptxas = [ln for ln in fold_kernel.build_log.splitlines() if "registers" in ln]
    _emit(card, "build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    check = phase_kernel(card, KERNEL_ROWS)
    main_launches = {}
    for n_stations, capacity in ((413, 1024), (10_000, 16384)):
        times = _time_main_shapes(card, BATCH_ROWS, capacity, n_stations)
        main_launches[n_stations] = (
            phase_main(card, ROWS, BATCH_ROWS, n_stations, times),
            times,
        )
    phase_items(card, ITEM_ROWS)

    launches, times = main_launches[413]
    print(card["line"])
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "segment_fold",
                        "route": "cuda",
                        "source": "bytewax_tpu_torch/csrc/segment_fold.cu",
                        "replaces": "bytewax_tpu/ops/pallas_fold.py:45",
                        "launches": launches,
                        "max_abs_err": check["max_abs_err"],
                        "ms": times["ms"],
                        "plain_ms": times["plain_ms"],
                        "bound_ms": times["bound_ms"],
                        "bound_by": times["bound_by"],
                        "library_ms": times["library_ms"],
                    }
                ]
            }
        )
    )
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
