"""Run cells of the benchmark several times, one process after
another, and keep every result line.

    python3 -m portbench.tools.runs --out chiprun_out/runs.jsonl \\
        --seconds 20 --trace 0 --seeds 101,102,103 brc-10k.columnar ...

Each run is ``python3 -m portbench.run`` in a child process (one
process on the card at a time).  Every run's result, its info line and
the end of its standard error go to ``--out`` as one JSON line; a
summary with each metric's median and quartile spread (Python's
``statistics.quantiles(values, n=4)``, as a share of the median) goes
to standard output.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one_run(cell: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = res.returncode, res.stdout, res.stderr
    except subprocess.TimeoutExpired as ex:
        rc, out, err = 124, ex.stdout or "", ex.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    result = info = None
    for ln in lines:
        obj = json.loads(ln)
        if "portbench_info" in obj:
            info = obj["portbench_info"]
        elif "correct" in obj:
            result = obj
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result, "info": info,
            "stderr_tail": err[-3000:]}


def spread(values) -> float:
    """Distance between the first and third quartile over the median."""
    if len(values) < 2:
        return float("nan")
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--timeout", type=float, default=360)
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for cell in args.cells:
        got = {}
        for seed in seeds:
            rec = one_run(cell, seed, args.seconds, args.trace, args.timeout)
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            r = rec["result"]
            if r is None:
                print(json.dumps({"cell": cell, "seed": seed, "rc": rec["rc"],
                                  "stderr": rec["stderr_tail"][-1500:]}), flush=True)
                continue
            for name, m in r["metrics"].items():
                got.setdefault(name, []).append(m["value"])
            print(json.dumps({"cell": cell, "seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 2),
                              "correct": r["correct"],
                              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                              "checks": {k: v["value"] for k, v in r["checks"].items()},
                              "device": r["device"], "info": rec["info"]}), flush=True)
        summary = {name: {"median": statistics.median(v), "spread": spread(v), "n": len(v)}
                   for name, v in got.items()}
        print(json.dumps({"cell": cell, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
