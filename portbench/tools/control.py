"""Read the control: the plain reference put in the program's place,
computed in the lower precision that the reference names for its
configuration (``lower_precision(cfg)``), over as many blocks of a
cell's traffic as a run hands over, and judged by the run's own
comparison (the reference's ``judge``).  It has to come out not correct: that shows the comparison
can fail.

    python3 -m portbench.tools.control --cell brc-10k.columnar \\
        --blocks 2700 --seeds 1,2,3 --device cuda

Prints one JSON line a seed with each compared number beside its
limit.
"""

import argparse
import json
import sys


class Blocks:
    """A hand-over log of blocks ``0 .. n - 1``, as a closed-loop feed
    that kept pulling would leave."""

    def __init__(self, n: int):
        self.block = list(range(n))


def read(cell_name: str, seed: int, n_blocks: int, device: str, dtype_name=None,
         overrides=None, root=None) -> dict:
    import torch

    from portbench import run

    cell = run.find_cell(root or run.ROOT, cell_name, overrides)
    ref = cell.reference("lowp", "lower_precision")
    stream = cell.generator()(cell.cfg, cell.traffic, seed)
    dtype_name = dtype_name or ref.lower_precision(cell.cfg)
    handed = Blocks(n_blocks)
    want = ref.expect(stream, handed, cell.spec)
    got = ref.lowp(stream, handed, cell.spec, getattr(torch, dtype_name), device)
    verdict = ref.judge(got, want, cell.cfg["limits"])
    return {
        "cell": cell_name, "seed": seed, "blocks": n_blocks, "dtype": dtype_name, "device": device,
        "correct": verdict.correct, "attempted": verdict.attempted, "failed": verdict.failed,
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in verdict.checks.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, help="default: the reference's lower_precision(cfg)")
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(read(args.cell, seed, args.blocks, args.device, args.dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
