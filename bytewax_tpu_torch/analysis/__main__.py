"""CLI for the engine-contract analyzer.

.. code-block:: console

    $ python -m bytewax_tpu_torch.analysis                 # package + chip_smoke.py
    $ python -m bytewax_tpu_torch.analysis --list-rules
    $ python -m bytewax_tpu_torch.analysis --rules BTX-SEND,BTX-GSYNC
    $ python -m bytewax_tpu_torch.analysis path/to/file.py # ONLY these files
    $ python -m bytewax_tpu_torch.analysis --write-baseline

Exit status: 0 clean, 1 findings, 2 usage error.
"""

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from bytewax_tpu_torch.analysis import api
from bytewax_tpu_torch.analysis.diagnostics import (
    format_diagnostics,
    sarif_report,
    write_baseline,
)
from bytewax_tpu_torch.analysis.rules import ALL_RULES

_RULE_DOC = {
    "BTX-SEND": "raw cluster sends only in engine/comm.py + engine/driver.py",
    "BTX-GSYNC": "collectives reachable only from globally-ordered points",
    "BTX-FRAMES": "control-frame kind inventory is closed",
    "BTX-FAULT": "fault sites pinned; injector silent; fire before mutate",
    "BTX-SNAPSHOT": "device-tier states implement demotion_snapshots()",
    "BTX-BACKEND": "standalone scripts choose the platform before the device tier starts",
    "BTX-DRAIN": "drain-only ops (evict/restore/flush/...) only at drain points",
    "BTX-THREAD": "the pipeline worker lane never reaches main-only state",
    "BTX-KNOB": "every BYTEWAX_TPU_* knob is cataloged + documented",
    "BTX-LANE": "every DevicePipeline lane cataloged, fenced, truthfully phased",
    "BTX-RACE": "worker/main shared attributes pinned in SHARED_STATE",
}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bytewax_tpu_torch.analysis",
        description=(
            "AST-based static analysis of the bytewax_tpu_torch engine "
            "contracts (see docs/contracts.md)"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        type=Path,
        help=(
            "analyze ONLY these files/directories instead of the "
            "installed package + chip_smoke.py"
        ),
    )
    parser.add_argument(
        "--scripts",
        action="store_true",
        help="treat the given paths as standalone scripts "
        "(BTX-BACKEND applies)",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="ID",
        help="run one rule (repeatable; merges with --rules)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    parser.add_argument(
        "--timings",
        action="store_true",
        help="report per-rule wall time on stderr (JSON line with "
        "--json)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        help=f"baseline file (default: <repo>/{api.BASELINE_NAME})",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline file",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write all current findings to the baseline and exit 0",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit diagnostics as JSON lines",
    )
    parser.add_argument(
        "--output",
        choices=("text", "sarif"),
        default="text",
        help=(
            "findings format on stdout (default: text; sarif emits "
            "one SARIF 2.1.0 document and overrides --json's "
            "per-finding lines)"
        ),
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in ALL_RULES:
            print(f"{rid}\t{_RULE_DOC.get(rid, '')}")
        return 0

    rule_ids = None
    wanted: List[str] = []
    if args.rules:
        wanted.extend(
            r.strip() for r in args.rules.split(",") if r.strip()
        )
    if args.rule:
        wanted.extend(r.strip() for r in args.rule if r.strip())
    if wanted:
        rule_ids = list(dict.fromkeys(wanted))
        unknown = [r for r in rule_ids if r not in ALL_RULES]
        if unknown:
            print(
                f"unknown rule(s) {unknown}; known: {sorted(ALL_RULES)}",
                file=sys.stderr,
            )
            return 2

    timings = {} if args.timings else None
    if args.paths:
        diags, suppressed, _project = api.analyze_paths(
            args.paths,
            scripts=args.scripts,
            rule_ids=rule_ids,
            # Regenerating a baseline must see ALL findings, or the
            # old baseline would filter them out of the new one.
            baseline=None
            if (args.no_baseline or args.write_baseline)
            else args.baseline,
            timings=timings,
        )
        baseline_path = args.baseline
    else:
        baseline_path = args.baseline
        if baseline_path is None:
            baseline_path = (
                api.default_roots()[0].parent / api.BASELINE_NAME
            )
        diags, suppressed, _project = api.analyze_tree(
            rule_ids=rule_ids,
            baseline=baseline_path,
            use_baseline=not (args.no_baseline or args.write_baseline),
            timings=timings,
        )

    # Timings report before any early return, so --timings composes
    # with --write-baseline.
    if timings is not None:
        if args.json:
            print(
                json.dumps({"timings_s": {
                    k: round(v, 4) for k, v in sorted(timings.items())
                }}),
                file=sys.stderr,
            )
        else:
            for rid, secs in sorted(timings.items()):
                print(f"{rid}\t{secs * 1e3:.1f} ms", file=sys.stderr)

    ran_rules = rule_ids if rule_ids else list(ALL_RULES)

    if args.write_baseline:
        if baseline_path is None:
            print(
                "--write-baseline with explicit paths needs "
                "--baseline FILE",
                file=sys.stderr,
            )
            return 2
        write_baseline(baseline_path, diags)
        if args.output == "sarif":
            # Baselining and reporting compose: CI can snapshot the
            # findings it is about to accept.
            print(json.dumps(sarif_report(diags, {
                rid: _RULE_DOC.get(rid, "") for rid in ran_rules
            })))
        print(
            f"wrote {len(diags)} finding(s) to {baseline_path}",
            file=sys.stderr,
        )
        return 0

    if args.output == "sarif":
        print(json.dumps(sarif_report(diags, {
            rid: _RULE_DOC.get(rid, "") for rid in ran_rules
        })))
    elif args.json:
        for d in diags:
            print(
                json.dumps(
                    {
                        "rule": d.rule,
                        "path": d.path,
                        "line": d.lineno,
                        "message": d.message,
                    }
                )
            )
    elif diags:
        print(format_diagnostics(diags))
    n_rules = len(rule_ids) if rule_ids else len(ALL_RULES)
    status = "clean" if not diags else f"{len(diags)} finding(s)"
    tail = f" ({suppressed} baselined)" if suppressed else ""
    print(
        f"bytewax_tpu_torch.analysis: {n_rules} rule(s), {status}{tail}",
        file=sys.stderr,
    )
    return 1 if diags else 0


if __name__ == "__main__":
    sys.exit(main())
