"""Structured diagnostics, inline waivers, and the baseline file.

A rule emits :class:`Diagnostic` records; the runner filters them
through two sanctioned escape hatches:

- **Inline waivers** — a ``# bytewax: allow[RULE-ID]`` comment on the
  flagged line (or the line directly above it) suppresses that rule
  there.  Multiple ids separate with commas:
  ``# bytewax: allow[BTX-SEND,BTX-FRAMES]``.  Waivers are parsed from
  real COMMENT tokens (via :mod:`tokenize`), so a ``#`` inside a
  string literal can neither create nor hide one — the failure mode
  of the line-split comment stripping this analyzer replaced.

- **Baseline file** — known findings committed to the repo
  (``ANALYSIS_BASELINE_TORCH``).  Entries are line-number-free
  (``rule-id<TAB>path<TAB>message``) so unrelated edits above a
  finding don't churn the file.  Regenerate with
  ``python -m bytewax_tpu_torch.analysis --write-baseline``.
"""

import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "Diagnostic",
    "Waivers",
    "format_diagnostics",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "sarif_report",
]

WAIVER_MARK = "bytewax:"
WAIVER_VERB = "allow["


@dataclass(frozen=True)
class Diagnostic:
    """One rule finding, renderable as ``file:line rule-id message``."""

    rule: str
    path: str  # as scanned (repo-relative when possible)
    lineno: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.lineno} {self.rule} {self.message}"

    def baseline_key(self) -> str:
        return f"{self.rule}\t{self.path}\t{self.message}"

    def sort_key(self) -> Tuple[str, int, str]:
        return (self.path, self.lineno, self.rule)


@dataclass
class Waivers:
    """Per-file map of line -> waived rule ids."""

    by_line: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, source: str) -> "Waivers":
        out = cls()
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(source).readline
            )
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                ids = _waiver_ids(tok.string)
                if ids:
                    out.by_line.setdefault(tok.start[0], set()).update(
                        ids
                    )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # Unparseable comments: no waivers rather than a crash —
            # the analyzer already requires the file to parse as AST.
            pass
        return out

    def waives(self, lineno: int, rule: str) -> bool:
        for line in (lineno, lineno - 1):
            if rule in self.by_line.get(line, ()):
                return True
        return False


def _waiver_ids(comment: str) -> List[str]:
    """``# bytewax: allow[BTX-A,BTX-B]`` -> ["BTX-A", "BTX-B"]."""
    body = comment.lstrip("#").strip()
    if not body.startswith(WAIVER_MARK):
        return []
    body = body[len(WAIVER_MARK) :].strip()
    if not body.startswith(WAIVER_VERB):
        return []
    body = body[len(WAIVER_VERB) :]
    end = body.find("]")
    if end < 0:
        return []
    return [
        part.strip()
        for part in body[:end].split(",")
        if part.strip()
    ]


def apply_waivers(
    diags: Iterable[Diagnostic],
    waivers_by_path: Dict[str, Waivers],
) -> List[Diagnostic]:
    out = []
    for d in diags:
        w = waivers_by_path.get(d.path)
        if w is not None and w.waives(d.lineno, d.rule):
            continue
        out.append(d)
    return out


# -- baseline ---------------------------------------------------------------

_BASELINE_HEADER = """\
# bytewax_tpu_torch static-contract baseline (see docs/contracts.md).
#
# Each entry suppresses one known finding:
#     rule-id<TAB>path<TAB>message
# Entries carry no line numbers, so edits elsewhere in a file do not
# churn this file.  Regenerate with:
#     python -m bytewax_tpu_torch.analysis --write-baseline
# An empty baseline means the tree is expected to be clean.
"""


def load_baseline(path: Optional[Path]) -> Set[str]:
    if path is None or not Path(path).exists():
        return set()
    out: Set[str] = set()
    for line in Path(path).read_text().splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        out.add(line.rstrip("\n"))
    return out


def write_baseline(path: Path, diags: Iterable[Diagnostic]) -> None:
    keys = sorted({d.baseline_key() for d in diags})
    body = _BASELINE_HEADER + "".join(k + "\n" for k in keys)
    Path(path).write_text(body)


def apply_baseline(
    diags: Iterable[Diagnostic], baseline: Set[str]
) -> Tuple[List[Diagnostic], int]:
    """Filter baselined findings; returns (remaining, n_suppressed)."""
    remaining, suppressed = [], 0
    for d in diags:
        if d.baseline_key() in baseline:
            suppressed += 1
        else:
            remaining.append(d)
    return remaining, suppressed


def format_diagnostics(diags: Iterable[Diagnostic]) -> str:
    return "\n".join(
        d.render() for d in sorted(diags, key=Diagnostic.sort_key)
    )


def sarif_report(
    diags: Iterable[Diagnostic],
    rule_docs: Dict[str, str],
) -> dict:
    """Findings as a SARIF 2.1.0 document (one run, one result per
    finding).  ``rule_docs`` maps every rule id that RAN — not just
    those that fired — to its one-line description, so a clean run
    still advertises its rule inventory to SARIF consumers."""
    results = [
        {
            "ruleId": d.rule,
            "level": "error",
            "message": {"text": d.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": d.path},
                        "region": {"startLine": max(1, d.lineno)},
                    }
                }
            ],
        }
        for d in sorted(diags, key=Diagnostic.sort_key)
    ]
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "bytewax_tpu_torch.analysis",
                        "informationUri": "docs/contracts.md",
                        "rules": [
                            {
                                "id": rid,
                                "shortDescription": {"text": doc},
                            }
                            for rid, doc in sorted(rule_docs.items())
                        ],
                    }
                },
                "results": results,
            }
        ],
    }
