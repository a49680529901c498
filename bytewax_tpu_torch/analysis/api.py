"""File discovery and the one-call analysis entry points.

Used by the CLI (``__main__``), the tier-1 wrapper test, and
``chip_smoke.py``'s first phase.
"""

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bytewax_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    Waivers,
    apply_baseline,
    apply_waivers,
    load_baseline,
)
from bytewax_tpu_torch.analysis.resolver import Project

__all__ = [
    "analyze_paths",
    "analyze_tree",
    "default_roots",
    "discover_files",
]

#: Default baseline file name, at the repo root (the JAX package's
#: analyzer keeps its own, ``ANALYSIS_BASELINE``).
BASELINE_NAME = "ANALYSIS_BASELINE_TORCH"

#: Scripts beside the package that drive it directly; scanned as
#: standalone scripts.  (``examples/`` belongs to the JAX package.)
SCRIPT_NAMES = ("chip_smoke.py",)


def default_roots() -> Tuple[Path, List[Path]]:
    """(package dir, the scripts of SCRIPT_NAMES that exist) for the
    installed tree."""
    pkg_dir = Path(__file__).resolve().parent.parent
    scripts = [pkg_dir.parent / name for name in SCRIPT_NAMES]
    return pkg_dir, [p for p in scripts if p.is_file()]


def discover_files(
    pkg_dir: Path, scripts: Optional[Sequence[Path]]
) -> List[Tuple[str, Path, bool]]:
    """(module_name, path, is_script) for the default scan set: the
    whole package as importable modules, each of ``scripts`` as a
    standalone script named by its stem."""
    files: List[Tuple[str, Path, bool]] = []
    pkg_name = pkg_dir.name
    for path in sorted(pkg_dir.rglob("*.py")):
        rel = path.relative_to(pkg_dir)
        parts = [pkg_name] + list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        files.append((".".join(parts), path, False))
    for path in scripts or ():
        files.append((path.stem, path, True))
    return files


def _load(
    files: Sequence[Tuple[str, Path, bool]], rel_root: Optional[Path]
) -> Project:
    return Project.load(files, rel_root=rel_root)


def _waiver_map(project: Project) -> Dict[str, Waivers]:
    return {
        mod.rel: Waivers.parse(mod.source)
        for mod in project.modules.values()
    }


def analyze_tree(
    rule_ids: Optional[Iterable[str]] = None,
    baseline: Optional[Path] = None,
    use_baseline: bool = True,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Diagnostic], int, Project]:
    """Analyze the installed package (+ its scripts).  Returns
    ``(diagnostics, n_baselined, project)`` after waiver and baseline
    filtering.  Pass a dict as ``timings`` to collect per-rule wall
    seconds."""
    from bytewax_tpu_torch.analysis.rules import run_rules

    pkg_dir, scripts = default_roots()
    root = pkg_dir.parent
    project = _load(discover_files(pkg_dir, scripts), root)
    diags = run_rules(project, rule_ids, timings=timings)
    diags = apply_waivers(diags, _waiver_map(project))
    suppressed = 0
    if use_baseline:
        if baseline is None:
            baseline = root / BASELINE_NAME
        diags, suppressed = apply_baseline(
            diags, load_baseline(baseline)
        )
    return diags, suppressed, project


def analyze_paths(
    paths: Sequence[Path],
    scripts: bool = False,
    rule_ids: Optional[Iterable[str]] = None,
    baseline: Optional[Path] = None,
    rel_root: Optional[Path] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Diagnostic], int, Project]:
    """Analyze an explicit file set (fixtures, one-off checks).

    Directories are globbed recursively; ``scripts=True`` marks every
    file as a standalone script (BTX-BACKEND applies).  Module names
    derive from file stems, so allowlist-gated rules treat these
    files as outside the sanctioned modules — which is the point for
    positive fixtures.
    """
    from bytewax_tpu_torch.analysis.rules import run_rules

    files: List[Tuple[str, Path, bool]] = []
    used: set = set()
    for p in paths:
        p = Path(p)
        todo = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for path in todo:
            # Module names must stay unique or same-stem files would
            # silently shadow each other in the project table.
            name, n = path.stem, 1
            while name in used:
                n += 1
                name = f"{path.stem}_{n}"
            used.add(name)
            files.append((name, path, scripts))
    project = _load(files, rel_root)
    diags = run_rules(project, rule_ids, timings=timings)
    diags = apply_waivers(diags, _waiver_map(project))
    suppressed = 0
    if baseline is not None:
        diags, suppressed = apply_baseline(
            diags, load_baseline(baseline)
        )
    return diags, suppressed, project
