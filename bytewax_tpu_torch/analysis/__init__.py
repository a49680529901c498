"""AST-based static analysis of the engine contracts.

The invariants the engine's correctness rests on — all data sends
ride ``ship_deliver``/``ship_route``, collectives and ``global_sync``
run only at globally-ordered points, fault sites fire before device
state mutates, device-tier state stays snapshot-interchangeable with
the host tier — cannot be fully exercised dynamically.  This package
*proves* them over the package's AST instead of grepping for them:
a module/attribute resolver and intra-package call graph
(:mod:`~bytewax_tpu_torch.analysis.resolver`) let the rules see through
aliases, ``from``-imports, and method receivers.

Run it:

.. code-block:: console

    $ python -m bytewax_tpu_torch.analysis            # whole package + chip_smoke.py
    $ python -m bytewax_tpu_torch.analysis --list-rules

Diagnostics print as ``file:line rule-id message``; exit status is
nonzero when any unsuppressed finding remains.  Escape hatches:
inline ``# bytewax: allow[RULE-ID]`` waivers and the committed
``ANALYSIS_BASELINE_TORCH`` file (see docs/contracts.md).

The same checks run inside tier-1 via
``tests/test_torch_static_contracts.py``.  Everything here is pure AST —
importing or running the analyzer imports neither torch nor jax nor
any engine module, so it runs anywhere, with or without a card.
"""

from bytewax_tpu_torch.analysis.api import (
    analyze_paths,
    analyze_tree,
    default_roots,
    discover_files,
)
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.rules import ALL_RULES, run_rules

__all__ = [
    "ALL_RULES",
    "Diagnostic",
    "analyze_paths",
    "analyze_tree",
    "default_roots",
    "discover_files",
    "run_rules",
]
