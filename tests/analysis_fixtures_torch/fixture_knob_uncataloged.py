"""BTX-KNOB positive fixture: an uncataloged knob read plus a
computed knob name.

``BYTEWAX_TPU_TURBO`` exists nowhere in ``contracts.KNOBS`` — a knob
shipped without inventory or docs.  The f-string read can never be
matched against the catalog at all, so it is flagged as a computed
knob name regardless of what it expands to.
"""

import os


def turbo_enabled() -> bool:
    return os.environ.get("BYTEWAX_TPU_TURBO", "0") == "1"


def shard_override(n: int) -> str:
    return os.environ.get(f"BYTEWAX_TPU_SHARD_{n}", "")


def subscript_read() -> str:
    # Subscript loads are reads too.
    return os.environ["BYTEWAX_TPU_SECRET_MODE"]


_KNOB = "BYTEWAX_TPU_STEALTH_MODE"


def indirect_read() -> str:
    # One level of variable indirection cannot slip the catalog.
    return os.environ.get(_KNOB, "0")
