"""Tiny sizes of every cell, for runs on the CPU: the same files and
code paths, fewer stations and shorter batches."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "brc-10k.columnar": {"cfg": {"stations": 40}, "traffic": {"batch_rows": 2048, "ring": 4}},
    "brc-10k.text": {"cfg": {"stations": 40}, "traffic": {"batch_rows": 1024, "ring": 4, "chunk_bytes": 8192}},
}

#: Seconds of a tiny run's window.
SECONDS = 0.6


def overrides(cell: str) -> dict:
    """A fresh copy of ``cell``'s tiny overrides."""
    return {part: dict(values) for part, values in TINY[cell].items()}
