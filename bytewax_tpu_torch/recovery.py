"""Failure recovery.

Snapshots of all operator/partition state are taken at every epoch
boundary and written into a fixed number of SQLite *recovery
partitions*; on resume the engine computes the epoch to roll back to
and rebuilds all state from the latest consistent snapshots.  The
partition count is independent of the worker/chip count, which is what
makes rescaling possible: resuming at a *different* worker count is an
explicit opt-in (``--rescale`` / ``BYTEWAX_TPU_RESCALE=1``) that
re-shards every keyed snapshot row to the new routing at run startup;
without it, a mismatched resume raises
:class:`WorkerCountMismatchError` (see ``docs/recovery.md``).

Store layout parity with the reference (upstream bytewax ``src/recovery.rs``):
``part-{i}.sqlite3`` files, snapshots keyed by ``(step_id, state_key,
epoch)``, per-execution frontier rows, and a delayed commit (GC)
watermark controlled by ``backup_interval``.

Usage: create the fixed partition set once with :func:`init_db_dir`
(or ``python -m bytewax_tpu_torch.recovery``), then pass a
:class:`RecoveryConfig` to the entry point.
"""

import argparse
from datetime import timedelta
from pathlib import Path
from typing import Optional, Union

from bytewax_tpu_torch.engine.recovery_store import (
    InconsistentPartitionsError,
    MissingPartitionsError,
    NoPartitionsError,
    WorkerCountMismatchError,
    init_db_dir,
)

__all__ = [
    "InconsistentPartitionsError",
    "MissingPartitionsError",
    "NoPartitionsError",
    "RecoveryConfig",
    "WorkerCountMismatchError",
    "init_db_dir",
]


class RecoveryConfig:
    """Configuration settings for recovery.

    :arg db_dir: Local directory holding recovery partitions,
        pre-created via :func:`init_db_dir`.

    :arg backup_interval: Amount of system time to wait to permanently
        delete a state snapshot after it is no longer needed.  Set to
        how long it takes you to copy the partition files off-machine.
        Defaults to zero.

    >>> import tempfile
    >>> from bytewax_tpu_torch.recovery import RecoveryConfig, init_db_dir
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     init_db_dir(td, 1)
    ...     flow = Dataflow("recovery_eg")
    ...     s = op.input("inp", flow, TestingSource([1, 2]))
    ...     out = []
    ...     op.output("out", s, TestingSink(out))
    ...     run_main(flow, recovery_config=RecoveryConfig(td))
    >>> out
    [1, 2]
    """

    def __init__(
        self,
        db_dir: Union[str, Path],
        backup_interval: Optional[timedelta] = None,
    ):
        self.db_dir = Path(db_dir)
        self.backup_interval = (
            backup_interval if backup_interval is not None else timedelta(0)
        )

    def __repr__(self) -> str:
        return (
            f"RecoveryConfig({str(self.db_dir)!r}, "
            f"backup_interval={self.backup_interval!r})"
        )


def _main() -> None:
    parser = argparse.ArgumentParser(
        prog="python -m bytewax_tpu_torch.recovery",
        description="Create a new set of empty recovery partitions.",
    )
    parser.add_argument("db_dir", type=Path, help="Directory to create partitions in")
    parser.add_argument("part_count", type=int, help="Number of partitions")
    args = parser.parse_args()
    init_db_dir(args.db_dir, args.part_count)


if __name__ == "__main__":
    _main()
