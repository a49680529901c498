"""Process-local dead-letter queue for poison records.

A connector with ``on_error="dlq"`` captures records it cannot
decode/consume (an undecodable line, a poison CSV row, a Kafka error
frame) instead of killing the run: the partition buffers them and the
driver drains ``drain_dead_letters()`` at every poll, stamping each
record with provenance (step id, partition, current epoch).  Records
land in one JSONL file per process under ``BYTEWAX_TPU_DLQ_DIR``
(``dlq-p<proc>.jsonl``); without the env var they are still counted
and ring-recorded, just not persisted.

Exactly-once pairing with the recovery snapshots
(docs/recovery.md "Connector-edge resilience"): records captured
while epoch E was open are appended (and fsynced) at E's close,
*before* the epoch's snapshot commit — the same epoch whose source
snapshots cover the consumed offsets.  On resume the driver truncates
the file back to the resume epoch, so records from an aborted or
replayed epoch are dropped and recaptured by the replay: a
dead-lettered row is never lost and never duplicated, exactly like
sink output under the truncating-sink contract.
"""

import json
import os
import time
from typing import Any, Dict, List, Optional

from bytewax_tpu_torch.engine import flight as _flight

__all__ = ["DeadLetterQueue"]

#: Longest ``repr`` of a poison payload kept per record; dead letters
#: are forensic breadcrumbs, not a data lake.
_PAYLOAD_CAP = 4096


class DeadLetterQueue:
    """Epoch-buffered dead-letter writer for one process.

    ``capture()`` buffers records with provenance; ``flush()``
    appends the buffer to this process's JSONL file at epoch close
    (fsynced, before the snapshot commit); ``truncate_for_resume()``
    drops rows of epochs at or past the resume point so replays
    recapture them instead of duplicating.
    """

    def __init__(self, proc_id: int, dlq_dir: Optional[str] = None):
        self.proc_id = proc_id
        if dlq_dir is None:
            dlq_dir = os.environ.get("BYTEWAX_TPU_DLQ_DIR", "").strip()
        self.dir = dlq_dir or None
        self._pending: List[Dict[str, Any]] = []
        #: Lifetime captured-record count (also in the flight
        #: counters; kept here for /status).
        self.total = 0

    def _path(self, proc_id: Optional[int] = None) -> str:
        pid = self.proc_id if proc_id is None else proc_id
        return os.path.join(self.dir, f"dlq-p{pid:02d}.jsonl")

    def capture(
        self,
        step_id: str,
        part: str,
        records: List[Dict[str, Any]],
        epoch: int,
    ) -> None:
        """Buffer connector-reported dead letters with provenance.

        Each record is whatever the connector drained (commonly
        ``{"error": ..., "payload": ..., "offset": ...}``); the engine
        adds ``step_id``/``part``/``epoch``/``t`` and truncates the
        payload repr.  Buffered records ride the NEXT ``flush`` — the
        close of the epoch whose snapshots cover the offsets the
        connector consumed alongside them.
        """
        if not records:
            return
        now = time.time()
        for rec in records:
            doc = dict(rec)
            payload = doc.get("payload")
            if payload is not None and not isinstance(payload, str):
                doc["payload"] = repr(payload)
            if isinstance(doc.get("payload"), str):
                doc["payload"] = doc["payload"][:_PAYLOAD_CAP]
            if "error" in doc and not isinstance(doc["error"], str):
                doc["error"] = str(doc["error"])
            doc["step_id"] = step_id
            doc["part"] = part
            doc["epoch"] = epoch
            doc["t"] = round(now, 3)
            self._pending.append(doc)
        self.total += len(records)
        _flight.note_dlq(step_id, len(records))

    def pending_count(self) -> int:
        return len(self._pending)

    def flush(self) -> None:
        """Append every buffered record to the file (fsynced; each
        carries the epoch stamped at capture).  Called at every epoch
        close, before the snapshot commit — a crash between the
        append and the commit replays the epoch, and the resume
        truncation drops these rows so the replay's recapture is the
        only copy."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        if self.dir is None:
            return
        os.makedirs(self.dir, exist_ok=True)
        with open(self._path(), "a") as f:
            for doc in pending:
                f.write(json.dumps(doc, default=str))
                f.write("\n")
            f.flush()
            os.fsync(f.fileno())

    def truncate_for_resume(
        self, resume_epoch: int, proc_count: int = 1
    ) -> int:
        """Drop rows with ``epoch >= resume_epoch`` from this
        process's file (the replayed epochs recapture them); returns
        the number of rows dropped.  Process 0 additionally truncates
        files of processes beyond ``proc_count`` — rescale-on-resume
        may shrink the cluster, and an orphaned file's uncommitted
        tail would otherwise duplicate rows recaptured by the new
        owners.  Runs at driver build, before any epoch processing,
        so no peer is appending concurrently."""
        if self.dir is None:
            return 0
        paths = [self._path()]
        if self.proc_id == 0:
            k = proc_count
            while os.path.exists(self._path(k)):
                paths.append(self._path(k))
                k += 1
        dropped = 0
        for path in paths:
            if not os.path.exists(path):
                continue
            kept = []
            path_dropped = 0
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        # A torn tail line from a mid-append crash:
                        # covered by epoch >= resume (the crashed
                        # epoch never committed), so drop it.
                        path_dropped += 1
                        continue
                    if int(doc.get("epoch", -1)) >= resume_epoch:
                        path_dropped += 1
                    else:
                        kept.append(line)
            if path_dropped:
                # Atomic rewrite: a crash mid-truncation must not
                # lose the committed rows being kept — write the
                # survivor set beside the file and rename over it.
                tmp = f"{path}.tmp"
                with open(tmp, "w") as f:
                    f.writelines(kept)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            dropped += path_dropped
        return dropped
