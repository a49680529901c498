"""Connector-edge resilience through the torch port, held to the
assertions of ``tests/test_io_resilience.py``.

``CSVSource(on_error="dlq")`` dead-letters a row holding a NUL in both
modes: on Python 3.12 ``csv`` no longer raises on NUL, so the port's
connector checks the raw row itself (the JAX package's does not, and
its copy of the itemized case fails there).
"""

import json
import os
from datetime import timedelta

import pytest

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.testing import TestingSink, run_main
from bytewax_tpu_torch.utils import force_platform

ZERO_TD = timedelta(seconds=0)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


# -- dead-letter queue --------------------------------------------------


def test_csv_dlq_poison_row_itemized(tmp_path, monkeypatch):
    path = tmp_path / "rows.csv"
    path.write_bytes(b"name,score\na,1\nbad\x00row,9\nb,2\n")
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(tmp_path / "dlq"))
    from bytewax_tpu_torch.connectors.files import CSVSource

    out = []
    flow = Dataflow("csv_dlq_df")
    s = op.input("inp", flow, CSVSource(str(path), on_error="dlq"))
    op.output("out", s, TestingSink(out))
    run_main(flow, epoch_interval=ZERO_TD)
    assert out == [
        {"name": "a", "score": "1"},
        {"name": "b", "score": "2"},
    ]
    rows = [
        json.loads(line)
        for line in (tmp_path / "dlq" / "dlq-p00.jsonl").read_text().splitlines()
    ]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["step_id"] == "csv_dlq_df.inp"
    assert "NUL" in rec["error"]
    assert "bad" in rec["payload"]
    assert rec["epoch"] >= 1 and rec["part"].endswith("rows.csv")


def test_csv_dlq_poison_row_columnar(tmp_path, monkeypatch):
    """The columnar reader's vectorized split would take a NUL row as
    data: the chunk holding it goes through the csv fallback, which
    dead-letters the row with its raw line, and the good rows of the
    chunk still flow."""
    path = tmp_path / "rows.csv"
    path.write_bytes(b"name,score\na,1\nbad\x00row,9\nb,2\n")
    monkeypatch.setenv("BYTEWAX_TPU_DLQ_DIR", str(tmp_path / "dlq"))
    from bytewax_tpu_torch.connectors.files import CSVSource

    out = []
    flow = Dataflow("csv_dlq_col_df")
    s = op.input("inp", flow, CSVSource(str(path), columnar=True, on_error="dlq"))
    op.output("out", s, TestingSink(out))
    run_main(flow, epoch_interval=ZERO_TD)
    assert out == [
        {"name": "a", "score": "1"},
        {"name": "b", "score": "2"},
    ]
    rows = [
        json.loads(line)
        for line in (tmp_path / "dlq" / "dlq-p00.jsonl").read_text().splitlines()
    ]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["step_id"] == "csv_dlq_col_df.inp"
    assert "NUL" in rec["error"]
    assert rec["payload"] == "bad\x00row,9\n"
