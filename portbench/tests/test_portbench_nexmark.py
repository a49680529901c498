"""The ``nexmark-q5`` configuration: its generator against Apache Beam's
rules, the cell through the port on the CPU at a tiny size, plain and
traced, judged by the plain reference; planted faults that the
comparison must catch; the bfloat16 control; and a reference that
loads nothing of the program."""

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import run
from portbench.generators.nexmark import EVENT_TYPES, Stream
from portbench.tests.tiny import ROOT, SECONDS
from portbench.tools import control

CELL = "nexmark-q5.events"
#: 2^12-event blocks (0.41 event-seconds each) from a ring of 4.
TINY = {"traffic": {"batch_rows": 4096, "ring": 4}}


def _tiny():
    return {part: dict(values) for part, values in TINY.items()}


def _stream(seed, batch_rows=4096, ring=4):
    cell = run.find_cell(ROOT, CELL)
    return Stream(cell.cfg, {"batch_rows": batch_rows, "ring": ring}, seed)


def test_the_events_keep_to_beams_rules():
    stream = _stream(2**31 + 3, batch_rows=50 * 1000, ring=2)
    ev = stream.events([0, 1, 2])
    kind = ev["event_type"].reshape(-1, 50)
    # 1 person, 3 auctions, 46 bids in every 50 events, in that order.
    assert (kind[:, 0] == EVENT_TYPES["person"]).all()
    assert (kind[:, 1:4] == EVENT_TYPES["auction"]).all()
    assert (kind[:, 4:] == EVENT_TYPES["bid"]).all()
    # Auction ids start at 1000 and rise by one; persons at 1000.
    auctions = ev["auction"][ev["event_type"] == EVENT_TYPES["auction"]]
    assert auctions[0] == 1000 and (np.diff(auctions) == 1).all()
    persons = ev["bidder"][ev["event_type"] == EVENT_TYPES["person"]]
    assert persons[0] == 1000 and (np.diff(persons) == 1).all()
    # 100 us an event, on Beam's millisecond clock.
    n = np.arange(len(ev["date_time"]))
    assert (ev["date_time"] == (1_700_000_000_000 + n // 10) * 1000).all()

    bid = ev["event_type"] == EVENT_TYPES["bid"]
    newest = np.maximum.accumulate(np.where(ev["event_type"] == EVENT_TYPES["auction"], ev["auction"], 0))[bid]
    got = ev["auction"][bid]
    hot = got == 1000 + ((newest - 1000) // 100) * 100
    # Half the bids go to the hot auction (and a few cold draws land
    # on it too), the rest over the 100 newest and 10 ahead.
    assert 0.49 < hot.mean() < 0.52
    cold = got[~hot] - newest[~hot]
    assert cold.min() >= -100 and cold.max() <= 10
    assert cold.min() == -100 and cold.max() == 10
    # A hot auction takes about 770 bids, a cold one about 8.
    per_auction = np.bincount(got - 1000)
    assert 700 < per_auction[(np.arange(len(per_auction)) % 100) == 0][1:-1].mean() < 840
    assert 6 < np.median(per_auction[per_auction > 0]) < 12


def test_blocks_come_from_the_seed_alone():
    a, b, c = _stream(2**31 + 5), _stream(2**31 + 5), _stream(6)
    for k, col in a.columns(5).items():
        assert np.array_equal(col, b.columns(5)[k])
        assert col.dtype == np.int64 and len(col) == a.batch_rows
    assert not np.array_equal(a.columns(0)["auction"], c.columns(0)["auction"])
    # The seed moves the draws, never the event kinds or times.
    for k in ("event_type", "date_time"):
        assert np.array_equal(a.columns(3)[k], c.columns(3)[k])
    # Block b draws from ring entry b mod ring; its ids keep rising.
    d = _stream(7, batch_rows=4000)
    assert np.array_equal(d.events([1])["price"], d.events([5])["price"])
    assert a.columns(5)["auction"].max() > a.columns(1)["auction"].max()


def test_a_proportion_the_generator_lacks_is_refused():
    cell = run.find_cell(ROOT, CELL)
    with pytest.raises(ValueError, match="bid_proportion"):
        Stream(dict(cell.cfg, bid_proportion=40), {"batch_rows": 64, "ring": 1}, 1)


def _run(tmp, trace=False, fault=None, seed=2**31 + 11):
    return run.run_cell(ROOT, CELL, seed, SECONDS, trace, device="cpu", overrides=_tiny(), tmp=tmp,
                        fault=fault)


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_the_cell_runs_correct_through_the_port(trace, tmp_path):
    out = _run(tmp_path, trace)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == ["missing", "count_err", "max_err", "hot_set_err", "late"]
    assert result["attempted"] > 0 and result["failed"] == 0
    counters = out["context"].counters
    assert counters["window_rows_ingested"] > 0 and counters["window_keys_retired"] > 0
    assert counters["windows_opened"] == counters["windows_closed"] > 0
    if not trace:
        assert set(result["metrics"]) == {"rows_per_s", "setup_s"}
        return
    # No device on the CPU: the readers of its timeline stay out.
    assert set(result["metrics"]) == {"window_close_share.q5", "window_assign_share.q5",
                                      "window_clock_share.q5", "host_share.rows",
                                      "mapper_share.rows", "ingest_share.rows"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def _off_by_one():
    from bytewax_tpu_torch.engine import window_accel as wa

    orig = wa.DeviceWindowAggState._finalize_one
    done = []

    def finalize(self, snap):
        value = orig(self, snap)
        if not done and value > 1:
            done.append(1)
            return value + 1
        return value

    wa.DeviceWindowAggState._finalize_one = finalize
    return lambda: setattr(wa.DeviceWindowAggState, "_finalize_one", orig)


def _set_short():
    from bytewax_tpu_torch.operators import windowing

    orig = windowing._WindowLogic._apply_closes
    done = []

    def closes(self, watermark):
        for wid, tag, value in orig(self, watermark):
            if not done and tag == "E" and isinstance(value, tuple) and value[1]:
                done.append(1)
                value = (value[0], value[1][:-1])
            yield wid, tag, value

    windowing._WindowLogic._apply_closes = closes
    return lambda: setattr(windowing._WindowLogic, "_apply_closes", orig)


def _one_late():
    from bytewax_tpu_torch.engine import window_accel as wa

    orig = wa.DeviceWindowAggState._ingest
    done = []

    def ingest(self, kids, ts_us, values, fold_vals=None):
        events, phase = orig(self, kids, ts_us, values, fold_vals)
        if not done and len(kids):
            done.append(1)
            events = events + self._late_events(np.array([0]), kids, ts_us, values)[:1]
        return events, phase

    wa.DeviceWindowAggState._ingest = ingest
    return lambda: setattr(wa.DeviceWindowAggState, "_ingest", orig)


@pytest.mark.parametrize("fault,check", [(_off_by_one, "count_err"), (_set_short, "hot_set_err"),
                                         (_one_late, "late")], ids=["count_off_by_one", "set_short", "bid_late"])
def test_a_planted_fault_is_not_correct(fault, check, tmp_path):
    result = _run(tmp_path, fault=fault)["result"]
    assert not result["correct"]
    assert result["checks"][check]["value"] > result["checks"][check]["limit"]


def test_the_control_fails_in_bfloat16_and_passes_in_float32():
    low = control.read(CELL, 31, 12, "cpu", overrides=_tiny(), root=ROOT)
    assert low["dtype"] == "bfloat16" and not low["correct"]
    assert low["checks"]["count_err"]["value"] > 0 and low["checks"]["hot_set_err"]["value"] > 0
    assert control.read(CELL, 31, 12, "cpu", "float32", overrides=_tiny(), root=ROOT)["correct"]


_REF = """
import json, sys
from portbench import run
from portbench.tests.tiny import ROOT
run.load_module(ROOT / "portbench" / "reference" / "nexmark-q5.py", "nexmark_q5_reference")
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_the_reference_loads_nothing_of_the_program():
    env = {"PATH": "/usr/bin:/bin", "BYTEWAX_TPU_PLATFORM": "cpu", "HOME": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", _REF], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not {"jax", "jaxlib", "flax", "bytewax_tpu", "bytewax_tpu_torch"} & tops


def test_the_gap_tool_times_the_measured_windows_ingests(monkeypatch, capsys, tmp_path):
    from portbench.tools import gaps

    def run_main(argv):
        result = _run(tmp_path)["result"]
        print(json.dumps(result))
        return 0

    monkeypatch.setattr(run, "main", run_main)
    assert gaps.main([]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["correct"]
    (state,) = lines[1]["portbench_gaps"]
    assert state["ingests"] > 1 and 0 < state["widest_gap_s"] == state["gaps_s"][0]
    assert gaps.widest([1.0, 1.5, 3.5, 3.75]) == {
        "ingests": 4, "widest_gap_s": 2.0, "widest_at_s": 0.5, "gaps_s": [2.0, 0.5, 0.25]}
