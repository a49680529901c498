"""Each plain reference against a brute-force loop at a tiny size."""

import json

import numpy as np
import pytest

from portbench import run
from portbench.generators.brc import Stream, stations_of
from portbench.reference import _judge
from portbench.tests.tiny import ROOT, overrides
from portbench.tools.control import Blocks


def _brute_stats(ids, deci):
    out = {}
    for k, d in zip(ids.tolist(), deci.tolist()):
        c, s, a, lo, hi = out.get(k, (0, 0, 0, 10**9, -(10**9)))
        out[k] = (c + 1, s + d, a + abs(d), min(lo, d), max(hi, d))
    return out


@pytest.mark.parametrize("draw", ["uniform", {"zipf": 1.2}])
def test_brc_reference_matches_a_loop(draw):
    cell = run.find_cell(ROOT, "brc-10k.columnar", overrides("brc-10k.columnar"))
    ref = cell.module("reference", "brc-10k")
    stream = Stream(dict(cell.cfg, station_draw=draw), cell.traffic, 11)
    handed = Blocks(7)
    want = ref.expect(stream, handed, cell.spec)
    ids, deci = stream.rows_of(np.array(handed.block))
    brute = _brute_stats(ids, deci)
    assert set(want) == set(brute)
    for k, (c, s, a, lo, hi) in brute.items():
        mn, mean, mx, count, mean_abs = want[k]
        assert (count, mn, mx) == (c, lo / 10.0, hi / 10.0)
        assert mean == pytest.approx(s / c / 10.0, rel=1e-12, abs=1e-12)
        assert mean_abs == pytest.approx(a / c / 10.0, rel=1e-12)


def test_judge_counts_every_kind_of_fault():
    want = {0: (1.0, 2.0, 3.0, 4, 2.0), 1: (0.0, 1.0, 2.0, 2, 1.0)}
    limits = {"missing": 0, "count_err": 0, "minmax_err_deci": 0.02, "mean_err": 1e-4}
    ok = _judge.judge({0: (1.0, 2.0, 3.0, 4), 1: (0.0, 1.0, 2.0, 2)}, want, limits)
    assert ok.correct and ok.failed == 0 and ok.attempted == 2
    for got in (
        {0: (1.0, 2.0, 3.0, 4)},
        {0: (1.0, 2.0, 3.0, 4), 1: (0.0, 1.0, 2.0, 3)},
        {0: (1.0, 2.0, 3.1, 4), 1: (0.0, 1.0, 2.0, 2)},
        {0: (1.0, 2.01, 3.0, 4), 1: (0.0, 1.0, 2.0, 2)},
        {0: (1.0, float("nan"), 3.0, 4), 1: (0.0, 1.0, 2.0, 2)},
        {0: (1.0, 2.0, 3.0, 4), 1: (0.0, 1.0, 2.0, 2), 7: (0.0, 0.0, 0.0, 1)},
    ):
        verdict = _judge.judge(got, want, limits)
        assert not verdict.correct and verdict.failed >= 1


def test_configs_state_their_limits_and_guarantees():
    for path in sorted((ROOT / "portbench" / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        assert set(cfg["limits"]) == {"missing", "count_err", "minmax_err_deci", "mean_err"}
        assert cfg["limits"]["count_err"] == 0 and cfg["limits"]["missing"] == 0
        assert cfg["guarantees"] and cfg["precision"] == "float32"
        st = stations_of(cfg, 5)
        assert len(set(st.names.tolist())) == cfg["stations"]
