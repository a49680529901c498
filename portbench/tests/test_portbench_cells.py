"""The generator, and every cell's flow run through the port on the
CPU at a tiny size, judged by its reference; and the same runs with
the timed path broken, which the comparison must catch."""

import hashlib
import json

import numpy as np
import pytest

from portbench import run
from portbench.feeds.text import text_file
from portbench.generators.brc import Stream
from portbench.tests.tiny import ROOT, SECONDS, TINY, overrides

CELLS = sorted(TINY)


def _run(cell, tmp, seed=21, trace=False, fault=None, extra=None):
    ov = overrides(cell)
    for part, values in (extra or {}).items():
        ov.setdefault(part, {}).update(values)
    return run.run_cell(ROOT, cell, seed, SECONDS, trace, device="cpu", overrides=ov, tmp=tmp, fault=fault)


def test_the_stream_is_made_from_the_seed_alone():
    cell = run.find_cell(ROOT, "brc-10k.text", overrides("brc-10k.text"))
    a, b = Stream(cell.cfg, cell.traffic, 2**31 + 5), Stream(cell.cfg, cell.traffic, 2**31 + 5)
    c = Stream(cell.cfg, cell.traffic, 6)
    x, y = a.columns(5), b.columns(5)
    assert all(np.array_equal(x[k], y[k]) for k in x)
    assert text_file(a, 1) == text_file(b, 1)
    assert not np.array_equal(a.columns(0)["value"], c.columns(0)["value"])
    # Every seed does the same work: the same sizes.
    assert all(len(a.columns(0)[k]) == len(c.columns(0)[k]) for k in ("key_id", "value"))
    assert len(a.stations.names) == len(c.stations.names)
    assert len(text_file(a, 0).splitlines()) == len(text_file(c, 0).splitlines()) == a.batch_rows


#: SHA-256 of a full-size stream (each block's ids then readings, then
#: the station names joined by newlines) and of the text feed's files,
#: recorded from the generator as it was before it became
#: ``generators/brc.py``; a run's inputs must not move.
IDENTITY = {
    ("columnar", 1): "55c5e3ab5169c17b540b81ad8941010e6048bff0dfad7c2ca36419aa4058d9ff",
    ("columnar", 2): "be72c84e1933ef9497d3dc39f47dabfc7b613355139898c9c3ee2005e7df9213",
    ("columnar", 3): "19c83d9ae39e3bbe1d350cb611660d671815b3fc510252af176ff78e8d299074",
    ("text", 1): "d20e7459c29be6082962fab971594b2b3a06c1b8f1828b431b7d46453e2d1c4c",
    ("text", 2): "369b35c02366f248f2c69ee8cb49be2e3598c6b95bd8e02c58bbc88e7f0a9b31",
    ("text", 3): "9c8326a4166646525501f06d241c9c673469e6e1d543c7ad0df634e6cf97909c",
}
TEXT_FILES = {
    1: "f7abce11feee8855ed767b0ab25c1bac115f1993c5a8fca4618e470a118ebc98",
    2: "ed23e2cf955389a537b3a46e27982d811e1a0000f9fc3fbe392bc8dd43a68087",
    3: "e82fbb423c06df13b1add51354cf492291df35609fdf98d9025cc08911cba8f8",
}


@pytest.mark.parametrize("traffic,seed", sorted(IDENTITY))
def test_the_brc_stream_is_byte_identical_to_the_recorded_one(traffic, seed):
    pb = ROOT / "portbench"
    cfg = json.loads((pb / "configs" / "brc-10k.json").read_text())
    stream = Stream(cfg, json.loads((pb / "traffic" / f"{traffic}.json").read_text()), seed)
    h = hashlib.sha256()
    for blk in stream.blocks:
        h.update(blk.ids.tobytes())
        h.update(blk.deci.tobytes())
    h.update("\n".join(stream.stations.names.tolist()).encode())
    assert h.hexdigest() == IDENTITY[traffic, seed]
    if traffic == "text":
        files = hashlib.sha256()
        for r in range(stream.ring):
            files.update(text_file(stream, r))
        assert files.hexdigest() == TEXT_FILES[seed]


def test_stations_are_drawn_as_the_configuration_says():
    cell = run.find_cell(ROOT, "brc-10k.columnar")
    traffic = {"batch_rows": 1 << 16, "ring": 1}
    uniform = np.bincount(Stream(cell.cfg, traffic, 8).blocks[0].ids, minlength=10_000)
    zipf = np.bincount(Stream(dict(cell.cfg, station_draw={"zipf": 1.1}), traffic, 8).blocks[0].ids,
                       minlength=10_000)
    assert uniform.max() < 30
    top = np.sort(zipf)[::-1]
    assert top[0] > 40 * top[100] > 0


@pytest.mark.parametrize("key,value", [
    ("station_draw", "normal"), ("station_draw", {"zipf": 0}), ("station_draw", {"pareto": 1.0}),
    ("reading_decimals", 2),
])
def test_a_configuration_value_the_generator_lacks_is_refused(key, value):
    cell = run.find_cell(ROOT, "brc-10k.columnar")
    with pytest.raises(ValueError, match=key):
        Stream(dict(cell.cfg, **{key: value}), {"batch_rows": 64, "ring": 1}, 1)


@pytest.mark.parametrize("change", [{"rate_rows_per_s": 1000}, {"feed": "text"}])
def test_traffic_parameters_the_feed_does_not_read_are_refused(change, tmp_path):
    ov = overrides("brc-10k.columnar")
    ov["traffic"].update(change)
    with pytest.raises(run.BenchError, match="reads"):
        run.find_cell(ROOT, "brc-10k.columnar", ov).feed()


def test_station_names_keep_to_the_challenge():
    cell = run.find_cell(ROOT, "brc-10k.text")
    st = Stream(cell.cfg, {"batch_rows": 8, "ring": 1}, 3).stations
    lengths = [len(n.encode("utf-8")) for n in st.names.tolist()]
    assert len(st.names) == 10_000 == len(set(st.names.tolist()))
    assert min(lengths) == 1 and max(lengths) == 100
    assert st.names[1].isascii() and len(st.names[1]) == 100
    assert not any(";" in n or "\n" in n for n in st.names.tolist())
    assert any(not n.isascii() for n in st.names.tolist())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_through_the_port(cell, tmp_path):
    out = _run(cell, tmp_path)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    # No device on the CPU: the readers of the device's timeline find
    # nothing and stay out.
    e2e = out["context"].cell.metrics("end_to_end")
    assert set(result["metrics"]) == {m["name"] for m in e2e if m["source"] != "device_trace"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert out["context"].rows > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_host_side_metrics(cell, tmp_path):
    out = _run(cell, tmp_path, trace=True)
    result = out["result"]
    assert result["correct"]
    # No device on the CPU: the device readers find nothing and stay out.
    per_layer = out["context"].cell.metrics("per_layer")
    assert set(result["metrics"]) == {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert set(result["metrics"]) >= {
        "brc-10k.columnar": {"window_rows_per_s.card"},
        "brc-10k.text": {"ingest_share.rows", "host_share.rows", "h2d_bytes_per_row.rows"},
    }[cell]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def _patch_fold(make):
    """A fault planted in the fold the CPU path runs; returns the
    harness's ``fault`` hook."""
    from bytewax_tpu_torch.ops import segment

    def fault():
        orig = segment.fold_plain
        segment.fold_plain = make(orig)

        def undo():
            segment.fold_plain = orig

        return undo

    return fault


def _unchanged(orig):
    return lambda kind, state, slots, vals: state


def _half(orig):
    def fold(kind, state, slots, vals):
        n = len(slots) // 2
        return orig(kind, state, slots[:n], vals[:n])

    return fold


def _altered(orig):
    done = []

    def fold(kind, state, slots, vals):
        out = orig(kind, state, slots, vals)
        if not done and len(slots):
            out["count"][int(slots[0])] += 1
            done.append(1)
        return out

    return fold


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path):
    out = _run(cell, tmp_path, fault=_patch_fold(fault))
    assert not out["result"]["correct"]
    assert out["result"]["failed"] > 0


def test_a_demotion_in_the_window_gives_no_result(tmp_path):
    from bytewax_tpu_torch.engine import flight

    def demote():
        flight.RECORDER.count("demotion_count")
        return lambda: None

    with pytest.raises(run.BenchError, match="demotion"):
        _run("brc-10k.columnar", tmp_path, fault=demote)


def test_a_window_without_the_cells_kernels_is_off_the_card():
    assert run.off_card({"demotion_count": 0}, {"fold_kernel": 12}, True) == []
    assert run.off_card({}, {"fold_kernel": 0}, True) == ["no launch of ops.fold_kernel in the window"]
    assert run.off_card({}, {"fold_kernel": 0}, False) == []
    assert run.off_card({"demotion_count": 2}, {"fold_kernel": 5}, True)
    # The counters the check reads exist in the port.
    assert run._launches(["fold_kernel"])["fold_kernel"] >= 0
