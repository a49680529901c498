"""Whole flows through ``run_main`` of the JAX package and of the torch
port, on the same inputs; the outputs must agree (exactly for counts,
integer state, min and max; float32 sums to ``rtol=atol=1e-5``).

The JAX package runs with ``BYTEWAX_TPU_SHARD=0``: the test session's
8-device CPU mesh would otherwise put it on its mesh-sharded tier,
and the tier the port has is the single-device slot table.
"""

import os

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu_torch.engine.sharded_state as port_sharded_state
import bytewax_tpu_torch.operators as port_op
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.models import brc as ref_brc
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.models import brc as port_brc
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform

REF = {
    "op": ref_op,
    "xla": ref_xla,
    "Dataflow": RefDataflow,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
    "brc": ref_brc,
}
PORT = {
    "op": port_op,
    "xla": port_xla,
    "Dataflow": PortDataflow,
    "Source": PortSource,
    "Sink": PortSink,
    "run_main": port_run_main,
    "brc": port_brc,
}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.fixture
def device_states(monkeypatch):
    """Single-device tier on for both packages; records the device
    states the port's driver builds."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    made = []
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        made.append(make(kind, driver=driver))
        return made[-1]

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    return made


def _close(g, w):
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def assert_stats_match(got, want):
    """``(key, (min, mean, max, count))`` outputs: min, max and count
    exact, mean to the float32-sum tolerance."""
    assert sorted(k for k, _ in got) == sorted(k for k, _ in want)
    want = dict(want)
    for key, (mn, mean, mx, count) in got:
        wmn, wmean, wmx, wcount = want[key]
        assert (mn, mx, count) == (wmn, wmx, wcount), key
        assert _close(mean, wmean), (key, mean, wmean)


def _stats_flow(pkg, source, out):
    flow = pkg["Dataflow"]("stats")
    s = pkg["op"].input("inp", flow, source)
    s = pkg["xla"].stats_final("stats", s)
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


def _run_both(build):
    outs = []
    for pkg in (REF, PORT):
        out = []
        pkg["run_main"](build(pkg, out))
        outs.append(out)
    return outs


def test_brc_columnar_matches_reference(device_states):
    def build(pkg, out):
        batches = pkg["brc"].generate_batches(20_000, 4096, 413, seed=3)
        return _stats_flow(pkg, pkg["brc"].ArrayBatchSource(batches), out)

    want, got = _run_both(build)
    assert len(got) == 413
    assert_stats_match(got, want)
    assert [s.device.type for s in device_states] == ["cpu"]
    assert device_states[0].capacity == 1024


def test_brc_itemized_matches_reference(device_states):
    rng = np.random.RandomState(4)
    stations = [f"station_{i:03d}" for i in range(97)]
    items = [
        (stations[i], q * 0.1)
        for i, q in zip(
            rng.randint(0, len(stations), size=6000).tolist(),
            rng.randint(-999, 1000, size=6000).tolist(),
        )
    ]
    batches = [items[i : i + 1000] for i in range(0, len(items), 1000)]

    def build(pkg, out):
        source = pkg["brc"].ArrayBatchSource(batches)
        return pkg["brc"].brc_flow(source, pkg["Sink"](out))

    want, got = _run_both(build)
    assert sorted(got) == sorted(want)
    assert len(device_states) == 1


def _items(rng, n: int, integer: bool):
    keys = [f"k{i}" for i in rng.randint(0, 37, size=n).tolist()]
    if integer:
        vals = rng.randint(-500, 500, size=n).tolist()
    else:
        vals = (rng.randn(n) * 20).tolist()
    return list(zip(keys, vals))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("reducer", ["SUM", "MIN", "MAX"])
def test_reduce_final_matches_reference(device_states, reducer, integer):
    items = _items(np.random.RandomState(5), 3000, integer)

    def build(pkg, out):
        flow = pkg["Dataflow"]("reduce")
        s = pkg["op"].input("inp", flow, pkg["Source"](items, batch_size=256))
        s = pkg["op"].reduce_final("r", s, getattr(pkg["xla"], reducer))
        pkg["op"].output("out", s, pkg["Sink"](out))
        return flow

    want, got = _run_both(build)
    got, want = sorted(got), sorted(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        if integer or reducer != "SUM":
            assert g == w and type(g) is type(w), (key, g, w)
        else:
            assert _close(g, w), (key, g, w)
    assert len(device_states) == 1


def test_count_final_matches_reference(device_states):
    words = [f"w{i}" for i in np.random.RandomState(6).randint(0, 300, size=5000)]

    def build(pkg, out):
        flow = pkg["Dataflow"]("count")
        s = pkg["op"].input("inp", flow, pkg["Source"](words, batch_size=500))
        s = pkg["op"].count_final("count", s, lambda w: w)
        pkg["op"].output("out", s, pkg["Sink"](out))
        return flow

    want, got = _run_both(build)
    assert sorted(got) == sorted(want)
    assert len(device_states) == 1


def test_stats_final_items_matches_reference(device_states):
    items = _items(np.random.RandomState(7), 4000, integer=False)

    def build(pkg, out):
        return _stats_flow(pkg, pkg["Source"](items, batch_size=300), out)

    want, got = _run_both(build)
    assert_stats_match(got, want)
    assert len(device_states) == 1


def test_port_host_tier_matches_port_device_tier(device_states, monkeypatch):
    # The host tier folds in float64, the device tier in float32:
    # values a float32 holds exactly keep min and max exact.
    items = [
        (k, float(np.float32(v)))
        for k, v in _items(np.random.RandomState(8), 4000, integer=False)
    ]
    outs = []
    for accel in ("1", "0"):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
        out = []
        port_run_main(_stats_flow(PORT, PortSource(items, batch_size=300), out))
        outs.append(out)
    device, host = outs
    assert len(device_states) == 1  # only the accelerated run built one
    assert_stats_match(device, host)
