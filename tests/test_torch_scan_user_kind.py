"""A scan kind defined in user code, in the JAX package and in the torch
port: the counterpart of
``tests/test_scan_accel.py::test_user_registered_kind_runs_on_device``.

The kind is a per-key running sum with a count, emitting ``(value,
running_total)``; it is defined here, in each package's dtypes, with no
engine change.  It must lower to the device tier (a ``ScanAccelSpec``),
run there through the generic segmented scan (a user kind has no
``kernel``), give the host oracle's rows and the reference's, and
resume from its device snapshots on the host tier.  Its snapshot tuple
``(count, total)`` is the same in both packages, so a store written by
one resumes in the other.  The port runs on the CPU.
"""

import os
from datetime import timedelta

import jax.numpy as jnp
import pytest
import torch

from bytewax_tpu import xla as ref_xla
from bytewax_tpu.engine.scan_accel import ScanAccelSpec as RefScanAccelSpec
from bytewax_tpu.ops.scan import ScanKind as RefScanKind
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.engine.scan_accel import ScanAccelSpec as PortScanAccelSpec
from bytewax_tpu_torch.ops.scan import ScanKind, generic_scan_body
from tests.test_torch_scan_accel import _assert_rows_close, _rand_items
from tests.torch_entry_points import PORT, REF, port_on_cpu, recovery_config, unsharded  # noqa: F401

ZERO_TD = timedelta(seconds=0)


class RunningSumKind(ScanKind):
    name = "running_sum"
    fields = {
        "count": (0, torch.int32),
        "total": (0.0, torch.float32),
    }

    def lift(self, values):
        # As a user writes it: no ``device=``.
        n = values.shape[0]
        return torch.ones((n,), dtype=torch.int32), values

    def merge(self, a, b):
        return a[0] + b[0], a[1] + b[1]

    def emit(self, pre, post, values):
        return (post[1],)


class RefRunningSumKind(RefScanKind):
    name = "running_sum"
    fields = {
        "count": (0, jnp.int32),
        "total": (0.0, jnp.float32),
    }

    def lift(self, values):
        n = values.shape[0]
        return jnp.ones((n,), dtype=jnp.int32), values

    def merge(self, a, b):
        return a[0] + b[0], a[1] + b[1]

    def emit(self, pre, post, values):
        return (post[1],)


def _running_sum(state, value):
    count, total = (0, 0.0) if state is None else state
    count += 1
    total += value
    return (count, total), (value, total)


class RunningSumMap(port_xla.ScanMap):
    kind = "running_sum"

    def __call__(self, state, value):
        return _running_sum(state, value)

    def device_kind(self):
        return RunningSumKind()


class RefRunningSumMap(ref_xla.ScanMap):
    kind = "running_sum"

    def __call__(self, state, value):
        return _running_sum(state, value)

    def device_kind(self):
        return RefRunningSumKind()


MAPS = {"bytewax_tpu": (RefRunningSumMap, RefScanAccelSpec), "bytewax_tpu_torch": (RunningSumMap, PortScanAccelSpec)}

ITEMS = [("a", 1.0), ("b", 10.0), ("a", 2.0), ("a", 3.0), ("b", 5.0)]
TAIL = [("a", 4.0), ("b", 1.0)]


@pytest.fixture(autouse=True)
def _device_tier(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")


def _oracle(items):
    states, out = {}, []
    for k, v in items:
        states[k], emit = _running_sum(states.get(k), v)
        out.append((k, emit))
    return out


def _flow(pkg, name, inp, out, batch_size=2):
    mapper, _spec = MAPS[pkg["name"]]
    flow = pkg["Dataflow"](name)
    s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=batch_size))
    s = pkg["op"].stateful_map("scan", s, mapper())
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


def _lowered(pkg, flow):
    """The flow's one scan step lowers to the package's device tier."""
    _mapper, spec = MAPS[pkg["name"]]
    specs = [o.conf.get("_accel") for o in pkg["flatten"](flow).ops if o.name == "stateful_batch"]
    return len(specs) == 1 and isinstance(specs[0], spec)


@pytest.mark.parametrize("data", ["reference", "random"])
def test_user_registered_kind_runs_on_device(data):
    items, batch_size = (ITEMS, 2) if data == "reference" else (_rand_items(), 7)
    want = _oracle(items)
    outs = []
    for pkg in (REF, PORT):
        out = []
        flow = _flow(pkg, "scan_kind", items, out, batch_size)
        assert _lowered(pkg, flow)
        pkg["run_main"](flow)
        _assert_rows_close(out, want)
        outs.append(out)
    _assert_rows_close(outs[1], outs[0])


def _accel_off_run(pkg, flow, rc):
    prev = os.environ.get("BYTEWAX_TPU_ACCEL")
    os.environ["BYTEWAX_TPU_ACCEL"] = "0"
    try:
        pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc)
    finally:
        if prev is None:
            os.environ.pop("BYTEWAX_TPU_ACCEL", None)
        else:
            os.environ["BYTEWAX_TPU_ACCEL"] = prev


def test_user_kind_device_snapshots_resume_on_the_host_tier(tmp_path):
    """Aborted after the device run, resumed with the accelerator off
    from the device's snapshots: every row once, as the oracle."""
    want = _oracle(ITEMS + TAIL)
    outs = []
    for pkg in (REF, PORT):
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        inp = ITEMS + [pkg["Source"].ABORT()] + TAIL
        out1, out2 = [], []
        pkg["run_main"](_flow(pkg, "scan_user_rt", inp, out1), epoch_interval=ZERO_TD, recovery_config=rc)
        _accel_off_run(pkg, _flow(pkg, "scan_user_rt", inp, out2), rc)
        _assert_rows_close(out1 + out2, want)
        outs.append(out1 + out2)
    _assert_rows_close(outs[1], outs[0])


@pytest.mark.parametrize("tier", ["device", "host"])
@pytest.mark.parametrize("first,second", [(REF, PORT), (PORT, REF)], ids=["jax-torch", "torch-jax"])
def test_user_kind_store_resumes_across_packages(tmp_path, first, second, tier):
    """One package runs the kind on its device tier and aborts; the
    other resumes its store, on its device tier or with the
    accelerator off, and every row comes out once."""
    want = _oracle(ITEMS + TAIL)
    rc = recovery_config(first, tmp_path)
    out1, out2 = [], []
    inp1 = ITEMS + [first["Source"].ABORT()] + TAIL
    first["run_main"](_flow(first, "scan_user_rt", inp1, out1), epoch_interval=ZERO_TD, recovery_config=rc)
    assert len(out1) == len(ITEMS)
    rc2 = second["recovery"].RecoveryConfig(str(tmp_path))
    inp2 = ITEMS + [second["Source"].ABORT()] + TAIL
    inp2[len(ITEMS)]._triggered = True
    flow = _flow(second, "scan_user_rt", inp2, out2)
    if tier == "device":
        second["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc2)
    else:
        _accel_off_run(second, flow, rc2)
    _assert_rows_close(out1 + out2, want)


def test_generic_scan_moves_lifted_columns_to_the_values_device():
    """A ``lift`` that builds a column without ``device=`` gets it on
    the CPU; the generic scan moves it to the values' device (here
    ``meta``, which holds shapes only) instead of failing on the mix,
    so a user kind written this way runs on the card."""
    kind = RunningSumKind()
    fields = {
        nm: torch.full((8,), init, dtype=dt, device="meta") for nm, (init, dt) in kind.fields.items()
    }
    slots = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32, device="meta")
    values = torch.ones(5, device="meta")
    (total,), out_fields = generic_scan_body(kind)(fields, slots, values)
    assert total.device.type == "meta" and total.shape == (5,)
    assert out_fields["count"].device.type == "meta"
