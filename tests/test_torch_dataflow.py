"""The dataflow model of the torch port (``bytewax_tpu_torch.dataflow``
and the flattening of ``engine/flatten.py``) held against the JAX
package: each case of ``tests/test_dataflow.py`` built through both
packages, with the same error type and message, the same step ids and
the same flattened plan."""

import pytest

from tests.torch_entry_points import (  # noqa: F401
    PKGS,
    PORT,
    REF,
    assert_same_error,
    port_on_cpu,
    raised,
    unsharded,
)


def _same_error(build):
    """``build(pkg)`` must raise the same ``DataflowError`` in both."""
    want, got = (raised(lambda pkg=pkg: build(pkg)) for pkg in PKGS)
    assert isinstance(want, REF["DataflowError"])
    assert_same_error(want, got, PORT["DataflowError"])
    return got


def _input(pkg, flow, items=()):
    return pkg["op"].input("inp", flow, pkg["Source"](list(items)))


def test_flow_requires_id():
    _same_error(lambda pkg: pkg["Dataflow"](""))


def test_flow_id_no_period():
    got = _same_error(lambda pkg: pkg["Dataflow"]("a.b"))
    assert "period" in str(got)


@pytest.mark.parametrize("step_id", ["a.b", 17], ids=["period", "not_str"])
def test_step_id_rules(step_id):
    def build(pkg):
        s = _input(pkg, pkg["Dataflow"]("test_df"))
        pkg["op"].map(step_id, s, lambda x: x)

    got = _same_error(build)
    if step_id == "a.b":
        assert "period" in str(got)


def test_duplicate_step_id_raises():
    def build(pkg):
        s = _input(pkg, pkg["Dataflow"]("test_df"))
        pkg["op"].map("dup", s, lambda x: x)
        pkg["op"].map("dup", s, lambda x: x)

    assert "dup" in str(_same_error(build))


def test_stream_from_other_flow_raises():
    def build(pkg):
        s_a = _input(pkg, pkg["Dataflow"]("a"))
        s_b = _input(pkg, pkg["Dataflow"]("b"))
        pkg["op"].merge("bad", s_b, s_a)

    assert "different dataflow" in str(_same_error(build))


def test_then_chaining():
    ids = []
    for pkg in PKGS:
        flow = pkg["Dataflow"]("test_df")
        (
            _input(pkg, flow, [1, 2])
            .then(pkg["op"].map, "double", lambda x: x * 2)
            .then(pkg["op"].output, "out", pkg["Sink"]([]))
        )
        ids.append([o.step_id for o in flow.substeps])
    assert ids[1] == ids[0] == ["test_df.inp", "test_df.double", "test_df.out"]


def test_nested_step_ids():
    shapes = []
    for pkg in PKGS:
        flow = pkg["Dataflow"]("test_df")
        pkg["op"].map("my_map", _input(pkg, flow, [1]), lambda x: x)
        outer = flow.substeps[1]
        inner = outer.substeps[0]
        shapes.append((outer.step_id, outer.core, inner.step_id, inner.core))
    assert shapes[1] == shapes[0]
    assert shapes[1] == ("test_df.my_map", False, "test_df.my_map.flat_map_batch", True)


def test_flatten_requires_input():
    got = _same_error(lambda pkg: pkg["flatten"](pkg["Dataflow"]("test_df")))
    assert "input" in str(got)


def test_flatten_requires_output():
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        _input(pkg, flow)
        pkg["flatten"](flow)

    assert "output" in str(_same_error(build))


def test_flatten_core_only():
    plans = []
    for pkg in PKGS:
        op = pkg["op"]
        flow = pkg["Dataflow"]("test_df")
        s = op.map("m", _input(pkg, flow, [1]), lambda x: x)
        b = op.branch("b", s, lambda x: True)
        op.output("out", op.merge("mg", b.trues, b.falses), pkg["Sink"]([]))
        plan = pkg["flatten"](flow)
        assert all(o.core for o in plan.ops)
        plans.append([(o.name, o.step_id) for o in plan.ops])
    assert plans[1] == plans[0]
    assert [name for name, _id in plans[1]] == [
        "input",
        "flat_map_batch",
        "branch",
        "merge",
        "output",
    ]


def test_operator_requires_stream_arg():
    got = _same_error(lambda pkg: pkg["op"].map("m", 42, lambda x: x))
    assert "Stream or" in str(got) and "Dataflow" in str(got)


def test_branch_out_fields():
    fields = []
    for pkg in PKGS:
        b = pkg["op"].branch("b", _input(pkg, pkg["Dataflow"]("test_df"), [1]), bool)
        fields.append((b.trues.stream_id, b.falses.stream_id))
    assert fields[1] == fields[0]
    assert fields[1][0].endswith("trues") and fields[1][1].endswith("falses")
