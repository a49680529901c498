"""The torch port's typed errors (``bytewax_tpu_torch.errors``) held
against the JAX package: the cases of ``tests/test_errors.py``.  A
user's exception keeps its type and message through both drivers, and
its notes name the same fully qualified step, the same engine layer
and the same user callable (the engine's own file and line differ
between the two drivers and are compared by file name only)."""

import functools

from tests.torch_entry_points import (  # noqa: F401
    PKGS,
    neutral_notes,
    port_on_cpu,
    raised,
    unsharded,
)


def _boom(x):
    raise ValueError("boom")


def _errors_of(build):
    """Runs ``build(pkg)`` under each package's ``run_main``; returns
    the two exceptions."""
    return [raised(lambda pkg=pkg: pkg["run_main"](build(pkg))) for pkg in PKGS]


def test_mapper_error_carries_step_and_callable_location():
    def build(pkg):
        flow = pkg["Dataflow"]("errflow")
        s = pkg["op"].input("inp", flow, pkg["Source"]([1]))
        s = pkg["op"].map("bad", s, _boom)
        pkg["op"].output("out", s, pkg["Sink"]([]))
        return flow

    want, got = _errors_of(build)
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want) == "boom"
    assert neutral_notes(got) == neutral_notes(want)
    notes = "\n".join(got.__notes__)
    assert "'errflow.bad" in notes
    assert "engine at" in notes and "bytewax_tpu_torch/engine/driver.py:" in notes
    assert "user callable defined at" in notes and "test_torch_errors.py" in notes


def test_logic_builder_error_carries_context():
    def bad_builder(_resume):
        raise RuntimeError("cannot build")

    def build(pkg):
        flow = pkg["Dataflow"]("errflow2")
        s = pkg["op"].input("inp", flow, pkg["Source"]([("k", 1)]))
        s = pkg["op"].stateful_batch("st", s, bad_builder)
        pkg["op"].output("out", s, pkg["Sink"]([]))
        return flow

    want, got = _errors_of(build)
    assert type(got) is type(want) is RuntimeError
    assert str(got) == str(want) == "cannot build"
    assert neutral_notes(got) == neutral_notes(want)
    notes = "\n".join(got.__notes__)
    assert "the logic builder" in notes and "'errflow2.st" in notes
    assert "user callable defined at" in notes


def test_callable_location_shapes():
    class _CallableObj:
        def __call__(self):
            pass

    obj = _CallableObj()
    part = functools.partial(_boom, 1)
    shapes = []
    for pkg in PKGS:
        loc = pkg["errors"].callable_location
        shapes.append((loc(_boom), loc(part), loc(obj) is not None, loc(len)))
    assert shapes[1] == shapes[0]
    assert shapes[1][0].endswith(f":{_boom.__code__.co_firstlineno}")
    assert shapes[1][1] == shapes[1][0]
    assert shapes[1][2] and shapes[1][3] is None


def test_note_context_is_safe_on_any_exception():
    notes = []
    for pkg in PKGS:
        ex = ValueError("x")
        pkg["errors"].note_context(ex, "ctx", fn=_boom)
        notes.append(neutral_notes(ex))
    assert notes[1] == notes[0]
    assert any("ctx (engine at" in n for n in notes[1])
    assert any("user callable defined at" in n for n in notes[1])
