"""Execution of the torch port's driver (``bytewax_tpu_torch/engine/
flatten.py`` and ``engine/driver.py``) held against the JAX package:
each case of ``tests/test_execution_basic.py`` runs the same flow on
the same input through both packages.  A case the reference runs under
its ``entry_point`` fixture runs here under each package's own
``run_main``, ``cluster_main`` with one lane and ``cluster_main`` with
two.  Outputs are equal (sorted, where the reference sorts; in order
where it asserts order), and a raised error has the same type and
message and names the same step.
"""

import pytest

from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    assert_same_error,
    neutral_notes,
    port_on_cpu,
    raised,
    run_both,
    unsharded,
)


def _through(body, inp, batch_size=None, flow_id="test_df"):
    """A flow ``input -> body(pkg, stream) -> output`` over ``inp``."""

    def build(pkg):
        flow = pkg["Dataflow"](flow_id)
        kwargs = {} if batch_size is None else {"batch_size": batch_size}
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, **kwargs))
        out = []
        pkg["op"].output("out", body(pkg, s), pkg["Sink"](out))
        return flow, out

    return build


def _sorted_same(body, inp, entry_point, expect, batch_size=None):
    want, got = run_both(_through(body, inp, batch_size), entry_point)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert sorted(got) == expect
    return got


def _running_sum(state, v):
    state = (state or 0) + v
    return (state, state)


def _dup(state, v):
    state = (state or 0) + 1
    return (state, [v] * state)


def _parse(x):
    try:
        return int(x)
    except ValueError:
        return None


# (id, body, input, expected sorted output) of the one-stream cases.
STREAM_CASES = [
    ("map", lambda pkg, s: pkg["op"].map("add_one", s, lambda x: x + 1), [0, 1, 2], [1, 2, 3]),
    (
        "filter",
        lambda pkg, s: pkg["op"].filter("is_odd", s, lambda x: x % 2 == 1),
        [1, 2, 3, 4],
        [1, 3],
    ),
    (
        "flat_map",
        lambda pkg, s: pkg["op"].flat_map("split", s, lambda x: x.split()),
        ["a b", "c"],
        ["a", "b", "c"],
    ),
    (
        "key_on_key_rm",
        lambda pkg, s: pkg["op"].key_rm("unkey", pkg["op"].key_on("key", s, str)),
        [1, 2],
        [1, 2],
    ),
    ("redistribute", lambda pkg, s: pkg["op"].redistribute("redist", s), [1, 2, 3], [1, 2, 3]),
    (
        "stateful_map",
        lambda pkg, s: pkg["op"].stateful_map("sum", s, _running_sum),
        [("a", 1), ("b", 10), ("a", 2), ("b", 20)],
        [("a", 1), ("a", 3), ("b", 10), ("b", 30)],
    ),
    (
        "reduce_final",
        lambda pkg, s: pkg["op"].reduce_final("sum", s, lambda a, b: a + b),
        [("a", 1), ("a", 2), ("b", 5)],
        [("a", 3), ("b", 5)],
    ),
    (
        "fold_final",
        lambda pkg, s: pkg["op"].fold_final("collect", s, list, lambda acc, x: acc + [x]),
        [("a", 1), ("a", 2), ("b", 5)],
        [("a", [1, 2]), ("b", [5])],
    ),
    (
        "count_final",
        lambda pkg, s: pkg["op"].count_final("count", s, lambda x: x),
        ["apple", "banana", "apple", "banana", "banana"],
        [("apple", 2), ("banana", 3)],
    ),
    (
        "max_final",
        lambda pkg, s: pkg["op"].max_final("max", s),
        [("key1", 1), ("key1", 3), ("key2", 2), ("key2", 19)],
        [("key1", 3), ("key2", 19)],
    ),
    (
        "min_final",
        lambda pkg, s: pkg["op"].min_final("min", s),
        [("key1", 1), ("key1", 3), ("key2", 2), ("key2", 19)],
        [("key1", 1), ("key2", 2)],
    ),
    (
        "wordcount",
        lambda pkg, s: pkg["op"].count_final(
            "count", pkg["op"].flat_map("split", s, str.split), lambda w: w
        ),
        ["a b a", "b a"],
        [("a", 3), ("b", 2)],
    ),
    (
        "stateful_flat_map",
        lambda pkg, s: pkg["op"].stateful_flat_map("dup", s, _dup),
        [("a", 1), ("a", 2)],
        [("a", 1), ("a", 2), ("a", 2)],
    ),
    (
        "flat_map_value",
        lambda pkg, s: pkg["op"].flat_map_value("split", s, str.split),
        [("a", "x y")],
        [("a", "x"), ("a", "y")],
    ),
    (
        "filter_map",
        lambda pkg, s: pkg["op"].filter_map("parse", s, _parse),
        ["1", "two", "3"],
        [1, 3],
    ),
    ("flatten", lambda pkg, s: pkg["op"].flatten("flatten", s), [[1, 2], [3]], [1, 2, 3]),
]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
@pytest.mark.parametrize(
    "body, inp, expect",
    [case[1:] for case in STREAM_CASES],
    ids=[case[0] for case in STREAM_CASES],
)
def test_stream_operator(entry_point, body, inp, expect):
    _sorted_same(body, inp, entry_point, expect)


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_branch(entry_point):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"]([1, 2, 3, 4]))
        b = pkg["op"].branch("parity", s, lambda x: x % 2 == 0)
        evens, odds = [], []
        pkg["op"].output("evens", b.trues, pkg["Sink"](evens))
        pkg["op"].output("odds", b.falses, pkg["Sink"](odds))
        return flow, (evens, odds)

    want, got = run_both(build, entry_point)
    assert [sorted(x) for x in got] == [sorted(x) for x in want] == [[2, 4], [1, 3]]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_merge(entry_point):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        s1 = pkg["op"].input("inp1", flow, pkg["Source"]([1, 2]))
        s2 = pkg["op"].input("inp2", flow, pkg["Source"]([3, 4]))
        out = []
        pkg["op"].output("out", pkg["op"].merge("m", s1, s2), pkg["Sink"](out))
        return flow, out

    want, got = run_both(build, entry_point)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]


def _same_run_error(body, inp):
    """The flow must raise the same error, naming the same step, under
    both packages' ``run_main``."""
    errors = []
    for pkg in PKGS:
        flow, _out = _through(body, inp)(pkg)
        errors.append(raised(lambda pkg=pkg, flow=flow: pkg["run_main"](flow)))
    want, got = errors
    assert_same_error(want, got)
    assert neutral_notes(got) == neutral_notes(want)
    return got


@pytest.mark.parametrize(
    "body, inp, match",
    [
        (lambda pkg, s: pkg["op"].filter("bad", s, lambda x: x), [1], "must be a `?bool`?"),
        (
            lambda pkg, s: pkg["op"].stateful_map("sum", s, lambda st, v: (st, v)),
            [(1, 1)],
            "str",
        ),
        (
            lambda pkg, s: pkg["op"].stateful_map("sum", s, lambda st, v: (st, v)),
            [17],
            "2-tuple",
        ),
    ],
    ids=["filter_non_bool", "stateful_map_non_str_key", "stateful_map_not_2_tuple"],
)
def test_typed_errors(body, inp, match):
    got = _same_run_error(body, inp)
    assert isinstance(got, TypeError)
    with pytest.raises(TypeError, match=match):
        raise got


def test_raises_op():
    def body(pkg, s):
        pkg["op"].raises("raises", s)
        return s

    got = _same_run_error(body, [1])
    assert isinstance(got, RuntimeError) and "raises" in str(got)


def test_inspect(capsys):
    printed = []
    for pkg in PKGS:
        body = lambda pkg, s: pkg["op"].inspect("help", s)  # noqa: E731
        pkg["run_main"](_through(body, [0, 1, 2], flow_id="my_flow")(pkg)[0])
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    assert printed[1] == "my_flow.help: 0\nmy_flow.help: 1\nmy_flow.help: 2\n"


def test_inspect_debug_epoch_worker(capsys):
    printed = []
    for pkg in PKGS:
        body = lambda pkg, s: pkg["op"].inspect_debug("help", s)  # noqa: E731
        pkg["run_main"](_through(body, [0], flow_id="my_flow")(pkg)[0])
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] == "my_flow.help W0 @1: 0\n"


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_join(entry_point):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        left = pkg["op"].input("l", flow, pkg["Source"]([("a", 1)]))
        right = pkg["op"].input("r", flow, pkg["Source"]([("a", "x")]))
        out = []
        pkg["op"].output("out", pkg["op"].join("join", left, right), pkg["Sink"](out))
        return flow, out

    want, got = run_both(build, entry_point)
    assert got == want == [("a", (1, "x"))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_join_running(entry_point):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        left = pkg["op"].input(
            "l", flow, pkg["Source"]([("a", 1), ("a", 2)], batch_size=10)
        )
        right = pkg["op"].input("r", flow, pkg["Source"]([("a", "x")]))
        out = []
        j = pkg["op"].join("join", left, right, emit_mode="running")
        pkg["op"].output("out", j, pkg["Sink"](out))
        return flow, out

    want, got = run_both(build, entry_point)
    # Every update emits a row; a missing side is None.  Both drivers
    # poll the two inputs in the same order, so the rows agree.
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert ("a", (2, "x")) in got or ("a", (1, None)) in got
    assert len(got) >= 2


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_stateful_mid_batch_discard_continues(entry_point):
    # A discard mid-batch must not drop the remaining values for that
    # key in the same delivery batch.
    def discard_at_3(state, v):
        total = (state or 0) + v
        if total >= 3:
            return (None, total)
        return (total, total)

    body = lambda pkg, s: pkg["op"].stateful_map("sum", s, discard_at_3)  # noqa: E731
    inp = [("k", 1), ("k", 2), ("k", 3), ("k", 4)]
    want, got = run_both(_through(body, inp, batch_size=4), entry_point)
    assert got == want == [("k", 1), ("k", 3), ("k", 3), ("k", 4)]
