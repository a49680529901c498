"""``KeyEncoder`` (string keys to dense ids, ``engine/arrays.py``) of
the JAX package and of the torch port: the counterparts of the three
``test_key_encoder_*`` cases of ``tests/test_xla.py``, each run on both
packages' encoders with the same inputs.  The ids must be equal, and
the seen-key table ``_sorted`` must have the same dtype kind and
itemsize after every step."""

import numpy as np

from bytewax_tpu.engine.arrays import KeyEncoder as RefKeyEncoder
from bytewax_tpu_torch.engine.arrays import KeyEncoder as PortKeyEncoder


def _never(ks):
    raise ZeroDivisionError("a seen key was allocated again")


def _counter():
    next_id = iter(range(100))
    return lambda ks: [next(next_id) for _ in ks]


def _table(enc):
    """The seen-key table's (dtype kind, itemsize), or None."""
    return None if enc._sorted is None else (enc._sorted.dtype.kind, enc._sorted.dtype.itemsize)


def _empty_first_batch(enc):
    steps = [enc.encode(np.array([], dtype=object), lambda ks: []).tolist()]
    tables = [_table(enc)]
    steps.append(enc.encode(np.array(["a", "b", "a"]), lambda ks: [10, 11]).tolist())
    tables.append(_table(enc))
    # Steady state: no allocation for seen keys.
    steps.append(enc.encode(np.array(["b", "a"]), _never).tolist())
    return steps, tables


def _wide_column_fast_path(enc):
    alloc = _counter()
    steps = [enc.encode(np.array(["a", "b"], dtype="U1"), alloc).tolist()]
    tables = [_table(enc)]
    # An over-wide batch: hits keep their ids; "ab" misses (no
    # truncation against the narrow "a") and gets a fresh id.
    steps.append(enc.encode(np.array(["b", "ab", "a"], dtype="U8"), alloc).tolist())
    tables.append(_table(enc))
    steps.append(enc.encode(np.array(["ab", "a", "b"], dtype="U21"), _never).tolist())
    tables.append(_table(enc))
    return steps, tables


def _many_keys_still_narrow(enc):
    keys = np.array([f"k{i}" for i in range(40)])
    steps = [enc.encode(keys, lambda ks: list(range(len(ks)))).tolist()]
    steps.append(enc.encode(keys.astype("U30"), _never).tolist())
    return steps, [_table(enc)]


def _same(run, want_ids, want_tables):
    want = run(RefKeyEncoder())
    got = run(PortKeyEncoder())
    assert want == (want_ids, want_tables)
    assert got == want


def test_key_encoder_empty_first_batch():
    """An empty delivery installs no seen-key table; later batches
    take the steady-state path with no allocation."""
    _same(_empty_first_batch, [[], [10, 11, 10], [11, 10]], [None, ("U", 4)])


def test_key_encoder_wide_column_fast_path():
    """With few seen keys an over-wide column is searched as it is;
    prefix collisions and misses stay exact across widths, and a miss
    installs at its true width."""
    _same(_wide_column_fast_path, [[0, 1], [1, 2, 0], [2, 0, 1]], [("U", 4), ("U", 8), ("U", 8)])


def test_key_encoder_many_keys_still_narrow():
    """Above the wide-search threshold the narrowing path runs and
    stays exact."""
    _same(_many_keys_still_narrow, [list(range(40)), list(range(40))], [("U", 12)])
