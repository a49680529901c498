"""The hand-written segment-fold kernel against its plain PyTorch
version, on the card.

Marked ``cuda``: without a CUDA card every case skips (the kernel has
no CPU mode; the CPU tests hold the plain version to the JAX package).
This file imports neither ``jax`` nor ``bytewax_tpu``, so it runs on a
machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Values are multiples of 0.5 and the packed scale is 0.5, so every
float32 sum here is exact in any order and the kernel must match the
plain version exactly, atomics or not.
"""

import numpy as np
import pytest
import torch

from bytewax_tpu_torch.ops import fold_kernel
from bytewax_tpu_torch.ops import segment as seg

SCALE = 0.5
N_ROWS = 1 << 16


def _inputs(capacity: int, integer: bool, dev):
    rng = np.random.RandomState(capacity)
    n_map = min(capacity, 20000)
    ext_to_slot = rng.randint(0, capacity - 1, size=n_map).astype(np.int32)
    ext_to_slot[rng.rand(n_map) < 0.1] = capacity - 1  # unseen ids
    ext_to_slot[-1] = capacity - 1  # the sentinel
    slots = rng.randint(0, capacity, size=N_ROWS).astype(np.int32)  # scratch too
    ids = rng.randint(0, n_map, size=N_ROWS).astype(np.int32)
    q = rng.randint(-999, 1000, size=N_ROWS).astype(np.int16)
    vals = rng.randint(-2000, 2000, size=N_ROWS)
    vals = vals.astype(np.int32) if integer else (vals * 0.5).astype(np.float32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return {
        "ext_to_slot": t(ext_to_slot),
        "slots": t(slots),
        "ext16": t(ids.astype(np.int16)),
        "ext32": t(ids),
        "packed": t(np.stack([ids.astype(np.int16), q])),
        "vals": t(vals),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1024, 16384])
@pytest.mark.parametrize("source", ["slot", "ext16", "ext32", "packed"])
@pytest.mark.parametrize("integer", [False, True], ids=["float32", "int32"])
def test_kernel_matches_plain_on_card(integer, source, capacity):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    dev = torch.device("cuda")
    dtype = torch.int32 if integer else torch.float32
    inp = _inputs(capacity, integer, dev)
    if source == "slot":
        slots, vals = inp["slots"], inp["vals"]
    elif source == "packed":
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0])
        vals = seg.dequantize(inp["packed"], SCALE)
    else:
        slots, vals = seg.slots_of(inp["ext_to_slot"], inp[source]), inp["vals"]
    for kind_name, kind in seg.AGG_KINDS.items():
        got = seg.init_fields(kind, capacity, dtype, dev)
        # Start from a table that already holds state.
        seg.fold_plain(kind, got, inp["slots"], inp["vals"])
        want = {k: v.clone() for k, v in got.items()}
        before = fold_kernel.launches
        if source == "slot":
            seg.update_fields(kind, got, slots, vals)
        elif source == "packed":
            seg.update_fields_packed(
                kind, got, inp["ext_to_slot"], inp["packed"], SCALE
            )
        else:
            seg.update_fields_vocab(
                kind, got, inp["ext_to_slot"], inp[source], inp["vals"]
            )
        assert fold_kernel.launches == before + 1
        seg.fold_plain(kind, want, slots, vals)
        torch.cuda.synchronize()
        for name in kind.fields:
            assert torch.equal(got[name], want[name]), f"{kind_name}/{name}"
