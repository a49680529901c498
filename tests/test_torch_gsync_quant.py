"""The cluster-wide tier's quantized gsync exchange through the torch
port, two processes of ``python -m bytewax_tpu_torch.testing -p 2`` on
the CPU (gloo): the cases of ``tests/test_cluster.py`` that hold the
quantized partial exchange to its bounds and its device merge to the
host fold.  On the CPU the device merge is the merge kernel's plain
version (``engine/xla.py`` ``agg_merge``); ``tests/test_torch_agg_merge.py``
holds it to the JAX package's program and ``test_torch_kernel_cuda.py``
the kernel to it on the card.
"""

import os

import pytest
from test_torch_global_exchange import gx_paced_oracle, run_gx_paced

from bytewax_tpu_torch.utils import force_platform


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_cluster_gsync_quant_bounds_and_exact_counts(tmp_path, quant):
    """BYTEWAX_TPU_GSYNC_QUANT: counts exactly the exact tier's, floats
    within the codec's bounds, with overlap or without.  (The two runs
    are not compared with each other: the split of rows into rounds
    depends on the wall clock, so the quantization error does too.)"""
    env = {"GX_PACE_S": "0.1", "GX_BATCHES": "3", "BYTEWAX_TPU_GSYNC_QUANT": quant}
    got, stderr = run_gx_paced(tmp_path, f"gx_{quant}", env)
    assert f"[{quant}, device merge]" in stderr
    both, _ = run_gx_paced(tmp_path, f"gx_{quant}_ovl", dict(env, BYTEWAX_TPU_GSYNC_OVERLAP="1"))
    oracle = gx_paced_oracle(batches=3)
    assert set(got) == set(oracle)
    assert set(both) == set(oracle)
    for k, (mn, mean, mx, count) in oracle.items():
        gmn, gmean, gmx, gcount = got[k]
        assert gcount == count  # counts exact, always
        assert both[k][3] == count  # under overlap too
        # min/max partials: one value a key a round, so the error never
        # accumulates: one quantization step of the block max (values
        # span up to ~1400).
        tol = (1400.0 / 254.0) if quant == "int8" else 1400.0 * 2.0**-8
        assert abs(gmn - mn) <= tol, (k, quant)
        assert abs(gmx - mx) <= tol, (k, quant)
        # sum partials take one quantization error a round.
        assert abs(gmean - mean) <= 0.05 * max(abs(mean), 1.0), (k, quant)


def test_cluster_gsync_quant_device_merge_matches_host_fold(tmp_path):
    """The device merge against the host fold (``BYTEWAX_TPU_WIRE=
    pickle`` pins it): on an all-integer workload every column rides the
    exact path, so int32 tables and the host's float64 fold agree bit
    for bit, and both equal the host oracle."""
    env = {
        "GX_PACE_S": "0.1",
        "GX_BATCHES": "3",
        "GX_INTS": "1",
        "BYTEWAX_TPU_GSYNC_QUANT": "int8",
        "BYTEWAX_TPU_GSYNC_OVERLAP": "1",
    }
    device, dev_err = run_gx_paced(tmp_path, "gx_devmerge", env)
    host, host_err = run_gx_paced(tmp_path, "gx_hostmerge", dict(env, BYTEWAX_TPU_WIRE="pickle"))
    assert "[int8, device merge]" in dev_err and "device merge" not in host_err
    assert "[int8, host merge]" in host_err
    assert device == host
    oracle = gx_paced_oracle(batches=3)
    assert set(device) == set(oracle)
    for k, (mn, mean, mx, count) in oracle.items():
        assert device[k][0] == mn and device[k][2] == mx
        assert device[k][3] == count
        assert abs(device[k][1] - mean) < 1e-9
