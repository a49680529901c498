"""The control: the plain reference put in the program's place and
computed in bfloat16, one precision below the configurations'
float32, must come out not correct; in float32 and float64 it must
pass.  On the CPU at a tiny size here; the ``cuda`` case runs it on
the card at the cells' own sizes."""

import pytest

from portbench import run
from portbench.tests.tiny import ROOT, TINY, overrides
from portbench.tools import control

# Blocks a 50 s run hands over on the H100 (PERF.md's runs: about
# 2,500 to 2,800 batches, 100 to 116 files).
CELL_BLOCKS = {
    "brc-10k.columnar": 2700,
    "brc-10k.text": 108,
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_and_the_reference_passes(cell):
    low = control.read(cell, 31, 24, "cpu", overrides=overrides(cell))
    assert low["dtype"] == "bfloat16" and not low["correct"]
    assert low["checks"]["minmax_err_deci"]["value"] > low["checks"]["minmax_err_deci"]["limit"]
    for dtype in ("float32", "float64"):
        assert control.read(cell, 31, 24, "cpu", dtype, overrides=overrides(cell))["correct"]


def test_the_control_knows_only_the_precisions_it_can_lower():
    ref = run.find_cell(ROOT, "brc-10k.columnar").reference("lower_precision")
    assert ref.lower_precision({"precision": "float32"}) == "bfloat16"
    assert ref.lower_precision({"precision": "float64"}) == "float32"
    with pytest.raises(ValueError, match="precision"):
        ref.lower_precision({"precision": "int8"})


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_BLOCKS))
def test_the_control_fails_on_the_card_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (3000000001, 3000000002, 3000000003):
        got = control.read(cell, seed, CELL_BLOCKS[cell], "cuda")
        assert not got["correct"], got
        assert got["checks"]["mean_err"]["value"] > got["checks"]["mean_err"]["limit"]
