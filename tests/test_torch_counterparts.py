"""Every case of the JAX package's inference, scan, columnar and
doctest test files has a counterpart among the port's tests, which runs
both packages on the same input.

A reference case's counterpart is the port test of the same name, or
the one :data:`RENAMED` names where the port's test carries another
name (``jax_*`` cases become ``torch_*``; several cases that one
parametrized port test covers).  This test reads the files' source, so
a reference case added without a counterpart fails it.
"""

import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

#: Reference test files held case by case.
REFERENCE_FILES = ("test_infer.py", "test_scan_accel.py", "test_xla.py", "test_doctests.py")

#: ``reference file::case`` -> ``port file::test`` where the names differ.
RENAMED = {
    "test_infer.py::test_infer_matches_host_oracle": "test_torch_infer.py::test_infer_matches_reference",
    "test_infer.py::test_infer_multi_feature_tuple_output": "test_torch_infer.py::test_infer_matches_reference",
    "test_infer.py::test_infer_host_knob_forces_host_apply":
        "test_torch_infer.py::test_host_apply_knob_never_runs_the_device_apply",
    "test_infer.py::test_anomaly_infer_flow_matches_bespoke_oracle":
        "test_torch_infer.py::test_anomaly_infer_flow_matches",
    "test_infer.py::test_infer_resume_restores_params_and_keyed_state":
        "test_torch_infer.py::test_params_snapshot_resumes",
    "test_infer.py::test_infer_hot_swap_lands_at_epoch_close":
        "test_torch_infer.py::test_update_params_swaps_at_epoch_close",
    "test_infer.py::test_infer_demotion_preserves_swapped_params":
        "test_torch_infer.py::test_demotion_carries_swapped_params_to_host_apply",
    "test_scan_accel.py::test_annotation_marks_scan_spec": "test_torch_scan.py::test_scan_flow_matches_reference",
    "test_scan_accel.py::test_unknown_scanmap_kind_stays_host_tier":
        "test_torch_scan.py::test_annotation_leaves_other_mappers_on_the_host",
    "test_scan_accel.py::test_unmarked_mapper_not_annotated":
        "test_torch_scan.py::test_annotation_leaves_other_mappers_on_the_host",
    "test_scan_accel.py::test_scan_state_snapshot_roundtrip": "test_torch_scan.py::test_scan_state_matches_reference",
    "test_scan_accel.py::test_ema_kind_matches_host_oracle": "test_torch_scan.py::test_scan_flow_matches_reference",
    "test_scan_accel.py::test_extrema_kind_matches_host_oracle":
        "test_torch_scan.py::test_scan_flow_matches_reference",
    "test_scan_accel.py::test_zscore_generic_kernel_matches_specialized":
        "test_torch_scan.py::test_generic_zscore_matches_specialized",
    "test_scan_accel.py::test_jax_stateful_map_matches_host_oracle":
        "test_torch_scan.py::test_scan_flow_matches_reference",
    "test_scan_accel.py::test_jax_stateful_map_cross_tier_snapshot":
        "test_torch_scan_accel.py::test_torch_stateful_map_cross_tier_snapshot",
    "test_scan_accel.py::test_jax_stateful_map_bool_state_cross_tier_snapshot":
        "test_torch_scan.py::test_torch_stateful_map_bool_state_snapshots",
    "test_scan_accel.py::test_jax_stateful_map_rejects_bad_fns_at_construction":
        "test_torch_scan.py::test_torch_stateful_map_rejects_bad_fns_at_construction",
}

_DEF = re.compile(r"^def (test_\w+)", re.MULTILINE)


def _cases(path: Path):
    return _DEF.findall(path.read_text())


def _port_tests():
    """Every port test function, by name, with the files that hold it."""
    where = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        for name in _cases(path):
            where.setdefault(name, set()).add(path.name)
    return where


@pytest.mark.parametrize("ref_file", REFERENCE_FILES)
def test_every_reference_case_has_a_counterpart(ref_file):
    port = _port_tests()
    missing = []
    for case in _cases(TESTS / ref_file):
        renamed = RENAMED.get(f"{ref_file}::{case}")
        if renamed is None:
            if case not in port:
                missing.append(case)
            continue
        port_file, port_case = renamed.split("::")
        if port_file not in port.get(port_case, ()):
            missing.append(f"{case} (renamed {renamed})")
    assert not missing, f"{ref_file}: cases with no counterpart: {missing}"


def test_renamed_entries_name_reference_cases():
    """No entry of :data:`RENAMED` outlives its reference case."""
    stale = [
        key for key in RENAMED if key.split("::")[1] not in _cases(TESTS / key.split("::")[0])
    ]
    assert not stale
