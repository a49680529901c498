"""The hot swap across a 2-process cluster, in the JAX package and in
the torch port: the counterpart of
``tests/test_infer.py::test_cluster_2proc_swap_agreed_close``.

Every process records the same pending params update at start-up; the
swap must land at one cluster-agreed epoch close, so each worker's
first item scores with the old params and its second with the new.
The same flow module (the reference's, its imports rewritten for the
port) runs through each package's ``testing`` spawner on the CPU.  It
sits in a file of its own so that ``--dist loadfile`` runs it beside
the other inference cases, not behind them.
"""

import subprocess
from pathlib import Path

from tests.test_infer import _CLUSTER_FLOW
from tests.test_torch_both import BOTH, for_pkg


def _cluster_swap(m, tmp_path):
    root = tmp_path / m.label
    root.mkdir()
    out_path = root / "out.txt"
    flow_py = root / "cluster_infer_flow.py"
    flow_py.write_text(for_pkg(_CLUSTER_FLOW, m).replace("@OUT_PATH@", repr(str(out_path))))
    res = subprocess.run(
        m.module_cmd("testing", f"{flow_py}:flow", "-p", "2", "-s", "0.1"),
        env=m.child_env(),
        cwd=root,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return sorted(Path(out_path).read_text().split())


def test_cluster_2proc_swap_agreed_close(tmp_path):
    """Every worker's first item scored before the swap and its second
    after it, on both processes (a one-sided swap would leave a
    ``w*=10.0`` second item), in both packages."""
    want, got = (_cluster_swap(m, tmp_path) for m in BOTH)
    assert want == ["w0=10.0", "w0=200.0", "w1=10.0", "w1=200.0"]
    assert got == want
