"""Nothing the harness runs loads JAX or the JAX package, and the
references load nothing of the program."""

import json
import subprocess
import sys

from portbench.tests.tiny import ROOT

_RUN = """
import json, sys
from portbench import run
from portbench.tests.tiny import ROOT, SECONDS, overrides
for cell in ("brc-10k.columnar", "brc-10k.text"):
    run.run_cell(ROOT, cell, 5, SECONDS, True, device="cpu", overrides=overrides(cell))
print(json.dumps({"bad": run.forbidden_modules(),
                  "tops": sorted({m.split(".", 1)[0] for m in sys.modules})}))
"""

_REF = """
import json, sys
from portbench import run
from portbench.tests.tiny import ROOT
for name in ("brc-10k",):
    run.load_module(ROOT / "portbench" / "reference" / f"{name}.py", name)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _child(code: str):
    env = {"PATH": "/usr/bin:/bin", "BYTEWAX_TPU_PLATFORM": "cpu", "HOME": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _child(_RUN)
    assert got["bad"] == []
    assert "bytewax_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "bytewax_tpu"} & set(got["tops"])


def test_the_references_load_nothing_of_the_program():
    tops = set(_child(_REF))
    assert not {"jax", "jaxlib", "flax", "bytewax_tpu", "bytewax_tpu_torch"} & tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "bytewax_tpu_torch_extra", sys)
    assert "bytewax_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bytewax_tpu.engine", sys)
    assert run.forbidden_modules() == ["bytewax_tpu"]
