"""BTX-BACKEND positive fixture: a standalone script that binds a CUDA
context before it chooses the device tier's platform.

``torch.cuda.is_available`` is a probe and creates no context; the
``set_device`` under it does, and it runs before the script pops
``BYTEWAX_TPU_PLATFORM``.
"""

import os

import torch

from bytewax_tpu_torch.dataflow import Dataflow

flow = Dataflow("fixture")

if __name__ == "__main__":
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    from bytewax_tpu_torch.testing import run_main

    run_main(flow)
