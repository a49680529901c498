"""BTX-BACKEND positive fixture: a standalone script that starts the
engine with no backend forced first."""

from bytewax_tpu_torch.dataflow import Dataflow

flow = Dataflow("fixture")

if __name__ == "__main__":
    from bytewax_tpu_torch.testing import run_main

    run_main(flow)
