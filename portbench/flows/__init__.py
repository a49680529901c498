"""Builders of the port's flows, one module per flow (``<flow>.py``,
loaded by the name a cell file gives).  A flow module has
``build(source, sinks, cfg, params)``, the port's dataflow, and
``fold_bytes(stream, blocks, spec)``, the logical bytes its device
fold moves over the blocks a run handed over (see ``roofline``)."""
