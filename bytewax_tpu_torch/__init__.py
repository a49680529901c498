"""bytewax_tpu_torch: the bytewax_tpu stream processor on PyTorch and
CUDA.

The same ``Dataflow``/operator API, host tier and recovery protocol as
``bytewax_tpu``, with a device tier of PyTorch tensors on an NVIDIA
GPU: recognized keyed aggregations fold each micro-batch with a
hand-written CUDA kernel (``csrc/segment_fold.cu``).  The port grows
slice by slice (``ROADMAP.md``); it imports neither ``jax`` nor
``bytewax_tpu``.
"""

__version__ = "0.1.0"
