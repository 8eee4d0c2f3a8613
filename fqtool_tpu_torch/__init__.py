"""fqtool_tpu_torch: the PyTorch/CUDA port of fqtool_tpu.

Same CLI and the same records and reports as ``fqtool_tpu``; the per-read
device stages run as PyTorch tensor code, and the overlap analysis as a
hand-written CUDA kernel on the GPU (``csrc/overlap.cu``).  The host side
(configuration, FASTQ I/O, evaluators, accumulators) is the package's own
copy of the jax-free modules of ``fqtool_tpu``: this package imports
nothing of ``fqtool_tpu`` and never imports JAX.
"""

__version__ = "0.1.0"
