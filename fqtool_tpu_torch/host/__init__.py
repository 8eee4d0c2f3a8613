"""Host side of the port.

``filterresult``, ``report_json`` and ``report_html`` are jax-free copies of
their ``fqtool_tpu.host`` counterparts.  The jax-free host modules of
``fqtool_tpu`` are used as they are; the two that a driver of the port reads
directly are named here: ``native`` (whether the native FASTQ core loaded)
and ``tracing`` (the host stage timings of ``FQTOOL_TPU_TRACE=1``).
"""

from fqtool_tpu.host import tracing
from fqtool_tpu.io import native

__all__ = ["native", "tracing"]
