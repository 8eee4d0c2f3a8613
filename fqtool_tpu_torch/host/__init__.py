"""Host side of the port.

Every module here is a copy of its ``fqtool_tpu.host`` counterpart with only
its imports changed (``tracing`` also without its JAX ``device_profile``),
beside the copies of ``config/`` and ``io/``: the port imports nothing of
``fqtool_tpu``.  The two that a caller of the port reads directly are named
here: ``native`` (whether the native FASTQ core loaded) and ``tracing`` (the
host stage timings of ``FQTOOL_TPU_TRACE=1``).
"""

from . import tracing
from ..io import native

__all__ = ["native", "tracing"]
