"""Host side of the port.

Every module here but two is a copy of its ``fqtool_tpu.host`` counterpart
with only its imports changed, beside the copies of ``config/`` and
``io/``: the port imports nothing of ``fqtool_tpu``.  ``profile`` is the
device profile on torch.profiler, and ``tracing`` is the port's own span
tracing (``FQTOOL_TPU_TRACE=1``: nested host stages with thread CPU time,
and the card's fed and unfed time).  The two that a caller of the port reads
directly are named here: ``native`` (whether the native FASTQ core loaded)
and ``tracing``.
"""

from . import tracing
from ..io import native

__all__ = ["native", "tracing"]
