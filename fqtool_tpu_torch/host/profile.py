"""Device profile of a run: ``FQTOOL_TPU_PROFILE_DIR``.

Counterpart of ``device_profile`` in ``fqtool_tpu/host/tracing.py``.  When
the variable names a directory, the run loop (single-end and paired-end)
runs under torch.profiler, host activity and, when the run's devices include
a card, its device activity, and the trace is written there as a Chrome
trace (``fqtool_tpu_torch.<pid>.trace.json``, readable by chrome://tracing
and Perfetto).  While the profile runs, every host stage
(``host/tracing.py::stage``) opens a ``record_function`` of its name, so the
trace shows the stages above the kernels on one timeline.  The variable is
read when the run starts.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path

from . import tracing


@contextmanager
def device_profile(devices=("cpu",)):
    """Profile the enclosed block when FQTOOL_TPU_PROFILE_DIR is set."""
    out_dir = os.environ.get("FQTOOL_TPU_PROFILE_DIR", "")
    if not out_dir:
        yield
        return
    import torch

    on_card = any(torch.device(d).type == "cuda" for d in devices)
    act = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        act.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=act) as prof:
        tracing.set_profiling(True)
        try:
            yield
            if on_card:
                torch.cuda.synchronize()
        finally:
            tracing.set_profiling(False)
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / f"fqtool_tpu_torch.{os.getpid()}.trace.json"))
