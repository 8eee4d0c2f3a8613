"""One fqtool job as a fresh process, as a lab runs one per sample.

    python3 benchmark/child.py --stamp <file> [--profile] -- <fqtool argv>

Imports the program, opens the CUDA context, stamps the time (the end of
start-up), then runs ``fqtool_tpu_torch.main.main`` on the argv, as
``python -m fqtool_tpu_torch.main`` would, and exits with its code.  The
stamp file gets the start-up stamp, the peak device memory, the program's
stage trace (when ``FQTOOL_TPU_TRACE=1``), the modules of the JAX package
or of JAX that the process holds once the job has ended (``run.py`` refuses
a run where there are any) and, with ``--profile``, the device record of a
``torch.profiler`` session around the job.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path


def main() -> int:
    args = sys.argv[1:]
    sep = args.index("--")
    own, argv = args[:sep], args[sep + 1 :]
    stamp = Path(own[own.index("--stamp") + 1])
    profile = "--profile" in own

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    from fqtool_tpu_torch.host import tracing
    from fqtool_tpu_torch.main import main as port_main

    on_card = os.environ.get("FQTOOL_TPU_TORCH_DEVICE", "cuda").startswith("cuda")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device="cuda:0")
    out = {"t_main": time.time()}
    prof = None
    if profile and on_card:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    rc = port_main(argv)
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
        from run import device_events, reduce_events
        out["device"] = reduce_events(device_events(prof))
    from run import forbidden_modules
    out["forbidden"] = forbidden_modules()
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(0) if on_card else 0
    out["stages"] = tracing.snapshot()
    stamp.write_text(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
