"""Transport auto-tuning.

Counterpart of ``fqtool_tpu/host/linkprobe.py``.  The packed one-byte
transport (ops/packed.py) halves host->device upload bytes at the cost of
one host encode pass; whether that trades well depends on the attachment.
``use_packed()`` decides once per process with fqtool_tpu's rules:
``FQTOOL_TPU_PACKED=1/0`` forces the choice, otherwise a one-shot 4 MiB
probe of the upload to the run's device enables packing below
``PACKED_THRESHOLD_MBPS``.  A card on PCIe or NVLink reads far above it, so
packing stays off there unless forced.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

PACKED_THRESHOLD_MBPS = 200.0
_PROBE_BYTES = 4 << 20
_PROBE_ROUNDS = 5

_cached: bool | None = None


def _probe_mbps(device) -> float:
    """Estimated host->device upload bandwidth in MB/s to ``device``.

    Packing only reduces upload bytes, so the gate measures H2D alone: an
    upload of a pageable 4 MiB buffer followed by its download, minus a
    download of the same device buffer, each the fastest of
    ``_PROBE_ROUNDS`` into buffers allocated beforehand (a single reading
    on a busy host is noise).  Every leg ends in a synchronize of the
    card.  A CPU device is the host's own memory: no link, so no finite
    rate (a timed copy there measures the host's thread pool)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return float("inf")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    host = torch.from_numpy(np.ones((_PROBE_BYTES,), np.uint8))
    back = torch.empty_like(host)
    on_dev = torch.empty(_PROBE_BYTES, dtype=torch.uint8, device=dev)
    # warm the transfer path (context, staging buffers, page mappings)
    back.copy_(on_dev.copy_(host))
    sync()
    up_down, down = [], []
    for _ in range(_PROBE_ROUNDS):
        t0 = time.perf_counter()
        on_dev.copy_(host)
        back.copy_(on_dev)  # upload + download
        sync()
        t1 = time.perf_counter()
        back.copy_(on_dev)  # download only
        sync()
        t2 = time.perf_counter()
        up_down.append(t1 - t0)
        down.append(t2 - t1)
    up = max(min(up_down) - min(down), 1e-9)
    return (_PROBE_BYTES / (1 << 20)) / up


def use_packed(device="cuda") -> bool:
    """True when seq+qual chunks should ride the packed one-byte transport
    to ``device``."""
    global _cached
    env = os.environ.get("FQTOOL_TPU_PACKED", "")
    if env == "1":
        return True
    if env == "0":
        return False
    if _cached is None:
        try:
            mbps = _probe_mbps(device)
        except Exception:
            _cached = False
            return False
        _cached = mbps < PACKED_THRESHOLD_MBPS
        if _cached:
            sys.stderr.write(
                f"[fqtool_tpu_torch] link probe {mbps:.0f} MB/s upload -> "
                "packed transport enabled\n")
    return _cached
