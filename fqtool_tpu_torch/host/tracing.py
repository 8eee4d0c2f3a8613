# Copy of fqtool_tpu/host/tracing.py without device_profile, which imports
# jax.profiler.
"""Structured per-stage timing.

The reference's only observability is timestamped stderr logs
(reference: src/util.h:469-478 loginfo calls at stage transitions); here every
pipeline stage is timed into a process-wide registry, dumped at exit when
``FQTOOL_TPU_TRACE=1``.  Copy of ``fqtool_tpu/host/tracing.py`` without its
JAX ``device_profile``: device time comes from ``torch.profiler``
(``chip_smoke.py``).
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

_ENABLED = os.environ.get("FQTOOL_TPU_TRACE", "") == "1"

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
# stages are also recorded from the prefetch/writer threads (tokenize,
# pack_encode, gzip_out): those names sum THREAD time, not main-loop wall
_lock = threading.Lock()


@contextmanager
def stage(name: str):
    """Time a pipeline stage; no-op overhead when tracing is disabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def reset() -> None:
    """Zero the stage registry (bench.py resets after warm-up runs so the
    dumped split reflects steady state, not JIT compilation)."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _marks.clear()


_marks: Dict[str, float] = {}


def mark(name: str) -> None:
    """Record a wall-clock phase timestamp (multi-host phase attribution:
    landed in the FQTOOL_TPU_TIMING_JSON file, main.py)."""
    with _lock:
        _marks[name] = time.time()


def marks() -> Dict[str, float]:
    with _lock:
        return dict(_marks)


def snapshot() -> Dict[str, Dict[str, float]]:
    """Current {stage: {seconds, calls}} view (bench_details.json)."""
    with _lock:
        return {k: {"seconds": round(v, 3), "calls": _counts[k]}
                for k, v in _totals.items()}


def dump() -> None:
    with _lock:  # background threads may still be recording at exit
        totals = dict(_totals)
        counts = dict(_counts)
    if not totals:
        return
    total = sum(totals.values())
    sys.stderr.write("=== fqtool_tpu stage timing ===\n")
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        sys.stderr.write(
            f"{name:>24}: {t:8.3f}s  ({counts[name]:6d} calls, "
            f"{100.0 * t / total:5.1f}%)\n")


if _ENABLED:
    atexit.register(dump)

