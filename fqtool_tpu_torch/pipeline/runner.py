"""Host-side runtime helpers shared by the runners.

Copied from ``fqtool_tpu/pipeline/runner.py`` (which imports JAX at module
level): the failed-stream tag catalog, the chunk-size buckets, the
pipelined drain of dispatched chunks, the index filter and the log line.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..ops.filters import FAILED_TYPES

# tag catalog for failed-stream suffixes: one buffer + per-code offsets
_TAG_BUF = b"".join(t.encode() for t in FAILED_TYPES)
_TAG_LEN = np.array([len(t) for t in FAILED_TYPES], np.int32)
_TAG_OFF = np.zeros(len(FAILED_TYPES), np.int64)
np.cumsum(_TAG_LEN[:-1], out=_TAG_OFF[1:])


def drain_pipelined(pending):
    """Iterate dispatched chunks ``(..., call)`` yielding ``(..., out)`` with
    chunk k+1's device->host fetch running in a background thread while the
    caller folds chunk k."""
    if len(pending) <= 1:
        for item in pending:
            yield item[:-1] + (item[-1].get(),)
        return
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(pending[0][-1].get)
        for k, item in enumerate(pending):
            out = fut.result()
            if k + 1 < len(pending):
                fut = ex.submit(pending[k + 1][-1].get)
            yield item[:-1] + (out,)
    finally:
        # join the in-flight fetch even on error/abandonment: the
        # non-daemon worker would otherwise block interpreter exit
        ex.shutdown(wait=True)


# Fixed device batch sizes: a pack's chunks all use one of these row counts
# (fqtool_tpu sizes its compiled programs by them; kept so that the chunk
# boundaries, and with them the output framing, are the same here)
_BUCKETS = (256, 2048, 8192, 16384, 32768)


def chunk_rows(pack_total: int, cap: int) -> int:
    """Device batch size for a pack of ``pack_total`` rows: ``cap`` for packs
    larger than every bucket, else the smallest bucket that holds them."""
    for b in _BUCKETS:
        if pack_total <= b and b <= cap:
            return b
    return cap


def loginfo(msg: str) -> None:
    sys.stderr.write(time.strftime("[%H:%M:%S] ") + msg + "\n")


def index_filter_matches(opt, pack, blacklist) -> np.ndarray:
    """Vectorized per-read blacklist match of firstIndex()
    (reference: src/filter.cpp:213-232)."""
    from fqtool_tpu.host.names import (first_index_batch, index_match_batch,
                                       name_matrix)

    nb, no, nl = pack.name_arrays()
    mat = name_matrix(nb, no, nl)
    s, t = first_index_batch(mat, nl)
    return index_match_batch(blacklist, mat, s, t, opt.index_filter.threshold)
