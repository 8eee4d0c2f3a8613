# Copy of fqtool_tpu/host/accounting.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Bulk (vectorized) adapter-trim accounting.

Replaces the per-trimmed-read Python loops of the fold path with one
``np.unique`` pass per chunk: adapter spans are gathered into a zero-padded
``[k, maxlen]`` byte matrix (sequence bytes are ASCII and never 0, so the
padding cannot collide with content), distinct rows are counted in C, and
only the handful of DISTINCT adapter strings ever touch Python.  Semantics
mirror ``FilterResult::addAdapterTrimmed`` (reference:
src/filterresult.cpp:138-177): empty adapters are skipped.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def span_counts(mat: np.ndarray, rows: np.ndarray, starts: np.ndarray,
                lens: np.ndarray) -> Counter:
    """Counter {adapter bytes: count} over the spans
    ``mat[rows[k], starts[k] : starts[k] + lens[k]]``.  Zero/negative-length
    spans contribute nothing (the reference skips empty adapters)."""
    c: Counter = Counter()
    if len(rows) == 0:
        return c
    lens = np.maximum(np.asarray(lens, np.int64), 0)
    m = int(lens.max(initial=0))
    if m == 0:
        return c
    starts = np.asarray(starts, np.int64)
    cols = starts[:, None] + np.arange(m, dtype=np.int64)[None, :]
    valid = np.arange(m)[None, :] < lens[:, None]
    np.clip(cols, 0, mat.shape[1] - 1, out=cols)
    g = np.where(valid, mat[np.asarray(rows)[:, None], cols], 0).astype(np.uint8)
    uniq, counts = np.unique(g, axis=0, return_counts=True)
    for row, cnt in zip(uniq, counts):
        a = row.tobytes().rstrip(b"\x00")
        if a:
            c[a] += int(cnt)
    return c


def suffix_counts(adapter: bytes, starts: np.ndarray) -> Counter:
    """Counter for the negative-position case ``adapter[start:]`` (the match
    began inside the adapter constant, adaptertrimmer.cpp semantics)."""
    c: Counter = Counter()
    if len(starts) == 0:
        return c
    for s, n in zip(*np.unique(np.asarray(starts, np.int64),
                               return_counts=True)):
        a = adapter[int(s):]
        if a:
            c[a] += int(n)
    return c
