"""FASTQ records built from planes, in bulk.

A record is ``name\\n seq\\n +\\n qual\\n`` with ``seq`` and ``qual`` the
first ``length`` bytes of a row, built in bulk with no Python loop over
records.
"""

from __future__ import annotations

import numpy as np


def format_records(names: np.ndarray, name_keep: np.ndarray, seq: np.ndarray,
                   qual: np.ndarray, length: np.ndarray) -> bytes:
    """The records of every row: the name the bytes of ``names`` (uint8
    [n, Wn]) where ``name_keep`` is set, the read the first ``length`` bytes
    of ``seq``/``qual``.
    Each row is laid out at full width and the unused bytes are masked out,
    so one boolean selection gives the records in order."""
    n, L = seq.shape
    if n == 0:
        return b""
    Wn = names.shape[1]
    W = Wn + 1 + L + 3 + L + 1
    rec = np.empty((n, W), np.uint8)
    keep = np.ones((n, W), bool)
    cols = np.arange(L)[None, :]
    rec[:, :Wn] = names
    keep[:, :Wn] = name_keep
    rec[:, Wn] = ord("\n")
    p = Wn + 1
    rec[:, p : p + L] = seq
    keep[:, p : p + L] = cols < length[:, None]
    rec[:, p + L : p + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    p += L + 3
    rec[:, p : p + L] = qual
    keep[:, p : p + L] = keep[:, Wn + 1 : Wn + 1 + L]
    rec[:, -1] = ord("\n")
    return rec[keep].tobytes()


def digits(values: np.ndarray, width: int):
    """uint8 [n, width] decimal digits of ``values``, right-aligned, and the
    mask of the digits a number prints (no leading zeros; 0 prints one)."""
    v = values.astype(np.int64)
    out = np.empty((len(v), width), np.uint8)
    for c in range(width):
        out[:, c] = (v // 10 ** (width - 1 - c)) % 10 + 48
    ndig = 1 + sum((v >= 10 ** k).astype(np.int64) for k in range(1, width))
    return out, np.arange(width)[None, :] >= (width - ndig)[:, None]


def split_records(data: bytes) -> list:
    """The 4-line records of a FASTQ byte string."""
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [b"\n".join(lines[i : i + 4]) for i in range(0, len(lines), 4)]


def records_differ(got: bytes, want: bytes) -> int:
    """How many records of ``want`` are missing from ``got`` or differ,
    position by position, plus any that ``got`` has beyond them."""
    if got == want:
        return 0
    a, b = split_records(got), split_records(want)
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
