# Copy of fqtool_tpu/host/names.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Vectorized read-name operations.

Batch equivalents of the per-read name string work in the reference --
``Read::firstIndex`` (reference: src/read.h:106-123), the index-blacklist
hamming match (``Filter::match``, src/filter.cpp:191-211), and ragged
byte-span assembly used by the UMI tagger.  Names live as (offset, length)
spans over a flat buffer; these helpers lift them into a zero-padded byte
matrix once per pack and operate on whole columns.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def name_matrix(buf: bytes, off: np.ndarray, nlen: np.ndarray) -> np.ndarray:
    """[B, W] zero-padded byte matrix of the name spans."""
    B = len(off)
    W = max(int(nlen.max(initial=0)), 1)
    if B == 0 or not buf:
        return np.zeros((B, W), np.uint8)
    from ..io import native
    if native.get_lib() is not None:
        # the native span packer row-memcpys at C speed (the numpy fancy
        # gather below costs ~1s per 131k-read pack on a slow vCPU)
        spans = dict(seq_off=off.astype(np.int64), seq_len=nlen.astype(np.int32),
                     qual_off=off.astype(np.int64))
        mat, _ = native.pack_spans(buf, spans, W, False)
        return mat
    arr = np.frombuffer(buf, np.uint8)
    idx = np.minimum(off[:, None] + np.arange(W, dtype=np.int64)[None, :],
                     len(buf) - 1)
    mat = arr[idx]
    return np.where(np.arange(W)[None, :] < nlen[:, None], mat, 0).astype(np.uint8)


def first_index_batch(mat: np.ndarray, nlen: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (start, length) of ``firstIndex()`` within the name matrix.

    reference: src/read.h:106-123 -- scan right-to-left from n-3: every '+'
    moves the end to just before it; the first ':' returns
    ``substr(colon+1, end-colon)``.  Rows with no ':' (or shorter than 5)
    return an empty span.
    """
    B, W = mat.shape
    nlen = nlen.astype(np.int64)
    pos = np.arange(W, dtype=np.int64)[None, :]
    scanable = pos <= (nlen[:, None] - 3)
    colon = (mat == ord(":")) & scanable
    has_colon = colon.any(axis=1)
    ci = W - 1 - np.argmax(colon[:, ::-1], axis=1)  # rightmost ':'
    plus = (mat == ord("+")) & scanable & (pos > ci[:, None])
    has_plus = plus.any(axis=1)
    pi = np.argmax(plus, axis=1)  # leftmost '+' right of the colon
    end = np.where(has_plus, pi - 1, nlen)
    start = ci + 1
    length = np.minimum(end + 1, nlen) - start  # substr clamps at n
    ok = has_colon & (nlen >= 5)
    start = np.where(ok, start, 0).astype(np.int64)
    length = np.where(ok, np.maximum(length, 0), 0).astype(np.int64)
    return start, length


def index_match_batch(blacklist: Sequence[str], mat: np.ndarray,
                      start: np.ndarray, tlen: np.ndarray,
                      threshold: int) -> np.ndarray:
    """Hamming-prefix blacklist match per row (src/filter.cpp:191-211):
    diff over the first min(len(entry), tlen) characters; diff <= threshold
    matches (an empty target matches everything)."""
    B, W = mat.shape
    matched = np.zeros(B, bool)
    for entry in blacklist:
        e = np.frombuffer(entry.encode("latin-1"), np.uint8)
        L = len(e)
        if L == 0:
            matched[:] = True
            break
        cmp_len = np.minimum(L, tlen)[:, None]
        idx = np.clip(start[:, None] + np.arange(L, dtype=np.int64)[None, :],
                      0, W - 1)
        window = np.take_along_axis(mat, idx, axis=1)
        neq = (window != e[None, :]) & (np.arange(L)[None, :] < cmp_len)
        matched |= neq.sum(axis=1) <= threshold
    return matched


def copy_spans(dst: np.ndarray, dst_off: np.ndarray,
               src_flat: np.ndarray, src_off: np.ndarray,
               plens: np.ndarray) -> None:
    """Vectorized ragged copy: dst[dst_off[i] : +plens[i]] =
    src_flat[src_off[i] : +plens[i]] for every row.

    Native memcpy-per-row when the extension is available (~8x the numpy
    formulation, which pays arange/repeat int64 index vectors per byte --
    this sits on the UMI name-rewrite path of every pack)."""
    from ..io.native import copy_spans_native

    if dst.flags.c_contiguous and src_flat.flags.c_contiguous and \
            copy_spans_native(
                dst, np.ascontiguousarray(dst_off, np.int64),
                src_flat, np.ascontiguousarray(src_off, np.int64),
                np.ascontiguousarray(plens, np.int64)):
        return
    sel = plens > 0
    if not sel.any():
        return
    L = plens[sel].astype(np.int64)
    total = int(L.sum())
    csum = np.cumsum(L)
    local = np.arange(total, dtype=np.int64) - np.repeat(csum - L, L)
    dst[np.repeat(dst_off[sel].astype(np.int64), L) + local] = \
        src_flat[np.repeat(src_off[sel].astype(np.int64), L) + local]


class RaggedBuilder:
    """Assemble per-row byte strings from a sequence of variable-length
    pieces; each piece is (flat source array, per-row source offset,
    per-row length)."""

    def __init__(self, B: int):
        self.B = B
        self.pieces: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def add(self, src_flat: np.ndarray, src_off: np.ndarray,
            plens: np.ndarray) -> None:
        self.pieces.append((src_flat, np.broadcast_to(src_off, (self.B,)),
                            np.broadcast_to(plens, (self.B,))))

    def add_matrix(self, mat: np.ndarray, start: np.ndarray,
                   plens: np.ndarray) -> None:
        W = mat.shape[1]
        off = np.arange(self.B, dtype=np.int64) * W + start
        self.add(np.ascontiguousarray(mat).reshape(-1), off, plens)

    def add_const(self, data: bytes, where: np.ndarray) -> None:
        """Constant piece present on rows where ``where`` is true."""
        flat = np.frombuffer(data, np.uint8)
        self.add(flat, np.zeros(self.B, np.int64),
                 np.where(where, len(data), 0).astype(np.int64))

    def build(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(flat uint8 buffer, per-row offsets int64, per-row lengths int64)."""
        lens = np.zeros(self.B, np.int64)
        for _, _, plens in self.pieces:
            lens = lens + plens
        off = np.zeros(self.B, np.int64)
        np.cumsum(lens[:-1], out=off[1:])
        out = np.empty(int(lens.sum()), np.uint8)
        cursor = off.copy()
        for src_flat, src_off, plens in self.pieces:
            copy_spans(out, cursor, src_flat, src_off, plens.astype(np.int64))
            cursor = cursor + plens
        return out, off, lens
