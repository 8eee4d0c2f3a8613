# Copy of fqtool_tpu/host/umi.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""UMI extraction and read-name tagging.

Host-side port of ``UmiProcessor`` (reference: src/umiprocessor.cpp): extracts
the UMI from index fields or read prefixes, appends ``OX:Z:``/``BZ:Z:`` tags at
the first space of the name, and reports per-read front-trim lengths for the
device pipeline (trimFront clamps to len-1, read.h:192-197).

``process_umi`` is fully vectorized (ragged byte assembly over the pack
matrices -- no per-read Python work); ``process_umi_scalar`` is the direct
per-read port kept as the behavioral reference for tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config.options import (Options, UMI_LOC_INDEX1, UMI_LOC_INDEX2,
                              UMI_LOC_PER_INDEX, UMI_LOC_PER_READ,
                              UMI_LOC_READ1, UMI_LOC_READ2)
from .names import RaggedBuilder, first_index_batch, name_matrix


def first_index(name: bytes) -> bytes:
    """reference: src/read.h:106-123"""
    n = len(name)
    end = n
    if n < 5:
        return b""
    for i in range(n - 3, -1, -1):
        c = name[i : i + 1]
        if c == b"+":
            end = i - 1
        if c == b":":
            return name[i + 1 : i + 1 + (end - i)]
    return b""


def _add_tag(name: bytes, tag: bytes, drop_other_comment: bool) -> bytes:
    """reference: src/umiprocessor.cpp:78-89"""
    pos = name.find(b" ")
    if pos < 0:
        return name + tag
    if drop_other_comment:
        return name[:pos] + tag
    return name[:pos] + tag + name[pos:]


def _trim_start(lens: np.ndarray, length: int, skip: int) -> np.ndarray:
    """trimFront(length + skip) clamped to len-1, never negative
    (read.h:192-197)."""
    return np.maximum(0, np.minimum(length + skip, lens - 1)).astype(np.int32)


def _rewrite_names(pack, tag_flat, tag_off, tag_len, drop: bool) -> None:
    """new_name = name[:space] + tag + name[space:] per row (tag absent rows
    keep the name verbatim; drop_other_comment removes the comment only on
    tagged rows, umiprocessor.cpp:78-89)."""
    B = pack.count
    nb, no, nl = pack.name_arrays()
    nl64 = nl.astype(np.int64)
    mat = name_matrix(nb, no, nl)
    W = mat.shape[1]
    space = (mat == 32) & (np.arange(W)[None, :] < nl64[:, None])
    has_space = space.any(axis=1)
    spos = np.argmax(space, axis=1)
    pre = np.where(has_space, spos, nl64)
    has_tag = tag_len > 0
    keep_post = has_space if not drop else (has_space & ~has_tag)
    post = np.where(keep_post, nl64 - pre, 0)

    nb_flat = np.frombuffer(nb, np.uint8)
    b = RaggedBuilder(B)
    b.add(nb_flat, no.astype(np.int64), pre)
    b.add(tag_flat, tag_off, tag_len)
    b.add(nb_flat, no.astype(np.int64) + pre, post)
    buf, off, lens = b.build()
    pack.set_name_arrays(buf.tobytes(), off, lens)


def process_umi(opt: Options, pack1, pack2=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Apply UMI processing to one (pair of) pack(s) in place (vectorized).

    Rewrites the pack name arrays and returns per-read front-trim offsets
    (start0) for read1 and read2 (None when unpaired).
    """
    B = pack1.count
    start1 = np.zeros(B, np.int32)
    start2 = np.zeros(B, np.int32) if pack2 is not None else None
    if not opt.umi.enabled or B == 0:
        return start1, start2

    loc = opt.umi.location
    length = opt.umi.length
    skip = opt.umi.skip
    trim = not opt.umi.not_trim_read
    pe = pack2 is not None

    l1 = pack1.lens.astype(np.int64)
    l2 = pack2.lens.astype(np.int64) if pe else None
    W1 = pack1.seq.shape[1]
    W2 = pack2.seq.shape[1] if pe else 0
    zeros = np.zeros(B, np.int64)

    # ---- UMI / quality content pieces per location -------------------
    # each: (matrix, per-row start, per-row len) or a constant byte string
    umi_pieces = []
    qua_pieces = []
    if loc == UMI_LOC_INDEX1:
        nb, no, nl = pack1.name_arrays()
        m = name_matrix(nb, no, nl)
        s, n = first_index_batch(m, nl)
        umi_pieces.append((m, s, n))
    elif loc == UMI_LOC_INDEX2:
        if pe:
            nb, no, nl = pack2.name_arrays()
            m = name_matrix(nb, no, nl)
            s, n = first_index_batch(m, nl)
            umi_pieces.append((m, s, n))
    elif loc == UMI_LOC_READ1:
        n1 = np.minimum(l1, length)
        umi_pieces.append((pack1.seq, zeros, n1))
        qua_pieces.append((pack1.qual, zeros, n1))
        if trim:
            start1 = _trim_start(l1, length, skip)
    elif loc == UMI_LOC_READ2:
        if pe:
            n2 = np.minimum(l2, length)
            umi_pieces.append((pack2.seq, zeros, n2))
            # the reference bounds read2's quality by READ1's length
            # (umiprocessor.cpp:37) -- quirk preserved; slice clamps at the
            # pack width like read_qual does
            qua_pieces.append((pack2.qual, zeros,
                               np.minimum(np.minimum(l1, length), W2)))
            if trim:
                start2 = _trim_start(l2, length, skip)
    elif loc == UMI_LOC_PER_INDEX:
        nb, no, nl = pack1.name_arrays()
        m1 = name_matrix(nb, no, nl)
        s1, n1 = first_index_batch(m1, nl)
        umi_pieces.append((m1, s1, n1))
        if pe:
            nb2, no2, nl2 = pack2.name_arrays()
            m2 = name_matrix(nb2, no2, nl2)
            s2, n2 = first_index_batch(m2, nl2)
            umi_pieces.append(b"-")
            umi_pieces.append((m2, s2, n2))
    elif loc == UMI_LOC_PER_READ:
        n1 = np.minimum(l1, length)
        umi_pieces.append((pack1.seq, zeros, n1))
        qua_pieces.append((pack1.qual, zeros, n1))
        if trim:
            start1 = _trim_start(l1, length, skip)
        if pe:
            n2 = np.minimum(l2, length)
            umi_pieces.append(b"-")
            umi_pieces.append((pack2.seq, zeros, n2))
            if trim:
                start2 = _trim_start(l2, length, skip)
            # read2's quality is extracted AFTER both trimFront calls and
            # bounded by the TRIMMED read1 length (umiprocessor.cpp:55-60)
            qlen2 = np.minimum(l1 - start1.astype(np.int64), length)
            qlen2 = np.minimum(qlen2, W2 - start2.astype(np.int64))
            qua_pieces.append(b"-")
            qua_pieces.append((pack2.qual, start2.astype(np.int64),
                               np.maximum(qlen2, 0)))

    def piece_len(p):
        return (np.full(B, len(p), np.int64) if isinstance(p, bytes)
                else p[2].astype(np.int64))

    umi_len = sum((piece_len(p) for p in umi_pieces), np.zeros(B, np.int64))
    qua_len = sum((piece_len(p) for p in qua_pieces), np.zeros(B, np.int64))
    has_umi = umi_len > 0                 # tag appended at all
    has_qua = has_umi & (qua_len > 0)     # BZ section appended

    tb = RaggedBuilder(B)
    tb.add_const(b" OX:Z:", has_umi)
    for p in umi_pieces:
        if isinstance(p, bytes):
            tb.add_const(p, np.ones(B, bool))
        else:
            tb.add_matrix(p[0], p[1].astype(np.int64), p[2].astype(np.int64))
    tb.add_const(b" BZ:Z:", has_qua)
    for p in qua_pieces:
        if isinstance(p, bytes):
            tb.add_const(p, has_qua)
        else:
            tb.add_matrix(p[0], p[1].astype(np.int64),
                          np.where(has_qua, p[2], 0).astype(np.int64))
    tag_flat, tag_off, tag_len = tb.build()

    drop = bool(opt.umi.drop_other_comment)
    _rewrite_names(pack1, tag_flat, tag_off, tag_len, drop)
    if pe:
        _rewrite_names(pack2, tag_flat, tag_off, tag_len, drop)
    return start1, start2


def process_umi_scalar(opt: Options, pack1, pack2=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Direct per-read port (behavioral reference for the vectorized path)."""
    B = pack1.count
    start1 = np.zeros(B, np.int32)
    start2 = np.zeros(B, np.int32) if pack2 is not None else None
    if not opt.umi.enabled:
        return start1, start2

    loc = opt.umi.location
    length = opt.umi.length
    skip = opt.umi.skip
    trim = not opt.umi.not_trim_read

    for i in range(B):
        umi = b" OX:Z:"
        qua = b" BZ:Z:"
        l1 = int(pack1.lens[i])
        l2 = int(pack2.lens[i]) if pack2 is not None else 0
        if loc == UMI_LOC_INDEX1:
            umi += first_index(pack1.names[i])
        elif loc == UMI_LOC_INDEX2:
            if pack2 is not None:
                umi += first_index(pack2.names[i])
        elif loc == UMI_LOC_READ1:
            n = min(l1, length)
            umi += pack1.read_seq(i, 0, n)
            qua += pack1.read_qual(i, 0, n)
            if trim:
                start1[i] = max(0, min(length + skip, l1 - 1))
        elif loc == UMI_LOC_READ2:
            if pack2 is not None:
                n = min(l2, length)
                umi += pack2.read_seq(i, 0, n)
                # note the reference uses read1's length in the min here
                # (umiprocessor.cpp:37) -- quirk preserved
                qua += pack2.read_qual(i, 0, min(l1, length))
                if trim:
                    start2[i] = max(0, min(length + skip, l2 - 1))
        elif loc == UMI_LOC_PER_INDEX:
            umi += first_index(pack1.names[i])
            if pack2 is not None:
                umi += b"-" + first_index(pack2.names[i])
        elif loc == UMI_LOC_PER_READ:
            n1 = min(l1, length)
            umi += pack1.read_seq(i, 0, n1)
            qua += pack1.read_qual(i, 0, n1)
            if trim:
                start1[i] = max(0, min(length + skip, l1 - 1))
            if pack2 is not None:
                n2 = min(l2, length)
                umi += b"-" + pack2.read_seq(i, 0, n2)
                if trim:
                    start2[i] = max(0, min(length + skip, l2 - 1))
                # read2's quality is extracted AFTER both trimFront calls and
                # bounded by the TRIMMED read1 length (umiprocessor.cpp:55-60)
                l1_trimmed = l1 - int(start1[i])
                qua += b"-" + pack2.read_qual(i, int(start2[i]),
                                              min(l1_trimmed, length))

        tag = umi
        if len(tag) > 6 and len(qua) > 6:
            tag = tag + qua
        if len(tag) > 6:
            pack1.names[i] = _add_tag(pack1.names[i], tag, opt.umi.drop_other_comment)
            if pack2 is not None:
                pack2.names[i] = _add_tag(pack2.names[i], tag, opt.umi.drop_other_comment)
    return start1, start2
