"""Overlap-based base correction.

Counterpart of ``fqtool_tpu/ops/correct.py::correct_by_overlap`` (reference:
src/basecorrector.cpp:14-70): within the overlap, a mismatching base pair
where one side is >= Q30 and the other <= Q14 is overwritten with the
complemented high-quality base.  Each read's mate base is one gather at
``k - q`` (``k = start1 + start2``, the involution that pairs position ``q``
of one read with position ``k - q`` of the other).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import complement, positions
from .overlap import OverlapResult

GOOD_QUAL = 30 + 33  # util::num2qual(30), basecorrector.cpp:27
BAD_QUAL = 14 + 33   # util::num2qual(14), basecorrector.cpp:28

MAX_FIXES = 5  # diff <= 5 bounds corrections per pair (basecorrector.cpp:15)


class CorrectResult(NamedTuple):
    seq1: torch.Tensor
    qual1: torch.Tensor
    seq2: torch.Tensor
    qual2: torch.Tensor
    corrected1: torch.Tensor   # int32 [B] corrected bases in read1
    corrected2: torch.Tensor   # int32 [B] corrected bases in read2
    matrix: torch.Tensor       # int32 [64] correction from->to histogram
    # sparse patches for host-side record materialization (positions in the
    # front-aligned read coordinates; -1 = unused slot)
    pos1: torch.Tensor         # int32 [B, MAX_FIXES]
    new_seq1: torch.Tensor     # uint8 [B, MAX_FIXES]
    new_qual1: torch.Tensor    # uint8 [B, MAX_FIXES]
    pos2: torch.Tensor
    new_seq2: torch.Tensor
    new_qual2: torch.Tensor


def _sparse_patches(fix: torch.Tensor, new_seq: torch.Tensor,
                    new_qual: torch.Tensor, seq: torch.Tensor):
    """Up to MAX_FIXES corrected positions per row in descending order (-1
    padding), with the new (seq, qual) bytes and the base before correction.

    Five masked max reductions, as in ``fqtool_tpu``: a slot whose position
    is -1 takes the row-wide max of ``new_seq << 16 | new_qual << 8 | seq``
    (every position then matches), bytes past the read length included.
    Those dead-slot values are part of the pipeline's output, so they are
    reproduced, not left unspecified; every consumer masks by ``pos >= 0``."""
    cur = torch.where(fix, positions(fix.shape[1], fix.device), -1)
    packed = ((new_seq.to(torch.int32) << 16) | (new_qual.to(torch.int32) << 8)
              | seq.to(torch.int32))
    tops, vals = [], []
    for _ in range(MAX_FIXES):
        t = cur.max(dim=1).values
        hit = cur == t[:, None]
        tops.append(t)
        vals.append(torch.where(hit, packed, 0).max(dim=1).values)
        cur = torch.where(hit, -1, cur)
    v = torch.stack(vals, dim=1)
    return (torch.stack(tops, dim=1),
            ((v >> 16) & 0xFF).to(torch.uint8),
            ((v >> 8) & 0xFF).to(torch.uint8),
            v & 0xFF)


def _fix_side(seq, qual, mate_seq, mate_qual, mism, in_ov, active):
    """(fix mask, corrected seq, corrected qual) of one read."""
    fix = (active[:, None] & in_ov & mism
           & (mate_qual >= GOOD_QUAL) & (qual <= BAD_QUAL))
    return (fix, torch.where(fix, complement(mate_seq), seq),
            torch.where(fix, mate_qual, qual))


def correct_by_overlap(seq1, qual1, rlen1, seq2, qual2, rlen2,
                       ov: OverlapResult, eligible) -> CorrectResult:
    """``ov`` is the pair's overlap analysis; ``eligible`` [B] gates pairs
    (the caller passes pairs with both reads kept).  Pairs with diff == 0 or
    diff > 5 are skipped (basecorrector.cpp:15-17)."""
    L1, L2 = seq1.shape[1], seq2.shape[1]
    dev = seq1.device
    active = eligible & (ov.diff != 0) & (ov.diff <= 5)
    start1 = torch.clamp(ov.offset, min=0)
    start2 = rlen2 - torch.clamp(-ov.offset, min=0) - 1
    k = (start1 + start2)[:, None]

    # read1 position q in [start1, start1 + ol) pairs with read2 position
    # k - q; out of the overlap the clamped index reads a base no fix uses
    q1 = positions(L1, dev)
    in_ov1 = (q1 >= start1[:, None]) & (q1 < (start1 + ov.overlap_len)[:, None])
    idx1 = (k - q1).clamp(0, L2 - 1).long()
    mate_seq1, mate_qual1 = torch.gather(seq2, 1, idx1), torch.gather(qual2, 1, idx1)
    fix1, new_seq1, new_qual1 = _fix_side(
        seq1, qual1, mate_seq1, mate_qual1, seq1 != complement(mate_seq1),
        in_ov1, active)

    # read2 position j in (start2 - ol, start2] pairs with read1 position
    # k - j (read1 before its corrections)
    q2 = positions(L2, dev)
    in_ov2 = (q2 <= start2[:, None]) & (q2 > (start2 - ov.overlap_len)[:, None])
    idx2 = (k - q2).clamp(0, L1 - 1).long()
    mate_seq2, mate_qual2 = torch.gather(seq1, 1, idx2), torch.gather(qual1, 1, idx2)
    fix2, new_seq2, new_qual2 = _fix_side(
        seq2, qual2, mate_seq2, mate_qual2, mate_seq2 != complement(seq2),
        in_ov2, active)

    pos1, ns1, nq1, frm1 = _sparse_patches(fix1, new_seq1, new_qual1, seq1)
    pos2, ns2, nq2, frm2 = _sparse_patches(fix2, new_seq2, new_qual2, seq2)

    # correction matrix (from & 7) * 8 + (to & 7) over the live patch slots
    # (filterresult.cpp:122-126)
    key = torch.cat([(frm1 & 7) * 8 + (ns1 & 7).to(torch.int32),
                     (frm2 & 7) * 8 + (ns2 & 7).to(torch.int32)], dim=1)
    live = torch.cat([pos1, pos2], dim=1) >= 0
    matrix = torch.zeros((64,), dtype=torch.int32, device=dev).index_add_(
        0, key.reshape(-1).long(), live.reshape(-1).to(torch.int32))

    return CorrectResult(new_seq1, new_qual1, new_seq2, new_qual2,
                         fix1.sum(dim=1, dtype=torch.int32),
                         fix2.sum(dim=1, dtype=torch.int32), matrix,
                         pos1, ns1, nq1, pos2, ns2, nq2)
