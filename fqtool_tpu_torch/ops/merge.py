"""Pair merging.

Counterpart of ``fqtool_tpu/ops/merge.py::merge_pairs`` (reference:
src/overlapanalysis.cpp:74-104): merged = r1[0 : len1] ++
revcomp(r2)[ol : ol + len2], with ``len1 = ol + max(0, offset)`` and
``len2 = rlen2 - ol`` when offset > 0, else 0.  The merged name (with its
off-by-one quirk) is built on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import complement, positions
from .overlap import OverlapResult


class MergeResult(NamedTuple):
    seq: torch.Tensor     # uint8 [B, L1 + L2]
    qual: torch.Tensor    # uint8 [B, L1 + L2]
    rlen: torch.Tensor    # int32 [B] merged length (len1 + len2)
    len1: torch.Tensor    # int32 [B] bases taken from read1
    len2: torch.Tensor    # int32 [B] bases taken from revcomp(read2)


def merge_pairs(seq1, qual1, rlen1, seq2, qual2, rlen2,
                ov: OverlapResult) -> MergeResult:
    """Positions at or past the merged length hold bytes that differ from
    ``fqtool_tpu``'s (there, wrapped bytes of its barrel shift); every
    consumer masks them by ``rlen``."""
    L2 = seq2.shape[1]
    ol = ov.overlap_len
    len1 = ol + torch.clamp(ov.offset, min=0)
    len2 = torch.where(ov.offset > 0, rlen2 - ol, 0)
    pos = positions(seq1.shape[1] + L2, seq1.device)
    # merged[i] for i >= len1 is revcomp(r2)[ol + i - len1]
    #                          = complement(r2[rlen2 - 1 - ol - i + len1])
    idx = ((rlen2 - 1 - ol + len1)[:, None] - pos).clamp(0, L2 - 1).long()
    from_r1 = pos < len1[:, None]
    mseq = torch.where(from_r1, F.pad(seq1, (0, L2)),
                       complement(torch.gather(seq2, 1, idx)))
    mqual = torch.where(from_r1, F.pad(qual1, (0, L2)), torch.gather(qual2, 1, idx))
    return MergeResult(mseq, mqual, (len1 + len2).to(torch.int32),
                       len1.to(torch.int32), len2.to(torch.int32))
