"""Overlap-analysis dispatch by device.

A CPU tensor goes to the plain PyTorch version (``overlap.analyze``); a CUDA
tensor goes to the hand-written kernel (``overlap_cuda.analyze_cuda``), which
raises if it cannot be built or launched.  There is no probe and no fallback.
"""

from __future__ import annotations

from . import overlap, overlap_cuda


def analyze(seq1, rlen1, seq2, rlen2, diff_limit, overlap_require):
    if seq1.is_cuda:
        return overlap_cuda.analyze_cuda(seq1.contiguous(), rlen1.contiguous(),
                                         seq2.contiguous(), rlen2.contiguous(),
                                         diff_limit, overlap_require)
    return overlap.analyze(seq1, rlen1, seq2, rlen2, diff_limit, overlap_require)
