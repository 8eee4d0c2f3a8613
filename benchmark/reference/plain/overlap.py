# Frozen copy of fqtool_tpu_torch/ops/overlap.py, taken when the benchmark was
# written; the benchmark's reference imports nothing of the program.
"""Pair overlap analysis -- the plain PyTorch version.

Counterpart of ``fqtool_tpu/ops/overlap.py::analyze`` (reference:
src/overlapanalysis.cpp:7-72): read1 is compared against the reverse
complement of read2 at every candidate offset in parallel; the first offset
in the reference scan order (phase 1: 0..len1-require-1, then phase 2:
0,-1,..,require-len2+1) whose mismatch count over the first 50 compared
bases is below ``diff_limit`` wins (the collapsed acceptance predicate proven
in ``fqtool_tpu/ops/overlap.py``).  The full diff is then counted once, at
the selected offset.

On the GPU the same function is the CUDA kernel of ``overlap_cuda.py``;
``overlap_select.analyze`` picks between the two by the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import complement, first_true, positions, shift_rows

COMPLETE_COMPARE_REQUIRE = 50  # overlapanalysis.cpp:14


class OverlapResult(NamedTuple):
    overlapped: torch.Tensor   # bool [B]
    offset: torch.Tensor       # int32 [B]
    overlap_len: torch.Tensor  # int32 [B]
    diff: torch.Tensor         # int32 [B]


def reverse_complement(seq: torch.Tensor, rlen: torch.Tensor) -> torch.Tensor:
    """rc[b, i] = complement(seq[b, rlen-1-i]); positions at or past rlen hold
    wrapped garbage and must be masked by i < rlen."""
    L = seq.shape[1]
    return complement(shift_rows(seq.flip(1), L - rlen))


def _phase_scan50(head: torch.Tensor, moving: torch.Tensor, O: int,
                  ol: torch.Tensor, valid: torch.Tensor, diff_limit: int):
    """Accept/select over the first COMPLETE_COMPARE_REQUIRE compared bases:
    compares moving[b, o+i] vs head[b, i] for i < min(ol, 50) at every
    offset o < O; returns (found, first accepted offset, its overlap_len)."""
    d50 = torch.zeros(ol.shape, dtype=torch.int32, device=ol.device)
    for i in range(COMPLETE_COMPARE_REQUIRE):
        neq = moving[:, i : i + O] != head[:, i : i + 1]
        d50 += neq & (i < ol)
    hit = (d50 < diff_limit) & valid
    found = hit.any(dim=1)
    sel = first_true(hit, 0)
    ol_sel = torch.gather(ol, 1, sel[:, None].long())[:, 0]
    return found, sel, torch.where(found, ol_sel, 0)


def analyze(seq1: torch.Tensor, rlen1: torch.Tensor,
            seq2: torch.Tensor, rlen2: torch.Tensor,
            diff_limit: int, overlap_require: int) -> OverlapResult:
    """All-offsets overlap analysis of uint8 [B, L1] / [B, L2] pairs."""
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    L = max(L1, L2)
    W = COMPLETE_COMPARE_REQUIRE
    dev = seq1.device
    rlen1 = rlen1.to(torch.int32)
    rlen2 = rlen2.to(torch.int32)
    rs2 = F.pad(reverse_complement(seq2, rlen2), (0, L - L2))
    s1 = F.pad(seq1, (0, L - L1))
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    no = torch.zeros((B,), dtype=torch.bool, device=dev)

    def padded(x, O):
        return F.pad(x, (0, O + W))

    def head50(x):
        return F.pad(x, (0, W - L)) if L < W else x

    # ---- phase 1: offset o >= 0; compare s1[o+i] vs rs2[i] ----
    O1 = max(L1 - overlap_require, 0)
    if O1 > 0:
        o_ax = positions(O1, dev)
        ol1 = torch.minimum(rlen1[:, None] - o_ax, rlen2[:, None])
        valid1 = o_ax < (rlen1[:, None] - overlap_require)
        found1, o1, ol_sel1 = _phase_scan50(
            head50(rs2), padded(s1, O1), O1, ol1, valid1, diff_limit)
    else:
        found1, o1, ol_sel1 = no, zero, zero

    # ---- phase 2: offset o <= 0 (j = -o); compare s1[i] vs rs2[j+i] ----
    O2 = max(L2 - overlap_require, 0)
    if O2 > 0:
        j_ax = positions(O2, dev)
        ol2 = torch.minimum(rlen1[:, None], rlen2[:, None] - j_ax)
        valid2 = j_ax < (rlen2[:, None] - overlap_require)
        found2, j2, ol_sel2 = _phase_scan50(
            head50(s1), padded(rs2, O2), O2, ol2, valid2, diff_limit)
    else:
        found2, j2, ol_sel2 = no, zero, zero

    overlapped = found1 | found2
    offset = torch.where(found1, o1, -j2)
    overlap_len = torch.where(found1, ol_sel1, torch.where(found2, ol_sel2, 0))

    # full diff at the selected offset only: compare s1[i+max(o,0)] vs
    # rs2[i+max(-o,0)] for i < overlap_len (the compared span never wraps)
    g1 = shift_rows(s1, torch.clamp(offset, min=0))
    g2 = shift_rows(rs2, torch.clamp(-offset, min=0))
    diff = ((g1 != g2) & (positions(L, dev) < overlap_len[:, None])).sum(
        dim=1, dtype=torch.int32)

    offset = torch.where(overlapped, offset, 0)
    diff = torch.where(overlapped, diff, 0)
    return OverlapResult(overlapped, offset.to(torch.int32),
                         overlap_len.to(torch.int32), diff)
