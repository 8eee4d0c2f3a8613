"""PolyG tail trimming, written for the benchmark's reference from the
semantics of fqtool's ``PolyX::trimPolyG`` (src/polyx.cpp:14-38, as
SURVEY.md section 2 states them); not a copy of the program's operation.

The scan walks each read from its 3' end, one position a step for every
read at once: step ``i`` reads base ``rlen - 1 - i``, counts a non-G as a
mismatch and remembers the last G it passed (``firstGpos``, ``rlen - 1``
until one is seen).  It stops at the first step whose mismatches exceed
``min(maxMismatch, max(1, (i + 1) / each))``, or after the read's last
base (``i = rlen``).  Where the scanned length ``i + 1`` reaches
``compareReq`` the read is cut to ``firstGpos`` bases and the trim is
recorded as G with ``rlen - firstGpos`` bases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

G = ord("G")


class PolyGTrim(NamedTuple):
    rlen: torch.Tensor      # int64 [B] the length after the trim
    trimmed: torch.Tensor   # bool [B] the trim was recorded
    trim_len: torch.Tensor  # int64 [B] the bases it recorded


def trim_polyg(seq: torch.Tensor, rlen: torch.Tensor, compare_req: int,
               max_mismatch: int, each: int) -> PolyGTrim:
    """The polyG trim of each row of ``seq`` (uint8 [B, L]) within its
    length ``rlen``."""
    B, L = seq.shape
    rlen = rlen.to(torch.int64)
    mismatch = torch.zeros(B, dtype=torch.int64, device=seq.device)
    first_g = rlen - 1
    stop = rlen.clone()  # the step at which the scan ended
    running = torch.ones(B, dtype=torch.bool, device=seq.device)
    for i in range(L):
        running = running & (rlen > i)
        at = (rlen - 1 - i).clamp(min=0)
        is_g = seq.gather(1, at[:, None])[:, 0] == G
        mismatch += (running & ~is_g).long()
        first_g = torch.where(running & is_g, at, first_g)
        allowed = min(max_mismatch, max(1, (i + 1) // each))
        broke = running & (mismatch > allowed)
        stop = torch.where(broke, torch.full_like(stop, i), stop)
        running = running & ~broke
    trimmed = stop + 1 >= compare_req
    # a resize to a negative length leaves the read as it was
    new = torch.where(trimmed & (first_g >= 0), first_g, rlen)
    return PolyGTrim(new, trimmed, rlen - first_g)
