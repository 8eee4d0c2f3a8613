"""Adapter trimming by a given sequence, written for the benchmark's
reference from the semantics of fqtool's ``AdapterTrimmer::trimBySequence``
(src/adaptertrimmer.cpp:29-90, as SURVEY.md section 2 states them); not a
copy of the program's operation.

The candidate positions run from ``start`` (-4, -3, -2 or 0 for adapters of
at least 16, 12, 8 or fewer bases) while ``pos < rlen - 4``.  At each, the
adapter's bases ``i`` in ``[max(0, -pos), cmplen)`` are compared with the
read's base ``pos + i``, ``cmplen = min(rlen - pos, alen)``, and the
position matches with at most ``cmplen / 8`` mismatches.  The first match
wins: at ``pos >= 0`` the read is cut to ``pos`` bases, at ``pos < 0`` it
is emptied.  The loop runs over the positions, every read at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MATCH_REQUIRED = 4
ONE_MISMATCH_EACH = 8


class AdapterTrim(NamedTuple):
    rlen: torch.Tensor   # int64 [B] the length after the trim
    found: torch.Tensor  # bool [B] a position matched
    pos: torch.Tensor    # int64 [B] the position that matched (0 where none)


def scan_start(alen: int) -> int:
    if alen >= 16:
        return -4
    if alen >= 12:
        return -3
    if alen >= 8:
        return -2
    return 0


def trim_by_sequence(seq: torch.Tensor, rlen: torch.Tensor,
                     adapter: bytes) -> AdapterTrim:
    """The trim of each row of ``seq`` (uint8 [B, L]) within its length
    ``rlen`` by the ASCII ``adapter``."""
    B, L = seq.shape
    dev = seq.device
    rlen = rlen.to(torch.int64)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    alen = len(adapter)
    if alen < MATCH_REQUIRED:
        return AdapterTrim(rlen, found, pos)
    ad = torch.tensor(list(adapter), dtype=torch.uint8, device=dev)
    i = torch.arange(alen, device=dev)
    for p in range(scan_start(alen), L - MATCH_REQUIRED):
        cmplen = (rlen - p).clamp(max=alen)
        compared = (i[None, :] >= max(0, -p)) & (i[None, :] < cmplen[:, None])
        read = seq[:, (i + p).clamp(0, L - 1)]
        mismatch = ((read != ad[None, :]) & compared).sum(1)
        hit = ~found & (p < rlen - MATCH_REQUIRED) \
            & (mismatch <= torch.div(cmplen, ONE_MISMATCH_EACH,
                                     rounding_mode="floor"))
        pos = torch.where(hit, torch.full_like(pos, p), pos)
        found = found | hit
    new = torch.where(found, pos.clamp(min=0), rlen)
    return AdapterTrim(new, found, pos)
