"""Adapter trimming by a given sequence.

Counterpart of ``fqtool_tpu/ops/adapter.py`` (reference:
src/adaptertrimmer.cpp:29-90): every candidate position, from the negative
start of long adapters to ``L-1``, is scored at once, one shifted compare per
adapter base accumulated in int32, and the first accepted position in the
reference's scan order wins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import first_true, positions

MATCH_REQUIRED = 4           # adaptertrimmer.cpp:30
ALLOW_ONE_MISMATCH_EACH = 8  # adaptertrimmer.cpp:31


def adapter_start(alen: int) -> int:
    """Scan start offset by adapter length (adaptertrimmer.cpp:45-51)."""
    if alen >= 16:
        return -4
    if alen >= 12:
        return -3
    if alen >= 8:
        return -2
    return 0


class AdapterTrimResult(NamedTuple):
    rlen: torch.Tensor   # int32 [B] new length (0 when pos < 0 empties the read)
    found: torch.Tensor  # bool [B]
    pos: torch.Tensor    # int32 [B] matched position (may be negative)


def trim_by_sequence(seq: torch.Tensor, rlen: torch.Tensor,
                     adapter: bytes) -> AdapterTrimResult:
    """``adapter`` is the ASCII adapter sequence."""
    B, L = seq.shape
    dev = seq.device
    alen = len(adapter)
    if alen < MATCH_REQUIRED:
        return AdapterTrimResult(rlen, torch.zeros((B,), dtype=torch.bool, device=dev),
                                 torch.zeros((B,), dtype=torch.int32, device=dev))

    start = adapter_start(alen)
    P = L - start  # candidate positions start .. L-1
    pos_axis = positions(P, dev) + start
    # column c of seq_pad holds read index c + start
    seq_pad = F.pad(seq, (-start, alen))
    room = rlen[:, None] - pos_axis  # read bases from each position on
    # mism[b, pos] = #{i in [max(0, -pos), cmplen): adapter[i] != seq[b, pos + i]}
    mism = torch.zeros((B, P), dtype=torch.int32, device=dev)
    for i, base in enumerate(adapter):
        neq = (seq_pad[:, i : i + P] != base) & (room > i)
        if i < -start:
            neq &= pos_axis >= -i
        mism += neq
    cmplen = torch.clamp(room, max=alen)
    accepted = ((mism <= torch.div(cmplen, ALLOW_ONE_MISMATCH_EACH, rounding_mode="floor"))
                & (room > MATCH_REQUIRED))  # pos < rlen - matchRequired
    found = accepted.any(dim=1)
    pos = first_true(accepted, 0) + start
    # pos < 0 empties the read (adaptertrimmer.cpp:72-78); else truncate
    new_rlen = torch.where(found, torch.clamp(pos, min=0), rlen)
    return AdapterTrimResult(new_rlen.to(torch.int32), found, pos.to(torch.int32))
