"""PolyG / polyX tail trimming.

Counterpart of ``fqtool_tpu/ops/polyx.py`` (reference: src/polyx.cpp:14-101).
Both scan from the 3' end with a growing mismatch budget
``min(maxMismatch, max(1, (i+1)/each))`` and trigger when the scanned length
(break position + 1) reaches ``compareReq``.  The scan runs over the flipped
rows, where column q holds position L-1-q and the scanned index is
``i = q - (L - rlen)``; the per-base tallies of polyX are plain int32
cumsums along that axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import A, C, G, N, T, first_true, last_true, positions


class PolyTrimResult(NamedTuple):
    rlen: torch.Tensor      # int32 [B] new length
    trimmed: torch.Tensor   # bool [B] a trim event was recorded
    trim_len: torch.Tensor  # int32 [B] bases recorded by addPolyXTrimmed
    base_idx: torch.Tensor  # int32 [B] 0..4 = A/T/C/G/N index recorded


def _scan_frame(seq: torch.Tensor, rlen: torch.Tensor):
    """(flipped seq, scanned index per column, scan mask)."""
    L = seq.shape[1]
    iq = positions(L, seq.device) - (L - rlen)[:, None]
    return seq.flip(1), iq, iq >= 0


def _allowed_mismatch(iq: torch.Tensor, max_mismatch: int, each: int) -> torch.Tensor:
    steps = torch.div(iq + 1, each, rounding_mode="floor")
    return torch.clamp(steps, min=1).clamp(max=max_mismatch)


def trim_polyg(seq: torch.Tensor, rlen: torch.Tensor, compare_req: int,
               max_mismatch: int, each: int) -> PolyTrimResult:
    """reference: src/polyx.cpp:14-38.  The event (base index 3 = G, length
    ``rlen - firstGpos``) is recorded whenever the scanned length reaches
    compareReq, even when the resize is a no-op (firstGpos < 0)."""
    B, L = seq.shape
    rev, iq, mask = _scan_frame(seq, rlen)
    is_g = (rev == G) & mask
    mm = torch.cumsum((~is_g & mask).to(torch.int32), dim=1, dtype=torch.int32)
    allowed = _allowed_mismatch(iq, max_mismatch, each)
    # break at the first scanned i with mismatches > allowed; else i = rlen
    q_star = first_true((mm > allowed) & mask, L)
    i_star = q_star - (L - rlen)
    # first G position = rlen - 1 - (largest scanned i <= i_star holding a G);
    # rlen - 1 when none was seen (polyx.cpp:19,24)
    g_seen = is_g & (positions(L, seq.device) <= q_star[:, None])
    j_star = last_true(g_seen, -1)
    first_g_pos = torch.where(j_star >= 0, L - 1 - j_star, rlen - 1)
    triggered = (i_star + 1) >= compare_req
    trim_len = rlen - first_g_pos
    # resize(firstGpos) is a no-op when firstGpos < 0 (read.h:181-187)
    new_rlen = torch.where(triggered & (first_g_pos >= 0), first_g_pos, rlen)
    return PolyTrimResult(new_rlen.to(torch.int32), triggered,
                          trim_len.to(torch.int32),
                          torch.full((B,), 3, dtype=torch.int32, device=seq.device))


# ATCGN tally order of trimPolyX (polyx.cpp:48-49)
_POLYX_BASES = (A, T, C, G, N)


def trim_polyx(seq: torch.Tensor, rlen: torch.Tensor, trim_chr: str,
               compare_req: int, max_mismatch: int, each: int) -> PolyTrimResult:
    """reference: src/polyx.cpp:45-101."""
    B, L = seq.shape
    dev = seq.device
    rev, iq, mask = _scan_frame(seq, rlen)
    cmp = iq + 1
    allowed = _allowed_mismatch(iq, max_mismatch, each)
    trim = [b for b, ch in enumerate("ATCGN") if ch in trim_chr]

    # cumulative tallies of the trim bases; anything not A/T/C/G tallies as N
    # (the default case of the reference's switch)
    counts = {}
    for b in trim:
        if b == 4:
            hit = (rev != A) & (rev != T) & (rev != C) & (rev != G)
        else:
            hit = rev == _POLYX_BASES[b]
        counts[b] = torch.cumsum((hit & mask).to(torch.int32), dim=1,
                                 dtype=torch.int32)
    # continue while ANY trim base still fits the budget (polyx.cpp:71-79)
    keep_going = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for c in counts.values():
        keep_going |= cmp - c <= allowed
    q_star = first_true(~keep_going & mask, L)  # loop-exit column
    pos_star = q_star - (L - rlen)              # == rlen if completed
    triggered = (pos_star + 1) >= compare_req

    # the tallies include the breaking position; a completed scan reads the
    # last column.  Dominant base: strict > walking A,T,C,G,N (polyx.cpp:83-90)
    # (its index and its character, both filled on the device: no host copy)
    tally_q = torch.clamp(q_star, max=L - 1).long()[:, None]
    poly = torch.zeros((B,), dtype=torch.int32, device=dev)
    poly_char = torch.full((B,), A, dtype=torch.uint8, device=dev)
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for b, c in counts.items():
        t = torch.gather(c, 1, tally_q)[:, 0]
        better = t > best
        poly = torch.where(better, b, poly)
        poly_char = torch.where(better, _POLYX_BASES[b], poly_char)
        best = torch.where(better, t, best)

    # pos = min(rlen-1, pos); back up to the last occurrence of the dominant
    # base (polyx.cpp:92-95): largest scanned p <= pos holding it, else 0
    q_cap = torch.clamp(q_star, max=L - 1)
    match_dom = ((rev == poly_char[:, None])
                 & (positions(L, dev) <= q_cap[:, None]) & mask)
    p_final = last_true(match_dom, L - rlen) - (L - rlen)
    # rlen == 0: the backup loop never runs, pos stays min(rlen-1, pos) = -1
    p_final = torch.where(rlen == 0, torch.minimum(rlen - 1, pos_star), p_final)
    new_len = rlen - p_final - 1
    new_rlen = torch.where(triggered & (new_len >= 0), new_len, rlen)
    return PolyTrimResult(new_rlen.to(torch.int32), triggered,
                          (p_final + 1).to(torch.int32), poly)
