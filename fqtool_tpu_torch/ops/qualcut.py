"""Force trims + sliding-window quality cuts.

Counterpart of ``fqtool_tpu/ops/qualcut.py::trim_and_cut`` (reference:
src/filter.cpp:69-189), including the quirks that module lists:

  * the relocation ``if (s > 0) s = s + w - 1`` after the front cut tests
    ``s > 0``, not ``s > forceFrontCut`` (filter.cpp:113-115);
  * cut_right's advance stops at ``l - 1`` even if that base is high quality
    (filter.cpp:147);
  * cut_tail's relocation tests ``t < l - 1`` (filter.cpp:174);
  * the sliding loops never evaluate the final window touching position
    ``l - tail - 1`` for front/right cuts (loop condition ``s + w < l - tail``);
  * all three cuts return NULL (read dropped) when the remaining span is not
    longer than the window (filter.cpp:97,128,157) and on final over-trim
    (filter.cpp:183-185).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config.options import KernelParams

from .common import (N, align, align_static, first_true, last_true, positions,
                     prefix_sums)


class TrimCutResult(NamedTuple):
    front: torch.Tensor    # int32 [B], offset of the kept span in the input rows
    rlen: torch.Tensor     # int32 [B], kept span length
    dropped: torch.Tensor  # bool [B], read consumed (reference returned NULL)


def trim_and_cut(seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
                 force_front: int, force_tail: int, p: KernelParams) -> TrimCutResult:
    """Apply force trims and the enabled quality cuts to every read.

    ``force_front``/``force_tail`` are per-stream scalars (trim.front1/tail1
    or front2/tail2).  Returns spans relative to the *input* rows.
    """
    B, L = seq.shape
    dev = seq.device
    l = rlen.to(torch.int32)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    no_drop = torch.zeros((B,), dtype=torch.bool, device=dev)

    any_cut = p.cut_front or p.cut_right or p.cut_tail
    if force_front == 0 and force_tail == 0 and not any_cut:
        return TrimCutResult(zero, l, no_drop)  # filter.cpp:70-73

    rlen0 = l - force_front - force_tail
    dropped = rlen0 < 0  # filter.cpp:75-77

    if not any_cut:
        # force trims only (filter.cpp:80-87)
        return TrimCutResult(zero + force_front, torch.clamp(rlen0, min=0), dropped)

    pos = positions(L, dev)  # [1, L]
    Q = prefix_sums(qual)  # [B, L+1]
    # one extra column so index scans can land at j == l (e.g. N-skip to end)
    is_n_ext = F.pad(seq == N, (0, 1))
    qual_ext = F.pad(qual, (0, 1))
    pos_ext = positions(L + 1, dev)

    def window_sums(w: int) -> torch.Tensor:
        # winsum[s] = sum(qual[s .. s+w-1]) for s in [0, L-w]; padded to [B, L]
        ws = Q[:, w:] - Q[:, :-w]
        return F.pad(ws, (0, L - ws.shape[1]))

    front = torch.full((B,), force_front, dtype=torch.int32, device=dev)
    cur_rlen = rlen0

    if p.cut_front:
        w = p.cut_front_window
        thresh = w * (33 + p.cut_front_qual)
        dropped = dropped | (l - force_front - force_tail - w <= 0)  # filter.cpp:97
        ws = window_sums(w)
        hit = (ws >= thresh) & (pos >= force_front) & (pos + w < (l - force_tail)[:, None])
        s1 = first_true(hit, l - force_tail - w)  # loop-exit value for survivors
        s2 = torch.where(s1 > 0, s1 + w - 1, s1)  # filter.cpp:113-115 quirk
        # skip N bases forward (filter.cpp:117-119): first j >= s2 with
        # j >= l or seq[j] != 'N'
        stop = (pos_ext >= l[:, None]) | ~is_n_ext
        s3 = first_true(stop & (pos_ext >= s2[:, None]), l)
        front = s3
        cur_rlen = l - front - force_tail  # filter.cpp:121

    if p.cut_right:
        w = p.cut_right_window
        t33 = 33 + p.cut_right_qual
        thresh = w * t33
        dropped = dropped | (l - front - force_tail - w <= 0)  # filter.cpp:128
        ws = window_sums(w)
        hit = (ws < thresh) & (pos >= front[:, None]) & (pos + w < (l - force_tail)[:, None])
        found = hit.any(dim=1)
        s1 = first_true(hit, zero)
        # advance to the first base below threshold, capped at l-1
        # (filter.cpp:146-149)
        stop = (pos_ext >= (l - 1)[:, None]) | (qual_ext < t33)
        s2 = first_true(stop & (pos_ext >= s1[:, None]), zero)
        cur_rlen = torch.where(found, s2 - front, cur_rlen)
    elif p.cut_tail:
        w = p.cut_tail_window
        thresh = w * (33 + p.cut_tail_qual)
        dropped = dropped | (l - front - force_tail - w <= 0)  # filter.cpp:157
        # window [t-w+1, t]; wsum[t] = Q[t+1] - Q[t-w+1]
        ws_t = Q[:, w:] - Q[:, :-w]  # index t-w+1 = s => t = s+w-1
        wsum_t = F.pad(ws_t, (w - 1, 0))[:, :L]  # wsum_t[:, t]
        hit = (wsum_t >= thresh) & ((pos - w) >= front[:, None]) & (pos <= (l - force_tail - 1)[:, None])
        # scanning downward from l - tail - 1: first hit = largest t
        t1 = last_true(hit, front + w - 1)  # loop-exit t for survivors
        t2 = torch.where(t1 < l - 1, t1 - w + 1, t1)  # filter.cpp:174-176 quirk
        # skip N bases backward (filter.cpp:177-179): last j <= t2 with
        # seq[j] != 'N', else -1
        not_n = seq != N
        t3 = last_true(not_n & (pos <= t2[:, None]), -1)
        cur_rlen = t3 - front + 1

    dropped = dropped | (cur_rlen <= 0) | (front >= l - 1)  # filter.cpp:183-185
    return TrimCutResult(front, torch.clamp(cur_rlen, min=0), dropped)


def front_align(seq: torch.Tensor, qual: torch.Tensor, tc: TrimCutResult,
                p: KernelParams):
    """Left-align the planes at the kept span's start: a per-row shift after
    a quality front cut, a static slice for a force trim alone."""
    if p.cut_front:
        return align((seq, qual), tc.front)
    if p.front > 0:
        return align_static(seq, p.front), align_static(qual, p.front)
    return seq, qual
