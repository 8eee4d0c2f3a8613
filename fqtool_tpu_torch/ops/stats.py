"""Per-cycle statistics and k-mer counts.

Counterpart of ``fqtool_tpu/ops/stats.py`` ``stat_batch`` and ``kmer_counts`` (reference:
src/stats.cpp:237-295): per-cycle Q20/Q30/content/quality histograms binned
by ``base & 0x07``.  Q20/Q30 use strict ``>`` against '5'/'?'
(stats.cpp:250-259).  ``stat_batch`` sends CUDA tensors to the hand-written
kernel of ``stats_cuda`` (one launch a call); on CPU tensors it is plain
torch (``stat_batch_plain``), one int64 scatter-add over the ``(base & 7,
cycle)`` bins, cast to int32 like the JAX results.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import stats_cuda
from .common import Q20_CHAR, Q30_CHAR, positions, seq2int_codes, valid_mask


class BatchStats(NamedTuple):
    cycle_q20: torch.Tensor       # int32 [8, L]
    cycle_q30: torch.Tensor       # int32 [8, L]
    cycle_content: torch.Tensor   # int32 [8, L]
    cycle_quality: torch.Tensor   # int32 [8, L]
    cycle_total: torch.Tensor     # int32 [L]
    cycle_total_qual: torch.Tensor  # int32 [L]
    reads: torch.Tensor           # int32 []
    length_sum: torch.Tensor      # int32 []


def stat_batch(seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
               select: Optional[torch.Tensor] = None) -> BatchStats:
    """Accumulate per-cycle statistics over a batch.

    ``select`` (bool [B]) restricts which reads contribute (post-filter stats
    only cover passing reads, seprocessor.cpp:342-345).  A CUDA tensor goes
    to the kernel (``stats_cuda.stat_batch_cuda``), which raises if it cannot
    be built or launched: there is no fallback.  A CPU tensor goes to
    ``stat_batch_plain``.
    """
    if not seq.is_cuda:
        return stat_batch_plain(seq, qual, rlen, select)
    L = seq.shape[1]
    out = stats_cuda.stat_batch_cuda(
        seq.contiguous(), qual.contiguous(), rlen.contiguous(),
        None if select is None else select.contiguous())
    q20, q30, content, quality = out[: 32 * L].view(4, 8, L).unbind()
    total, total_qual = out[32 * L : 34 * L].view(2, L).unbind()
    reads, length_sum = out[34 * L :].unbind()
    return BatchStats(
        cycle_q20=q20, cycle_q30=q30, cycle_content=content,
        cycle_quality=quality, cycle_total=total, cycle_total_qual=total_qual,
        reads=reads, length_sum=length_sum)


def stat_batch_plain(seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
                     select: Optional[torch.Tensor] = None) -> BatchStats:
    """``stat_batch`` in plain torch, on any device."""
    B, L = seq.shape
    mask = valid_mask(rlen, L)
    if select is not None:
        mask = mask & select[:, None]
    qv = qual.to(torch.int64)
    # per-position contributions [content, q20, q30, quality] of masked bases
    vals = torch.stack([torch.ones_like(qv), (qv > Q20_CHAR).to(torch.int64),
                        (qv > Q30_CHAR).to(torch.int64), qv - 33], dim=-1)
    vals = vals * mask[..., None]
    cycle = torch.arange(L, dtype=torch.int64, device=seq.device)[None, :]
    bins = (seq.to(torch.int64) & 7) * L + cycle                # [B, L]
    hist = torch.zeros((8 * L, 4), dtype=torch.int64, device=seq.device)
    hist.index_add_(0, bins.reshape(-1), vals.reshape(-1, 4))
    cq = hist.reshape(8, L, 4).to(torch.int32)

    if select is None:
        nreads = torch.full((), B, dtype=torch.int32, device=seq.device)
        lsum = rlen.sum()
    else:
        nreads = select.sum().to(torch.int32)
        lsum = torch.where(select, rlen, 0).sum()
    # bins partition the masked positions, so the totals are bin sums
    return BatchStats(
        cycle_q20=cq[:, :, 1],
        cycle_q30=cq[:, :, 2],
        cycle_content=cq[:, :, 0],
        cycle_quality=cq[:, :, 3],
        cycle_total=cq[:, :, 0].sum(dim=0, dtype=torch.int32),
        cycle_total_qual=cq[:, :, 3].sum(dim=0, dtype=torch.int32),
        reads=nreads,
        length_sum=lsum.to(torch.int32),
    )


def kmer_counts(seq: torch.Tensor, rlen: torch.Tensor, kmer_len: int,
                select: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [4**k] histogram of the k-mer windows (stats.cpp:266-274): a
    window ending at position i (k-1 <= i < rlen) counts iff all k bases are
    A/T/C/G; the key packs the bases 2 bits each, first base highest.  One
    ``index_add_`` of the windows' validity over their keys.  The histogram
    takes 4**k int32 on the device (k = 16: 16 GiB)."""
    B, L = seq.shape
    k = kmer_len
    dev = seq.device
    hist = torch.zeros((4 ** max(k, 1),), dtype=torch.int32, device=dev)
    if k <= 0 or L < k:
        return hist
    codes = seq2int_codes(seq)
    nwin = L - k + 1
    key = torch.zeros((B, nwin), dtype=torch.int64, device=dev)
    ok = positions(nwin, dev) + (k - 1) < rlen[:, None]
    if select is not None:
        ok &= select[:, None]
    for j in range(k):
        c = codes[:, j : j + nwin]
        key = key * 4 + c.clamp(min=0)
        ok &= c >= 0
    hist.index_add_(0, key.reshape(-1), ok.reshape(-1).to(torch.int32))
    return hist
