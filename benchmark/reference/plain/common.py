# Frozen copy of fqtool_tpu_torch/ops/common.py, taken when the benchmark was
# written; the benchmark's reference imports nothing of the program.
"""Shared tensor primitives for the per-read stages.

Counterpart of ``fqtool_tpu/ops/common.py``.  All stages work on
left-aligned batches: ``seq``/``qual`` are ``uint8[B, L]`` ASCII matrices,
``rlen`` is ``int32[B]``; every helper runs on the device of its input.
"""

from __future__ import annotations

import torch

# ASCII codes
A, C, G, T, N = 65, 67, 71, 84, 78
Q20_CHAR = ord("5")  # reference: stats.cpp:250
Q30_CHAR = ord("?")  # reference: stats.cpp:251


def seq2int_codes(seq: torch.Tensor) -> torch.Tensor:
    """int8 2-bit base codes A=0 T=1 C=2 G=3; -1 for anything else."""
    lut = torch.full((256,), -1, dtype=torch.int8, device=seq.device)
    for code, base in enumerate((A, T, C, G)):
        lut[base] = code
    return lut[seq.long()]


def complement(seq: torch.Tensor) -> torch.Tensor:
    """Base complement (reference: seq.h:24-48): A<->T C<->G (either case),
    everything else -> N."""
    lut = torch.full((256,), N, dtype=torch.uint8, device=seq.device)
    for src, dst in ((A, T), (T, A), (C, G), (G, C)):
        lut[src] = dst
        lut[src + 32] = dst  # lower case
    return lut[seq.long()]


def positions(n: int, device) -> torch.Tensor:
    """[1, n] int32 position row for broadcasting against [B, 1] scalars."""
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def valid_mask(rlen: torch.Tensor, width: int) -> torch.Tensor:
    """[B, width] mask of positions < rlen."""
    return positions(width, rlen.device) < rlen[:, None]


def first_true(mask: torch.Tensor, default) -> torch.Tensor:
    """Per-row index of the first True along the last axis, else ``default``
    (a scalar or a [B] tensor)."""
    found = mask.any(dim=-1)
    idx = mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)
    return torch.where(found, idx, default)


def last_true(mask: torch.Tensor, default) -> torch.Tensor:
    """Per-row index of the last True along the last axis, else ``default``."""
    n = mask.shape[-1]
    found = mask.any(dim=-1)
    idx = (n - 1) - mask.flip(-1).to(torch.uint8).argmax(dim=-1).to(torch.int32)
    return torch.where(found, idx, default)


def shift_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row cyclic shift ``out[b, i] = x[b, (i + shift[b]) mod L]`` as one
    gather.  Positions that wrap read cyclic garbage -- callers mask by the
    row's valid length, as with ``fqtool_tpu``'s barrel shifter."""
    L = x.shape[1]
    idx = torch.remainder(positions(L, x.device) + shift[:, None], L)
    return torch.gather(x, 1, idx.long())


def align(planes, start: torch.Tensor):
    """Left-align each row of every plane at ``start``; positions past the end
    read wrapped garbage -- callers must mask by the new length."""
    return tuple(shift_rows(x, start) for x in planes)


def align_static(x: torch.Tensor, k: int) -> torch.Tensor:
    """Left-shift every row by the static offset ``k`` (slice + zero pad)."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x[:, k:], (0, k))


def select_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]``, and 0 where ``idx[b]`` lies outside the row."""
    L = x.shape[1]
    inside = (idx >= 0) & (idx < L)
    got = torch.gather(x, 1, idx.clamp(0, max(L - 1, 0)).long()[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros((), dtype=x.dtype, device=x.device))


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, L+1] exclusive prefix sums in int32."""
    c = torch.cumsum(x.to(torch.int32), dim=1, dtype=torch.int32)
    return torch.nn.functional.pad(c, (1, 0))
