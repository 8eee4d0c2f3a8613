"""Read pass/fail classification.

Counterpart of ``fqtool_tpu/ops/filters.py`` (reference: src/filter.cpp:3-67)
with the same failure precedence: quality-ratio -> mean-quality -> N-count ->
too-short -> too-long -> low-complexity, and NULL/empty reads classified
FAIL_LENGTH.  The two ratio tests are float32 divisions and compares, as in
the JAX version, so both give the same codes bit for bit.
"""

from __future__ import annotations

import torch

from ..config.options import KernelParams

from .common import N, valid_mask

# filter result codes (reference: src/common.h:9-16)
PASS_FILTER = 0
FAIL_POLY_X = 4
FAIL_OVERLAP = 8
FAIL_N_BASE = 12
FAIL_LENGTH = 16
FAIL_TOO_LONG = 17
FAIL_QUALITY = 20
FAIL_COMPLEXITY = 24
FILTER_RESULT_TYPES = 32

FAILED_TYPES = [
    "passed", "", "", "",
    "failed_polyx_filter", "", "", "",
    "failed_bad_overlap", "", "", "",
    "failed_too_many_n_bases", "", "", "",
    "failed_too_short", "failed_too_long", "", "",
    "failed_quality_filter", "", "", "",
    "failed_low_complexity", "", "", "",
    "", "", "", "",
]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def pass_filter(seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
                dropped: torch.Tensor, p: KernelParams) -> torch.Tensor:
    """Return int32 [B] filter-result codes.

    ``dropped`` marks reads the trimming stage consumed (passFilter receives
    NULL -> FAIL_LENGTH, filter.cpp:4-6).
    """
    B, L = seq.shape
    dev = seq.device
    mask = valid_mask(rlen, L)
    result = torch.full((B,), PASS_FILTER, dtype=torch.int32, device=dev)

    if p.qual_filter_enabled:
        qv = qual.to(torch.int32)
        total_qual = torch.where(mask, qv - 33, 0).sum(dim=1, dtype=torch.int32)
        n_num = (mask & (seq == N)).sum(dim=1, dtype=torch.int32)
        low_num = (mask & (qv < p.low_quality_limit)).sum(dim=1, dtype=torch.int32)

    if p.complexity_filter_enabled:
        # fraction of adjacent differing bases over rlen-1 pairs
        # (filter.cpp:54-67); rlen <= 1 fails
        diff_adj = (seq[:, :-1] != seq[:, 1:]) & valid_mask(rlen - 1, L - 1)
        diff = diff_adj.sum(dim=1, dtype=torch.int32)
        denom = torch.clamp(rlen - 1, min=1).to(torch.float32)
        complexity_ok = (rlen > 1) & (
            diff.to(torch.float32) / denom >= _f32(p.complexity_threshold, dev))
        result = torch.where(~complexity_ok, FAIL_COMPLEXITY, result)

    if p.length_filter_enabled:
        if p.max_read_length > 0:
            result = torch.where(rlen > p.max_read_length, FAIL_TOO_LONG, result)
        result = torch.where(rlen < p.min_read_length, FAIL_LENGTH, result)

    if p.qual_filter_enabled:
        result = torch.where(n_num > p.n_base_limit, FAIL_N_BASE, result)
        if p.average_quality_limit > 0:
            # double(totalQual)/rlen < limit  (filter.cpp:29)
            rl = torch.clamp(rlen, min=1).to(torch.float32)
            result = torch.where(
                _f32(p.average_quality_limit, dev) > total_qual.to(torch.float32) / rl,
                FAIL_QUALITY, result)
        result = torch.where(low_num > p.low_quality_base_limit, FAIL_QUALITY, result)

    # NULL / zero-length reads (filter.cpp:4-6)
    result = torch.where(dropped | (rlen == 0), FAIL_LENGTH, result)
    return result.to(torch.int32)
