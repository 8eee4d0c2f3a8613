"""Duplication-analysis keys of single-end reads and of pairs.

Counterpart of ``fqtool_tpu/ops/dup.py::dup_keys_se`` and ``dup_keys_pe``
(reference: src/duplicate.cpp:64-129): per read or pair, a 2-bit packed
prefix key, a 32-base discriminator as two 32-bit halves, and a GC byte.
The packing runs in int64 (PyTorch has few uint32 kernels); the results come
back in the JAX dtypes, which ``fqtool_tpu.host.duplicate`` consumes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import C, G, positions, seq2int_codes, valid_mask


class DupKeys(NamedTuple):
    key: torch.Tensor       # int32 [B]  (low 32 key bits)
    kmer_hi: torch.Tensor   # uint32 [B] first 16 bases of the 32-mer
    kmer_lo: torch.Tensor   # uint32 [B] last 16 bases
    gc: torch.Tensor        # uint8 [B] round(255 * gc / len)
    valid: torch.Tensor     # bool [B]
    key_hi: Optional[torch.Tensor] = None  # int32 [B] key bits past 32 (keylen > 16)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 holding the same 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _pack_2bit(c: torch.Tensor):
    """Pack the columns of ``c`` (int8 codes, -1 invalid), first column
    highest: (int64 value with invalid bases as 0, all-valid mask)."""
    val = torch.zeros(c.shape[:1], dtype=torch.int64, device=c.device)
    for j in range(c.shape[1]):
        val = val * 4 + c[:, j].clamp(min=0)
    return val, (c >= 0).all(dim=1)


def _pack_2bit_fixed(codes: torch.Tensor, start: int, n: int):
    """Pack the ``n`` codes from the column ``start``; a pack narrower than
    the window gives 0 and not-ok for every read (all are too short)."""
    B = codes.shape[0]
    if start + n > codes.shape[1]:
        return (torch.zeros((B,), dtype=torch.int64, device=codes.device),
                torch.zeros((B,), dtype=torch.bool, device=codes.device))
    return _pack_2bit(codes[:, start : start + n])


def _pack_key(codes: torch.Tensor, keylen: int):
    """(low 32 key bits as int32, bits past 32 as int32 or None, ok)."""
    if keylen <= 16:
        key, ok = _pack_2bit_fixed(codes, 0, keylen)
        return _wrap_int32(key), None, ok
    hi, ok1 = _pack_2bit_fixed(codes, 0, keylen - 16)
    lo, ok2 = _pack_2bit_fixed(codes, keylen - 16, 16)
    return _wrap_int32(lo), hi.to(torch.int32), ok1 & ok2


def _pack_kmer32(codes: torch.Tensor, start: torch.Tensor):
    """(hi, hi_ok, lo, lo_ok): the 32 bases from per-read ``start`` as two
    16-base packs.  Bases past the row end pack as 0 and are not ok."""
    L = codes.shape[1]
    idx = start[:, None] + positions(32, codes.device)
    inside = idx < L
    c = torch.gather(codes, 1, idx.clamp(max=L - 1).long())
    c = torch.where(inside, c, torch.zeros((), dtype=c.dtype, device=c.device))
    hi, hi_ok = _pack_2bit(c[:, :16])
    lo, lo_ok = _pack_2bit(c[:, 16:])
    return (hi, hi_ok & inside[:, :16].all(dim=1),
            lo, lo_ok & inside[:, 16:].all(dim=1))


def _gc_count(seq: torch.Tensor, rlen: torch.Tensor) -> torch.Tensor:
    """C and G bases of each read within its length."""
    return (valid_mask(rlen, seq.shape[1]) & ((seq == C) | (seq == G))).sum(dim=1)


def _gc_byte(gc: torch.Tensor, total_len: torch.Tensor) -> torch.Tensor:
    """``floor(255 * gc / len + 0.5)`` in float32, with the GC count wrapped
    mod 256 as the reference's uint8 accumulator wraps it
    (duplicate.cpp:83-92, 114-127)."""
    tl = torch.clamp(total_len, min=1).to(torch.float32)
    return torch.floor(255.0 * (gc % 256).to(torch.float32) / tl + 0.5).to(torch.uint8)


def dup_keys_se(seq: torch.Tensor, rlen: torch.Tensor, keylen: int) -> DupKeys:
    """reference: src/duplicate.cpp:64-93."""
    codes = seq2int_codes(seq)
    key, key_hi, key_ok = _pack_key(codes, keylen)
    start = torch.clamp(rlen - 32 - 5, min=0)
    hi, hi_ok, lo, lo_ok = _pack_kmer32(codes, start)
    valid = (rlen >= 32) & key_ok & hi_ok & lo_ok
    return DupKeys(key, hi.to(torch.uint32), lo.to(torch.uint32),
                   _gc_byte(_gc_count(seq, rlen), rlen), valid, key_hi)


def dup_keys_pe(seq1: torch.Tensor, rlen1: torch.Tensor, seq2: torch.Tensor,
                rlen2: torch.Tensor, keylen: int) -> DupKeys:
    """reference: src/duplicate.cpp:95-129.  The key from read1's prefix, the
    discriminator from read2's first 32 bases, GC over both reads (the sum
    wraps mod 256 before the scale)."""
    key, key_hi, key_ok = _pack_key(seq2int_codes(seq1), keylen)
    codes2 = seq2int_codes(seq2)
    hi, hi_ok = _pack_2bit_fixed(codes2, 0, 16)
    lo, lo_ok = _pack_2bit_fixed(codes2, 16, 16)
    valid = (rlen1 >= 32) & (rlen2 >= 32) & key_ok & hi_ok & lo_ok
    gc = _gc_byte(_gc_count(seq1, rlen1) + _gc_count(seq2, rlen2), rlen1 + rlen2)
    return DupKeys(key, hi.to(torch.uint32), lo.to(torch.uint32), gc, valid, key_hi)
