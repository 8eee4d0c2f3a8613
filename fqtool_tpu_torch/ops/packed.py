"""Packed seq+qual transport encoding.

Counterpart of ``fqtool_tpu/ops/packed.py``.  Both uint8 planes of a read
side fit in ONE byte per base whenever every base is A/C/G/T/N and every
quality lies in [33, 82]:

    enc = code(base) + 5 * (qual - 33)        code: A=0 C=1 G=2 T=3 N=4
    pad = 250 (above every valid code, 4 + 5*49 = 249)

The host encoders (``encode_host``, ``encode5_host``) are the JAX module's
numpy code, copied: one 256x256 LUT gather whose invalid cells hold 255
(None for content outside the alphabet, and the runner keeps the raw
planes), and the 5-bit dictionary packing on top of it.  The device decoders
are plain torch ops: a gather of each byte's (base, quality) from a lookup
table, and for the 5-bit form one ``dict32[codes]`` gather after the shift
unpacking.  Every downstream stage sees byte-identical planes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .common import A, C, G, N, T

QUAL_MIN = 33
QUAL_MAX = 33 + 49  # code + 5*49 = 249 < PAD
PAD = 250
_INVALID = 255

# (base byte, qual byte) -> encoded byte; one gather pass + one max() check
_ENC_LUT = np.full((256, 256), _INVALID, np.uint8)
_ENC_LUT[0, 0] = PAD  # seq pad and qual pad must agree
for _i, _ch in enumerate(b"ACGTN"):
    for _q in range(QUAL_MIN, QUAL_MAX + 1):
        _ENC_LUT[_ch, _q] = _i + 5 * (_q - QUAL_MIN)

# enc byte -> (base, quality), for every byte value: the pad decodes to
# (0, 0); any other value v to (ACGTN[v % 5], v // 5 + 33) in uint8, which is
# fqtool_tpu's decode_device arithmetic (bytes above the pad included)
_v = np.arange(256)
_DEC_SEQ = np.where(_v == PAD, 0, np.array([A, C, G, T, N])[_v % 5]).astype(np.uint8)
_DEC_QUAL = np.where(_v == PAD, 0, _v // 5 + QUAL_MIN).astype(np.uint8)


def encode_host(seq: np.ndarray, qual: np.ndarray) -> Optional[np.ndarray]:
    """Encode a zero-padded ASCII (seq, qual) pair into one uint8 matrix, or
    None when the content is outside the encodable alphabet/quality range.
    Native single pass when available; numpy LUT gather otherwise."""
    from ..io.native import encode_native, get_lib

    if get_lib() is not None and seq.flags.c_contiguous and \
            qual.flags.c_contiguous:
        return encode_native(seq, qual, _ENC_LUT)
    enc = _ENC_LUT[seq, qual]
    if int(enc.max(initial=0)) == _INVALID:
        return None
    return enc


def encode5_host(enc: np.ndarray):
    """5-bit dictionary transport on top of :func:`encode_host`: when a
    pack's ``enc`` value set fits in 32 entries, each byte is replaced by a
    5-bit dictionary index and 8 indices pack into 5 bytes.

    Returns ``(packed [B, ceil(L/8)*5] uint8, dict32 [32] uint8)`` or None
    when the pack's alphabet exceeds 32 values (caller falls back to the
    1-byte encoding).
    """
    from ..io.native import pack5_native

    if enc.flags.c_contiguous:
        got = pack5_native(enc)
        if got is not False:  # None = >32 values; tuple = packed result
            return got
    counts = np.bincount(enc.reshape(-1), minlength=256)
    vals = np.flatnonzero(counts).astype(np.uint8)
    if len(vals) > 32:
        return None
    dict32 = np.zeros(32, np.uint8)
    dict32[: len(vals)] = vals
    inv = np.zeros(256, np.uint8)
    inv[vals] = np.arange(len(vals), dtype=np.uint8)
    codes = inv[enc]
    B, L = codes.shape
    Lp = -(-L // 8) * 8
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)))
    # uint8 plane arithmetic (little-endian bit offsets 5*i)
    c = codes.reshape(B, Lp // 8, 8)
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    c4, c5, c6, c7 = c[..., 4], c[..., 5], c[..., 6], c[..., 7]

    def sh(x, k):  # dtype-preserving uint8 shift (wraparound intended)
        return np.left_shift(x, k, dtype=np.uint8, casting="unsafe")

    out = np.empty((B, Lp // 8, 5), np.uint8)
    out[..., 0] = c0 | sh(c1, 5)
    out[..., 1] = (c1 >> 3) | sh(c2, 2) | sh(c3, 7)
    out[..., 2] = (c3 >> 1) | sh(c4, 4)
    out[..., 3] = (c4 >> 4) | sh(c5, 1) | sh(c6, 6)
    out[..., 4] = (c6 >> 2) | sh(c7, 3)
    return out.reshape(B, (Lp // 8) * 5), dict32


def decode_device(enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_host` on the device of ``enc``: (seq, qual)
    uint8 planes, each one lookup-table gather."""
    idx = enc.long()
    seq = torch.as_tensor(_DEC_SEQ, device=enc.device)[idx]
    qual = torch.as_tensor(_DEC_QUAL, device=enc.device)[idx]
    return seq, qual


def decode5_device(packed: torch.Tensor, dict32: torch.Tensor,
                   width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode5_host` on the device of ``packed``: the 5-bit
    indices unpacked from each 5-byte group (40 bits, little-endian), the
    ``enc`` bytes gathered from the dictionary, then :func:`decode_device`."""
    B = packed.shape[0]
    G = packed.shape[1] // 5
    pb = packed.reshape(B, G, 5).to(torch.int64)
    word = (pb[:, :, 0] | pb[:, :, 1] << 8 | pb[:, :, 2] << 16
            | pb[:, :, 3] << 24 | pb[:, :, 4] << 32)
    shifts = torch.arange(0, 40, 5, dtype=torch.int64, device=packed.device)
    codes = ((word[:, :, None] >> shifts) & 31).reshape(B, G * 8)[:, :width]
    return decode_device(dict32[codes])
