"""fqtool_tpu_torch single-end stages against their fqtool_tpu counterparts.

The same numpy batches (random reads from ``random_batch`` with planted
polyG/polyX tails and adapter prefixes, lengths from 0 to the width, N runs,
zero padding) go through the JAX function and the port's torch version on
the CPU.  Every output is an integer or a bool, so every comparison is
exact (tolerance 0), dtypes and shapes included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fqtool_tpu.ops import adapter as jadapter
from fqtool_tpu.ops import common as jcommon
from fqtool_tpu.ops import dup as jdup
from fqtool_tpu.ops import polyx as jpolyx
from fqtool_tpu.ops import stats as jstats
from fqtool_tpu_torch.ops import adapter as tadapter
from fqtool_tpu_torch.ops import common as tcommon
from fqtool_tpu_torch.ops import dup as tdup
from fqtool_tpu_torch.ops import polyx as tpolyx
from fqtool_tpu_torch.ops import stats as tstats

from .torch_pairs import random_batch
from .torch_reads import ADAPTER


def _same(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} vs {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}"
    assert np.array_equal(got, ref), f"{what}: first diff at " \
        f"{np.argwhere(got != ref)[:5].tolist()}"


def _same_tuple(ref, got):
    assert got._fields == ref._fields
    for name, a, b in zip(ref._fields, ref, got):
        if a is None:
            assert b is None, name
        else:
            _same(a, b, name)


def tailed_batch(seed: int, B: int, L: int):
    """``random_batch`` with homopolymer tails (G, A, T, C or N, with a
    few mismatches) planted just before the read end on half of the rows,
    adapter prefixes planted on a quarter of them, and reads that start
    inside the adapter on a tenth."""
    rng = np.random.default_rng(seed)
    seq, qual, rlen = random_batch(rng, B, L)
    ad = np.frombuffer(ADAPTER, np.uint8)
    for r in range(B):
        n = int(rlen[r])
        if n == 0:
            continue
        roll = rng.random()
        if roll < 0.5:
            k = int(rng.integers(1, n + 1))
            seq[r, n - k : n] = ord(rng.choice(list("GGGATCN")))
            flip = rng.random(k) < 0.08
            seq[r, n - k : n][flip] = ord("C")
        elif roll < 0.75:
            s = int(rng.integers(max(0, n - 40), n))
            m = min(len(ad), n - s)
            seq[r, s : s + m] = ad[:m]
        elif roll < 0.85:  # the read starts inside the adapter
            j = int(rng.integers(1, 5))
            m = min(len(ad) - j, n)
            seq[r, :m] = ad[j : j + m]
    return seq, qual, rlen


T = torch.as_tensor

POLY_WIDTHS = [40, 152, 300, 1030]  # the 8-bit, 10-bit and 5-plane tallies of JAX
POLYG_PARAMS = [(10, 5, 8), (10, 0, 8), (3, 2, 1), (25, 5, 4)]


@pytest.mark.parametrize("L", POLY_WIDTHS)
@pytest.mark.parametrize("min_len,max_mm,each", POLYG_PARAMS)
def test_trim_polyg(L, min_len, max_mm, each):
    seq, _, rlen = tailed_batch(L + min_len, 96, L)
    ref = jpolyx.trim_polyg(seq, rlen, min_len, max_mm, each)
    _same_tuple(ref, tpolyx.trim_polyg(T(seq), T(rlen), min_len, max_mm, each))


POLYX_PARAMS = [("ATCGN", 10, 5, 8), ("ATCG", 10, 5, 8), ("A", 10, 5, 8),
                ("GN", 4, 2, 3), ("TC", 10, 0, 8), ("ATCGN", 1, 5, 1)]


@pytest.mark.parametrize("L", POLY_WIDTHS)
@pytest.mark.parametrize("chars,min_len,max_mm,each", POLYX_PARAMS)
def test_trim_polyx(L, chars, min_len, max_mm, each):
    seq, _, rlen = tailed_batch(L + len(chars), 96, L)
    ref = jpolyx.trim_polyx(seq, rlen, chars, min_len, max_mm, each)
    _same_tuple(ref, tpolyx.trim_polyx(T(seq), T(rlen), chars, min_len,
                                       max_mm, each))


@pytest.mark.parametrize("alen", [3, 4, 7, 8, 12, 16, 33])
def test_trim_by_sequence(alen):
    seq, _, rlen = tailed_batch(alen, 256, 152)
    adapter = ADAPTER[:alen]
    ref = jadapter.trim_by_sequence(seq, rlen, np.frombuffer(adapter, np.uint8))
    got = tadapter.trim_by_sequence(T(seq), T(rlen), adapter)
    _same_tuple(ref, got)
    if alen >= 4:
        assert got.found.any()
    if alen >= 8:
        assert (got.pos < 0).any()


@pytest.mark.parametrize("k,select,B", [(4, False, 256), (4, True, 256),
                                        (6, False, 256), (6, True, 256),
                                        (9, False, 64), (9, True, 64)])
def test_kmer_counts(k, select, B):
    rng = np.random.default_rng(k)
    seq, _, rlen = random_batch(rng, B, 152)
    sel = rng.random(B) < 0.6 if select else None
    ref = jstats.kmer_counts(seq, rlen, k, sel)
    got = tstats.kmer_counts(T(seq), T(rlen), k, None if sel is None else T(sel))
    _same(ref, got, "kmer")
    assert int(got.sum()) > 0


@pytest.mark.parametrize("keylen", [12, 16, 17, 31])
@pytest.mark.parametrize("L", [24, 152])
def test_dup_keys_se(keylen, L):
    rng = np.random.default_rng(keylen + L)
    seq, _, rlen = random_batch(rng, 256, L)
    rlen[8:24] = rng.integers(28, 40, 16).clip(max=L)  # around the 32 cut
    ref = jdup.dup_keys_se(seq, rlen, keylen)
    got = tdup.dup_keys_se(T(seq), T(rlen), keylen)
    _same_tuple(ref, got)
    if L >= 32:
        assert got.valid.any() and not got.valid.all()


def test_seq2int_codes():
    seq = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _same(jcommon.seq2int_codes(seq), tcommon.seq2int_codes(T(seq)), "codes")


@pytest.mark.parametrize("L", [1, 37, 152])
def test_select_at(L):
    rng = np.random.default_rng(L)
    x = rng.integers(-2**31, 2**31 - 1, (64, L), dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, L + 3, 64).astype(np.int32)
    _same(jcommon.select_at(x, idx), tcommon.select_at(T(x), T(idx)), "select_at")
