"""fqtool_tpu_torch overlap analysis (plain PyTorch version) against
``fqtool_tpu.ops.overlap.analyze`` and the Pallas kernel in interpret mode.

Half of the rows carry planted overlaps (read2's tail is the reverse
complement of read1's head), the rest are random; lengths include 0 and
widths differ between the mates.  The edge cases of ``torch_pairs.edge_pairs``
add lowercase and non-ACGTN bytes, unpadded widths, lengths 0-3, diff limits
0 and 60 and windows across 32-bit word boundaries; ``chip_smoke.py`` holds
the CUDA kernel against the plain version on the same cases.  All four
outputs are integers: exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fqtool_tpu.ops import overlap as jov
from fqtool_tpu.ops.pallas_overlap2 import analyze_pallas2
from fqtool_tpu_torch.ops import overlap as tov
from fqtool_tpu_torch.ops import overlap_cuda, overlap_select

from .torch_pairs import OVERLAP_EDGE_CASES, edge_pairs

_COMP = {65: 84, 84: 65, 67: 71, 71: 67, 78: 78}


def planted_pairs(seed: int, B: int, l1: int, l2: int):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    seq1 = rng.choice(alphabet, size=(B, l1), p=[0.24] * 4 + [0.04])
    seq2 = rng.choice(alphabet, size=(B, l2), p=[0.24] * 4 + [0.04])
    rlen1 = rng.integers(0, l1 + 1, B).astype(np.int32)
    rlen2 = rng.integers(0, l2 + 1, B).astype(np.int32)
    rlen1[:4] = 0
    rlen2[2:6] = 0
    rlen1[6:12] = l1
    rlen2[6:12] = l2
    for b in range(0, B, 2):
        n1, n2 = int(rlen1[b]), int(rlen2[b])
        ov = min(int(rng.integers(20, 200)), n1, n2)
        shift = int(rng.integers(0, max(n1 - ov, 0) + 1))
        for i in range(ov):
            seq2[b, n2 - 1 - i] = _COMP[int(seq1[b, shift + i])]
        # a few substitutions inside the overlap
        for i in rng.integers(0, max(ov, 1), 3):
            if i < ov and rng.random() < 0.5:
                seq2[b, n2 - 1 - i] = ord("A") if seq2[b, n2 - 1 - i] != 65 else 67
    seq1[np.arange(l1)[None, :] >= rlen1[:, None]] = 0
    seq2[np.arange(l2)[None, :] >= rlen2[:, None]] = 0
    return seq1, rlen1, seq2, rlen2


def _port(seq1, rlen1, seq2, rlen2, dl, req):
    return tov.analyze(torch.as_tensor(seq1), torch.as_tensor(rlen1),
                       torch.as_tensor(seq2), torch.as_tensor(rlen2), dl, req)


def _assert_same(ref, got):
    for name, a, b in zip(ref._fields, ref, got):
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype, f"{name}: {b.dtype} vs {a.dtype}"
        assert np.array_equal(a, b), \
            f"{name}: rows {np.flatnonzero(a != b)[:8].tolist()}"


@pytest.mark.parametrize("l1,l2,dl,req", [
    (40, 40, 5, 30), (40, 64, 5, 10), (64, 64, 1, 30), (151, 151, 5, 30),
    (152, 104, 10, 30), (151, 151, 0, 30), (151, 151, 5, 60),
    (500, 300, 5, 30), (300, 500, 10, 10)])
def test_analyze_matches_jnp(l1, l2, dl, req):
    args = planted_pairs(l1 + 7 * l2 + dl, 64, l1, l2)
    ref = jov.analyze(*args[:2], *args[2:], dl, req)
    got = _port(*args, dl, req)
    _assert_same(ref, got)
    if dl > 0:
        assert got.overlapped.any() and not got.overlapped.all()


@pytest.mark.parametrize("l1,l2,dl,req,garbage", OVERLAP_EDGE_CASES)
def test_analyze_edge_cases_match_jnp(l1, l2, dl, req, garbage):
    args = edge_pairs(512, l1, l2, seed=l1 * l2 + dl + req, garbage=garbage)
    s1, r1, s2, r2 = args
    for s, r in ((s1, r1), (s2, r2)):  # the cases the batch must hold
        body = s[np.arange(s.shape[1])[None, :] < r[:, None]]
        assert set(b"acgtn.R") <= set(body.tolist())
        assert (r <= 3).sum() >= 8
    ref = jov.analyze(s1, r1, s2, r2, dl, req)
    got = _port(*args, dl, req)
    _assert_same(ref, got)
    hits = got.offset[got.overlapped].numpy()
    if dl == 0:
        assert not hits.size
    elif dl == 5:  # accepted offsets in both phases, at every residue mod 4
        assert (hits > 0).any() and (hits < 0).any()
        assert set((np.abs(hits[hits != 0]) % 4).tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("l1,l2,dl,req", [
    (40, 40, 5, 30), (64, 48, 10, 10), (48, 72, 1, 30)])
def test_analyze_matches_pallas_interpret(l1, l2, dl, req):
    args = planted_pairs(3 * l1 + l2, 64, l1, l2)
    ref = analyze_pallas2(*args, dl, req, interpret=True)
    got = _port(*args, dl, req)
    _assert_same(ref, got)


def test_reverse_complement():
    seq1, rlen1, _, _ = planted_pairs(5, 32, 40, 40)
    seq1[0, :4] = np.frombuffer(b"acgt", np.uint8)
    ref = np.asarray(jov.reverse_complement(seq1, rlen1))
    got = tov.reverse_complement(torch.as_tensor(seq1), torch.as_tensor(rlen1)).numpy()
    valid = np.arange(40)[None, :] < rlen1[:, None]
    assert np.array_equal(ref[valid], got[valid])


def test_vector_width_follows_pointer_and_row_width():
    vw = overlap_cuda.vector_width
    assert [vw(256, w) for w in (160, 152, 148, 151, 37)] == [8, 8, 1, 1, 1]
    assert [vw(256 + 8, 160), vw(256 + 4, 160), vw(256 + 2, 160)] == [8, 1, 1]


def test_select_dispatches_cpu_to_plain_and_kernel_refuses_cpu():
    seq1, rlen1, seq2, rlen2 = (torch.as_tensor(a) for a in planted_pairs(9, 16, 40, 40))
    before = overlap_cuda.launches
    got = overlap_select.analyze(seq1, rlen1, seq2, rlen2, 5, 30)
    _assert_same(tov.analyze(seq1, rlen1, seq2, rlen2, 5, 30), got)
    assert overlap_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        overlap_cuda.analyze_cuda(seq1, rlen1, seq2, rlen2, 5, 30)
