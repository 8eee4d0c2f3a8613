"""fqtool_tpu_torch paired-end ops against their fqtool_tpu counterparts.

``dup_keys_pe``, ``correct_by_overlap`` and ``merge_pairs`` take the same
numpy planes (``tests/torch_pairs.py::planted_pairs``: planted overlaps,
inserts shorter and longer than a read, low-quality substitutions, lengths
from 0 to the width with rows at 0-3, zero padding) through the JAX
function and the port's torch version on the CPU.  Every output is an
integer, a bool or a float32-derived byte, so every comparison is exact
(tolerance 0), dtypes and shapes included, and the correction's dead patch
slots (position -1) are compared too.  The merged planes are compared below
the merged length only: past it both packages hold bytes that no output
reads (``fqtool_tpu``'s barrel shift wraps, the port's gather clamps).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fqtool_tpu.ops import correct as jcorrect
from fqtool_tpu.ops import dup as jdup
from fqtool_tpu.ops import merge as jmerge
from fqtool_tpu.ops import overlap as joverlap
from fqtool_tpu_torch.ops import correct as tcorrect
from fqtool_tpu_torch.ops import dup as tdup
from fqtool_tpu_torch.ops import merge as tmerge
from fqtool_tpu_torch.ops import overlap as toverlap

from .test_torch_se_ops import _same, _same_tuple
from .torch_pairs import planted_pairs, random_batch

T = torch.as_tensor


def overlaps(planes, diff_limit=5, require=30):
    """The JAX and the port's overlap analyses of the planes (equal)."""
    s1, _, r1, s2, _, r2 = planes
    jov = joverlap.analyze(s1, r1, s2, r2, diff_limit, require)
    tov = toverlap.analyze(T(s1), T(r1), T(s2), T(r2), diff_limit, require)
    _same_tuple(jov, tov)
    return jov, tov


WIDTHS = [(40, 40), (152, 104), (152, 152), (300, 300)]


@pytest.mark.parametrize("L1,L2", WIDTHS)
def test_correct_by_overlap_matches_jax(L1, L2):
    planes = planted_pairs(L1 + L2, 512, L1, L2)
    jov, tov = overlaps(planes, require=min(30, L1 // 2))
    eligible = np.random.default_rng(L1).random(512) < 0.9
    s1, q1, r1, s2, q2, r2 = planes
    ref = jcorrect.correct_by_overlap(s1, q1, r1, s2, q2, r2, jov, eligible)
    got = tcorrect.correct_by_overlap(T(s1), T(q1), T(r1), T(s2), T(q2), T(r2),
                                      tov, T(eligible))
    _same_tuple(ref, got)
    pos = np.concatenate([ref.pos1, ref.pos2], axis=1)
    # corrections happened, no read took all five slots, and dead slots hold
    # the row-wide max of fqtool_tpu's packed reduction, not zeros
    assert ref.matrix.sum() > 0 and (pos == -1).any()
    assert ((np.asarray(ref.new_seq1)[np.asarray(ref.pos1) == -1]) != 0).any()


@pytest.mark.parametrize("L1,L2", WIDTHS)
def test_merge_pairs_matches_jax(L1, L2):
    planes = planted_pairs(7 * L1 + L2, 512, L1, L2)
    jov, tov = overlaps(planes, require=min(30, L1 // 2))
    s1, q1, r1, s2, q2, r2 = planes
    ref = jmerge.merge_pairs(s1, q1, r1, s2, q2, r2, jov)
    got = tmerge.merge_pairs(T(s1), T(q1), T(r1), T(s2), T(q2), T(r2), tov)
    for name in ("rlen", "len1", "len2"):
        _same(getattr(ref, name), getattr(got, name), name)
    inside = np.arange(L1 + L2)[None, :] < np.asarray(ref.rlen)[:, None]
    for name in ("seq", "qual"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a[inside], b[inside]), name
    assert (np.asarray(ref.len2) > 0).any() and np.asarray(jov.overlapped).any()


@pytest.mark.parametrize("keylen", [12, 17, 31])
@pytest.mark.parametrize("L1,L2", [(152, 104), (300, 300), (24, 40)])
def test_dup_keys_pe_matches_jax(keylen, L1, L2):
    rng = np.random.default_rng(keylen + L1)
    s1, _, r1 = random_batch(rng, 256, L1)
    s2, _, r2 = random_batch(rng, 256, L2)
    # pairs of more than 255 C/G bases wrap the reference's uint8 count
    gc = rng.choice(256, 32, replace=False)
    s1[gc, :] = np.frombuffer(b"GC", np.uint8)[rng.integers(0, 2, (32, L1))]
    s2[gc, :] = ord("C")
    r1[gc[:16]] = L1
    r2[gc[:16]] = L2
    ref = jdup.dup_keys_pe(s1, r1, s2, r2, keylen)
    got = tdup.dup_keys_pe(T(s1), T(r1), T(s2), T(r2), keylen)
    _same_tuple(ref, got)
    if min(L1, L2) >= 32:
        assert np.asarray(ref.valid).any()
