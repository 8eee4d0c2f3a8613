"""fqtool_tpu_torch ``pe_pipeline`` against ``fqtool_tpu``'s on one chunk.

The same planes (planted-overlap pairs with trimmed lengths, widths that
differ between the mates) go through JAX ``pe_pipeline.__wrapped__`` and the
port on the CPU, with the KernelParams ``parse_args`` derives for the argv.
The output dicts must agree key for key, dtype for dtype, value for value.
"""

from __future__ import annotations

import numpy as np
import pytest

from fqtool_tpu.config import cli as jcli
from fqtool_tpu.pipeline.pe import pe_pipeline as jax_pe_pipeline
from fqtool_tpu_torch.ops.stats import BatchStats
from fqtool_tpu_torch.pipeline import pe as tpe
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy, to_device

from .torch_pairs import kernel_params, make_pairs


def chunk(seed: int, B: int = 256):
    """Planes as a pack would hold them: widths rounded to 8, lengths cut
    short on some rows, zero padding past each length, one masked row."""
    rng = np.random.default_rng(seed)
    s1, q1, s2, q2, _ = make_pairs(B, seed, 151)
    l1 = np.full(B, 151, np.int32)
    l2 = np.full(B, 100, np.int32)
    short = rng.random(B) < 0.3
    l1[short] = rng.integers(0, 152, short.sum())
    l2[short] = rng.integers(0, 101, short.sum())
    planes = []
    for s, q, ln, w in ((s1, q1, l1, 152), (s2[:, :100], q2[:, :100], l2, 104)):
        seq = np.zeros((B, w), np.uint8)
        qual = np.zeros((B, w), np.uint8)
        seq[:, : s.shape[1]] = s
        qual[:, : q.shape[1]] = q
        pad = np.arange(w)[None, :] >= ln[:, None]
        seq[pad] = 0
        qual[pad] = 0
        planes += [seq, qual, ln]
    keep = rng.random(B) < 0.95
    real = np.ones(B, bool)
    real[-1] = False
    return planes, keep, real


@pytest.mark.parametrize("flags", [
    ("-q", "-f", "3", "-t", "2"),
    ("-q", "-F", "2", "-T", "5", "--enable_cut_front", "--enable_cut_right",
     "-l", "--min_length", "40", "--max_length", "140", "-y", "-b", "120",
     "-B", "90", "--min_overlap_len", "20", "--max_diff_for_overlap", "3"),
    ("--enable_cut_tail", "-e", "28", "-q", "-y", "-Y", "0.4", "-f", "1"),
], ids=["qualtrim", "cut-length-complexity", "cut-tail-meanqual"])
def test_pe_pipeline_matches_jax(flags):
    planes, keep, real = chunk(len(flags))
    jp, jp2 = kernel_params(*flags, cli=jcli)
    p, p2 = kernel_params(*flags)
    B = len(keep)
    zeros = np.zeros(B, np.int32)
    ref = jax_pe_pipeline.__wrapped__(*planes, zeros, zeros, keep, real, p=jp, p2=jp2)
    got = outputs_to_numpy(tpe.pe_pipeline(
        *to_device(planes + [keep, real], "cpu"), p=p, p2=p2))
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, tuple):
            assert isinstance(g, BatchStats) and g._fields == r._fields, key
            pairs = zip((f"{key}.{f}" for f in r._fields), r, g)
        else:
            pairs = [(key, r, g)]
        for name, a, b in pairs:
            a = np.asarray(a)
            assert b.dtype == a.dtype and b.shape == a.shape, \
                f"{name}: {b.dtype}{b.shape} vs {a.dtype}{a.shape}"
            assert np.array_equal(a, b), \
                f"{name}: first diffs at {np.argwhere(a != b)[:5].tolist()}"
    assert ref["isize"].min() < p.insert_size_max  # overlaps were found


def test_pipeline_result_handle_on_cpu():
    planes, keep, real = chunk(0, 64)
    p, p2 = kernel_params("-q")
    res = tpe.pe_pipeline_call(planes + [keep, real], "cpu", p, p2)
    out = res.get()
    assert out["result1"].dtype == np.uint8 and out["result1"].shape == (64,)
    assert isinstance(out["pre1"], BatchStats)


@pytest.mark.parametrize("flag", ["-g", "-x", "-c", "-a", "-d", "--kmer"])
def test_unported_stage_raises(flag):
    planes, keep, real = chunk(0, 16)
    extra = ("--kmer_length", "5") if flag == "--kmer" else ()
    p, p2 = kernel_params(flag, *extra)
    with pytest.raises(NotImplementedError):
        tpe.pe_pipeline(*to_device(planes + [keep, real], "cpu"), p=p, p2=p2)
