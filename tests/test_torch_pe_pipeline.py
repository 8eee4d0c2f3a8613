"""fqtool_tpu_torch ``pe_pipeline`` against ``fqtool_tpu``'s on one chunk.

The same planes (planted-overlap pairs that run into the TruSeq adapters,
low-quality substitutions for the base correction, trimmed lengths, widths
that differ between the mates) go through JAX ``pe_pipeline.__wrapped__``
and the port on the CPU, with the KernelParams ``parse_args`` derives for
the argv and the run arguments the runners derive from the options
(``pipeline_args``, applied to each package's parsed options).  The
output dicts must agree key for key, dtype for dtype, value for value
(tolerance 0: every output is an integer, a bool or a float32-derived byte),
dead correction-patch slots included.  JAX gets ``real`` all true and no
static UMI offset, since its static slice pads with zeros where the per-row
shift of both packages wraps (which changes only bytes past the lengths,
but those reach the dead patch slots).
"""

from __future__ import annotations

import numpy as np
import pytest

from fqtool_tpu.config import cli as jcli
from fqtool_tpu.pipeline.pe import pe_pipeline as jax_pe_pipeline
from fqtool_tpu_torch.ops.stats import BatchStats
from fqtool_tpu_torch.pipeline import pe as tpe
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy, to_device
from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args

from .torch_pairs import (ADAPTER_R1, ADAPTER_R2, _options, make_pairs,
                          plant_low_quality)

PE = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq"]
AD = ["--adapter_of_read1", ADAPTER_R1.decode(),
      "--adapter_of_read2", ADAPTER_R2.decode()]


def chunk(seed: int, B: int = 256):
    """Planes as a pack would hold them: widths rounded to 8, lengths cut
    short on some rows (0-3 on a few), zero padding past each length."""
    rng = np.random.default_rng(seed)
    s1, q1, s2, q2, _ = make_pairs(B, seed, 151, adapters=True)
    plant_low_quality(s1, q1, rng)
    plant_low_quality(s2, q2, rng)
    l1 = np.full(B, 151, np.int32)
    l2 = np.full(B, 100, np.int32)
    short = rng.random(B) < 0.3
    l1[short] = rng.integers(0, 152, short.sum())
    l2[short] = rng.integers(0, 101, short.sum())
    l1[:4] = np.arange(4)
    l2[4:8] = np.arange(4)
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
    # UMI offsets as process_umi gives them: within each read's length
    start1 = np.minimum(rng.integers(0, 9, B), l1).astype(np.int32)
    start2 = np.minimum(rng.integers(0, 9, B), l2).astype(np.int32)
    return planes, start1, start2, keep


def assert_same_outputs(ref: dict, got: dict) -> None:
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, tuple):
            assert type(g).__name__ == type(r).__name__ and g._fields == r._fields, key
            pairs = [(f"{key}.{f}", a, b) for f, a, b in zip(r._fields, r, g)]
        else:
            pairs = [(key, r, g)]
        for name, a, b in pairs:
            if a is None:
                assert b is None, name
                continue
            a = np.asarray(a)
            assert b.dtype == a.dtype and b.shape == a.shape, \
                f"{name}: {b.dtype}{b.shape} vs {a.dtype}{a.shape}"
            assert np.array_equal(a, b), \
                f"{name}: first diffs at {np.argwhere(a != b)[:5].tolist()}"


# each stage alone, then the bench.py configurations and the CLI sets of the
# paired-end tests
CASES = {
    "qualtrim": ["-q", "-f", "3", "-t", "2"],
    "cut-length-complexity": [
        "-q", "-F", "2", "-T", "5", "--enable_cut_front", "--enable_cut_right",
        "-l", "--min_length", "40", "--max_length", "140", "-y", "-b", "120",
        "-B", "90", "--min_overlap_len", "20", "--max_diff_for_overlap", "3"],
    "cut-tail-meanqual": ["--enable_cut_tail", "-e", "28", "-q", "-y", "-Y", "0.4",
                          "-f", "1"],
    "polyg": ["-g"],
    "polyx": ["-x"],
    "correction": ["-c"],
    "adapter-overlap": ["-a"],
    "adapter-sequences": ["-a", *AD],
    "adapter-read1-only": ["-a", "--adapter_of_read1", ADAPTER_R1.decode()],
    "dup": ["-d", "--dup_ana_key_len", "17"],
    "kmer": ["--kmer", "--kmer_length", "5"],
    "merge": ["-m", "--merge_output", "m.fq"],
    "pe_merge_corr": ["-m", "--merge_output", "merged.fq.gz", "-c"],
    "pe_full": ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                "--detect_pe_adapter"],
    "golden-random-all": ["-q", "-a", "-c", "-g"],
    "golden-random-merge": ["-m", "--merge_output", "merged.fq.gz", "-c", "-x"],
    "discard-unmerged": ["-m", "--merge_output", "m.fq", "--discard_unmerged",
                         "-c", "--kmer", "--kmer_length", "4"],
    "umi-read1": ["-u", "--umi_location", "3", "--umi_length", "8", "-q"],
    "umi-per-read-all": ["-u", "--umi_location", "6", "--umi_length", "8", "-m",
                         "--merge_output", "m.fq", "-c", "-a", *AD, "-g", "-x",
                         "-d", "--kmer", "--enable_cut_front", "--cut_front_window",
                         "3"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_pe_pipeline_matches_jax(name):
    flags = CASES[name]
    planes, start1, start2, keep = chunk(len(name))
    jopt = _options(PE + flags, jcli)
    opt = _options(PE + flags)
    kw = pipeline_args(opt)
    assert kw == pipeline_args(jopt)
    B = len(keep)
    ref = jax_pe_pipeline.__wrapped__(
        *planes, start1, start2, keep, np.ones(B, bool),
        p=jopt.kernel_params(is_r2=False), p2=jopt.kernel_params(is_r2=True),
        **kw)
    got = outputs_to_numpy(tpe.pe_pipeline(
        *to_device(planes + [start1, start2, keep], "cpu"),
        p=opt.kernel_params(is_r2=False), p2=opt.kernel_params(is_r2=True), **kw))
    assert_same_outputs(ref, got)
    p = opt.kernel_params()
    assert ref["isize"].min() < p.insert_size_max  # overlaps were found
    if p.correction_enabled:
        pos = np.concatenate([ref["corr_pos1"], ref["corr_pos2"]], axis=1)
        # live and dead patch slots were both compared
        assert ref["correction_matrix"].sum() > 0 and (pos == -1).any()
    if p.merge_enabled:
        assert ref["mergeable"].any()
    if kw["adapter_r1"]:
        assert ref["adapter_found1"].any()


def test_pipeline_result_handle_on_cpu():
    planes, start1, start2, keep = chunk(0, 64)
    opt = _options(PE + ["-q", "-c", "-m", "--merge_output", "m.fq"])
    res = tpe.pe_pipeline_call(planes + [start1, start2, keep], "cpu",
                               opt.kernel_params(is_r2=False),
                               opt.kernel_params(is_r2=True), **pipeline_args(opt))
    out = res.get()
    assert out["result1"].dtype == np.uint8 and out["result1"].shape == (64,)
    assert out["corr_pos1"].shape == (64, 5) and out["corr_pos1"].dtype == np.int16
    assert isinstance(out["pre1"], BatchStats) and isinstance(out["postM"], BatchStats)
