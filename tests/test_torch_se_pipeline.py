"""fqtool_tpu_torch ``se_pipeline`` against ``fqtool_tpu``'s on one chunk.

The same planes (synthetic reads with adapter and polyG tails, lengths cut
short on some rows, zero padding, index-filtered rows) go through JAX
``se_pipeline.__wrapped__`` and the port on the CPU, with the KernelParams
``parse_args`` derives for the argv.  The port has no padded rows, so JAX
gets an all-true ``real`` mask; a uniform UMI offset takes JAX's static
shift and the port's per-row one.  The output dicts must agree key for key,
dtype for dtype, value for value (tolerance 0).
"""

from __future__ import annotations

import numpy as np
import pytest

from fqtool_tpu.config import cli as jcli
from fqtool_tpu.pipeline.se import se_pipeline as jax_se_pipeline
from fqtool_tpu_torch.pipeline import se as tse
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy, to_device

from .torch_pairs import kernel_params_se
from .torch_reads import ADAPTER, make_reads


def chunk(seed: int, B: int = 256, W: int = 152):
    """Planes as a pack holds them: width rounded to 8, some lengths cut,
    zero padding past each length; a few index-filtered rows."""
    rng = np.random.default_rng(seed)
    s, q, _ = make_reads(B, seed)
    lens = np.full(B, 151, np.int32)
    short = rng.random(B) < 0.3
    lens[short] = rng.integers(0, 152, short.sum())
    seq = np.zeros((B, W), np.uint8)
    qual = np.zeros((B, W), np.uint8)
    seq[:, :151] = s
    qual[:, :151] = q
    pad = np.arange(W)[None, :] >= lens[:, None]
    seq[pad] = 0
    qual[pad] = 0
    keep = rng.random(B) < 0.95
    return seq, qual, lens, keep


ALL = ("-q", "-g", "-x", "-a", "--adapter_of_read1", ADAPTER.decode(), "-d",
       "--kmer", "--kmer_length", "6", "--failed_out", "f.fq")
# (flags, adapter, UMI offset: None, a uniform int, or "rows")
CASES = {
    "qualtrim": (("-q", "-f", "3", "-t", "2"), b"", None),
    "polygx": (("-g", "-x"), b"", None),
    "adapter": (("-a", "--adapter_of_read1", ADAPTER.decode()), ADAPTER, None),
    "all": (ALL, ADAPTER, None),
    "all-cuts-maxlen": (ALL + ("--enable_cut_front", "--enable_cut_tail",
                               "-b", "120", "-f", "2"), ADAPTER, None),
    "umi-static": (("-q", "-g", "-d", "--dup_ana_key_len", "17"), b"", 8),
    "umi-rows": (("-q", "-x", "--base_to_trim", "GT", "--enable_cut_front",
                  "-l", "--min_length", "30", "-y"), b"", "rows"),
    "umi-rows-adapter": (("-a", "--adapter_of_read1", "AGATCGGAAGAG", "-f", "4",
                          "--kmer", "--kmer_length", "4"), b"AGATCGGAAGAG", "rows"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_se_pipeline_matches_jax(name):
    flags, adapter, umi = CASES[name]
    seq, qual, lens, keep = chunk(len(name))
    p = kernel_params_se(*flags)
    B = len(lens)
    start0 = np.zeros(B, np.int32)
    static = -1
    if umi == "rows":
        start0 = np.minimum(np.random.default_rng(1).integers(0, 12, B), lens)
        start0 = start0.astype(np.int32)
    elif umi is not None:
        start0 = np.full(B, umi, np.int32)
        static = umi
    kw = dict(adapter_r1=adapter, use_start0=umi is not None,
              with_kmer=p.kmer_len > 0)
    ref = jax_se_pipeline.__wrapped__(seq, qual, lens, start0, keep,
                                      np.ones(B, bool), start0_static=static,
                                      p=kernel_params_se(*flags, cli=jcli), **kw)
    got = outputs_to_numpy(tse.se_pipeline(
        *to_device([seq, qual, lens, start0, keep], "cpu"), p=p, **kw))
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, tuple):
            assert type(g).__name__ == type(r).__name__ and g._fields == r._fields
            pairs = zip((f"{key}.{f}" for f in r._fields), r, g)
        else:
            pairs = [(key, r, g)]
        for field, a, b in pairs:
            if a is None:
                assert b is None, field
                continue
            a = np.asarray(a)
            assert b.dtype == a.dtype and b.shape == a.shape, \
                f"{field}: {b.dtype}{b.shape} vs {a.dtype}{a.shape}"
            assert np.array_equal(a, b), \
                f"{field}: first diffs at {np.argwhere(a != b)[:5].tolist()}"


def test_se_pipeline_call_handle_on_cpu():
    seq, qual, lens, keep = chunk(0, 64)
    p = kernel_params_se(*ALL)
    zeros = np.zeros(64, np.int32)
    out = tse.se_pipeline_call([seq, qual, lens, zeros, keep], "cpu", p,
                               adapter_r1=ADAPTER, with_kmer=True).get()
    assert out["result"].dtype == np.uint8 and out["result"].shape == (64,)
    assert out["dup"].key_hi is None and out["dup"].kmer_hi.dtype == np.uint32
    assert out["pre_kmer"].shape == (4 ** 6,)
    assert out["adapter_found"].any() and out["polyg_trimmed"].any()
