"""fqtool_tpu_torch per-read stages against their fqtool_tpu counterparts.

The same numpy batches (random, with rlen 0, N runs, homopolymers and
qualities at '!' and 'J'+) go through the JAX function and the port's
torch version on the CPU.  Every output is an integer (or a bool), and the
two float32 ratio tests of pass_filter are written as in JAX, so every
comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fqtool_tpu.config import cli as jcli
from fqtool_tpu.ops import filters as jfilters
from fqtool_tpu.ops import qualcut as jqualcut
from fqtool_tpu.ops import stats as jstats
from fqtool_tpu_torch.ops import filters as tfilters
from fqtool_tpu_torch.ops import qualcut as tqualcut
from fqtool_tpu_torch.ops import stats as tstats

from .torch_pairs import kernel_params, random_batch


def _same(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} vs {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}"
    assert np.array_equal(got, ref), f"{what}: first diff at " \
        f"{np.argwhere(got != ref)[:5].tolist()}"


@pytest.mark.parametrize("seed,select", [(0, False), (1, True), (2, True)])
def test_stat_batch(seed, select):
    rng = np.random.default_rng(seed)
    seq, qual, rlen = random_batch(rng, 256, 152)
    sel = rng.random(256) < 0.7 if select else None
    ref = jstats.stat_batch(seq, qual, rlen, sel)
    got = tstats.stat_batch(torch.as_tensor(seq), torch.as_tensor(qual),
                            torch.as_tensor(rlen),
                            None if sel is None else torch.as_tensor(sel))
    assert got._fields == ref._fields
    for name, a, b in zip(ref._fields, ref, got):
        _same(a, b, name)


TRIM_FLAGS = [
    ("-f", "3", "-t", "2"),
    ("--enable_cut_front",),
    ("--enable_cut_front", "-f", "5", "-t", "3", "--cut_front_window", "6"),
    ("--enable_cut_right",),
    ("--enable_cut_right", "-f", "2", "-t", "4", "--cut_right_window", "8"),
    ("--enable_cut_tail",),
    ("--enable_cut_tail", "-f", "4", "-t", "1", "--cut_tail_mean_qual", "28"),
    ("--enable_cut_front", "--enable_cut_tail", "-f", "1", "-t", "1"),
    ("--enable_cut_front", "--enable_cut_right", "--cut_front_mean_qual", "30"),
]


@pytest.mark.parametrize("flags", TRIM_FLAGS, ids=" ".join)
def test_trim_and_cut(flags):
    rng = np.random.default_rng(len(flags))
    seq, qual, rlen = random_batch(rng, 256, 152)
    for jp, pp in zip(kernel_params(*flags, cli=jcli), kernel_params(*flags)):
        ref = jqualcut.trim_and_cut(seq, qual, rlen, jp.front, jp.tail, jp)
        got = tqualcut.trim_and_cut(torch.as_tensor(seq), torch.as_tensor(qual),
                                    torch.as_tensor(rlen), pp.front, pp.tail, pp)
        for name, a, b in zip(ref._fields, ref, got):
            _same(a, b, name)


FILTER_FLAGS = [
    ("-q",),
    ("-q", "-e", "25"),
    ("-q", "-N", "2", "-Q", "25", "-U", "0.3"),
    ("-l", "--min_length", "50"),
    ("-l", "--max_length", "100"),
    ("-y",),
    ("-y", "-Y", "0.5"),
    ("-q", "-e", "30", "-l", "-y", "-Y", "0.6", "--max_length", "120"),
]


@pytest.mark.parametrize("flags", FILTER_FLAGS, ids=" ".join)
def test_pass_filter(flags):
    rng = np.random.default_rng(10 + len(flags))
    seq, qual, rlen = random_batch(rng, 256, 152)
    dropped = rng.random(256) < 0.1
    jp, _ = kernel_params(*flags, cli=jcli)
    p, _ = kernel_params(*flags)
    ref = jfilters.pass_filter(seq, qual, rlen, dropped, jp)
    got = tfilters.pass_filter(torch.as_tensor(seq), torch.as_tensor(qual),
                               torch.as_tensor(rlen), torch.as_tensor(dropped), p)
    _same(ref, got, "result")
    assert len(np.unique(np.asarray(ref))) > 1  # the batch exercises the filter


def test_filter_codes_match():
    assert tfilters.FAILED_TYPES == jfilters.FAILED_TYPES
    for name in ("PASS_FILTER", "FAIL_POLY_X", "FAIL_OVERLAP", "FAIL_N_BASE",
                 "FAIL_LENGTH", "FAIL_TOO_LONG", "FAIL_QUALITY",
                 "FAIL_COMPLEXITY", "FILTER_RESULT_TYPES"):
        assert getattr(tfilters, name) == getattr(jfilters, name), name
