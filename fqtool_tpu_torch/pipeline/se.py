"""Single-end device pipeline.

Counterpart of ``fqtool_tpu/pipeline/se.py::se_pipeline``, in the op order
of ``SingleEndProcessor::processSingleEnd`` (reference:
src/seprocessor.cpp:290-353):

  pre-stats (+ k-mers) -> dup keys -> [index filter + UMI are host-side] ->
  UMI realignment -> trimAndCut -> polyG -> adapter-by-sequence -> polyX ->
  max-length resize -> passFilter -> post-stats (+ k-mers).

The output dict has the keys, shapes and dtypes of the JAX pipeline's output
for the same parameters; the host builds the records from the returned spans.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..config.options import KernelParams

from ..ops import adapter as ops_adapter
from ..ops import dup as ops_dup
from ..ops import filters as ops_filters
from ..ops import polyx as ops_polyx
from ..ops import qualcut as ops_qualcut
from ..ops import stats as ops_stats
from ..ops.common import align
from .device import PipelineResult, dispatch


def se_pipeline(seq, qual, lens, start0, keep, p: KernelParams,
                adapter_r1: bytes = b"", use_start0: bool = False,
                with_kmer: bool = False) -> Dict[str, object]:
    """The single-end per-read pipeline on one chunk; every row is a read.

    ``start0`` is the host-computed UMI front offset, applied when
    ``use_start0``; ``keep`` masks reads the host index filter removed (they
    count in the pre-stats only, seprocessor.cpp:304-307); ``adapter_r1`` is
    the sequence for trimBySequence ('' = none).
    """
    out: Dict[str, object] = {}
    lens = lens.to(torch.int32)

    # 1. pre-filtering stats on the raw reads (seprocessor.cpp:298)
    out["pre"] = ops_stats.stat_batch(seq, qual, lens)
    if with_kmer and p.kmer_len:
        out["pre_kmer"] = ops_stats.kmer_counts(seq, lens, p.kmer_len)

    # 2. duplication keys on the raw reads (seprocessor.cpp:300-302)
    if p.dup_enabled:
        out["dup"] = ops_dup.dup_keys_se(seq, lens, p.dup_keylen)

    # 3. UMI front-trim offsets from the host: realign each row
    if use_start0:
        seq, qual = align((seq, qual), start0)
        lens = lens - start0
    else:
        start0 = torch.zeros_like(lens)

    # 4. force trims + quality cuts (seprocessor.cpp:313)
    tc = ops_qualcut.trim_and_cut(seq, qual, lens, p.front, p.tail, p)
    seq, qual = ops_qualcut.front_align(seq, qual, tc, p)
    rlen = tc.rlen
    dropped = tc.dropped

    # 5. polyG trimming (seprocessor.cpp:316-318); skipped for dropped reads
    if p.polyg_enabled:
        pg = ops_polyx.trim_polyg(seq, rlen, p.polyg_min_len,
                                  p.polyg_max_mismatch, p.polyg_each)
        rlen = torch.where(dropped, rlen, pg.rlen)
        out["polyg_trimmed"] = pg.trimmed & ~dropped
        out["polyg_trim_len"] = pg.trim_len.to(torch.int16)

    # 6. adapter trimming by the given sequence (seprocessor.cpp:321-323)
    if p.adapter_trimming_enabled and adapter_r1:
        out["len_after_polyg"] = rlen.to(torch.int16)
        ad = ops_adapter.trim_by_sequence(seq, rlen, adapter_r1)
        rlen = torch.where(dropped, rlen, ad.rlen)
        out["adapter_found"] = ad.found & ~dropped
        out["adapter_pos"] = ad.pos.to(torch.int16)

    # 7. polyX trimming (seprocessor.cpp:326-329)
    if p.polyx_enabled:
        px = ops_polyx.trim_polyx(seq, rlen, p.polyx_trim_chr, p.polyx_min_len,
                                  p.polyx_max_mismatch, p.polyx_each)
        rlen = torch.where(dropped, rlen, px.rlen)
        out["polyx_trimmed"] = px.trimmed & ~dropped
        out["polyx_trim_len"] = px.trim_len.to(torch.int16)
        out["polyx_base"] = px.base_idx.to(torch.uint8)

    # 8. max length resize (seprocessor.cpp:332-336)
    if p.max_len > 0:
        rlen = torch.where(dropped, rlen, torch.clamp(rlen, max=p.max_len))

    # 9. pass/fail classification (seprocessor.cpp:339)
    result = ops_filters.pass_filter(seq, qual, rlen, dropped, p)
    passed = (result == ops_filters.PASS_FILTER) & keep

    # 10. post-filtering stats on passing reads (seprocessor.cpp:342-345)
    out["post"] = ops_stats.stat_batch(seq, qual, rlen, select=passed)
    if with_kmer and p.kmer_len:
        out["post_kmer"] = ops_stats.kmer_counts(seq, rlen, p.kmer_len, select=passed)

    span_t = torch.int16 if seq.shape[1] < (1 << 15) else torch.int32
    out["result"] = result.to(torch.uint8)
    out["passed"] = passed
    out["front"] = (start0 + tc.front).to(span_t)
    out["rlen"] = rlen.to(span_t)
    out["dropped"] = dropped
    return out


def se_pipeline_call(arrays: Sequence[np.ndarray], device, p: KernelParams,
                     adapter_r1: bytes = b"", use_start0: bool = False,
                     with_kmer: bool = False) -> PipelineResult:
    """Upload one chunk's planes (seq, qual, lens, start0, keep) and dispatch
    the pipeline on ``device``."""
    return dispatch(se_pipeline, arrays, device, p=p, adapter_r1=adapter_r1,
                    use_start0=use_start0, with_kmer=with_kmer)
