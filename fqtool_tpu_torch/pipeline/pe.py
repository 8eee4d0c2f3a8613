"""Pair-end device pipeline.

Counterpart of ``fqtool_tpu/pipeline/pe.py::pe_pipeline`` for the stages
ported so far, in the op order of ``PairEndProcessor::processPairEnd``
(reference: src/peprocessor.cpp:261-508):

  pre-stats -> trimAndCut r1/r2 -> overlap analyze (insert size) ->
  max-length resize -> passFilter -> post-stats.

Stages not ported yet (duplication keys, UMI offsets, polyG/polyX, base
correction, adapter trimming, merging, k-mer counting) raise
``NotImplementedError``.  The output dict has the keys and dtypes of the JAX
pipeline's output for the same parameters.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..config.options import KernelParams

from ..ops import filters as ops_filters
from ..ops import overlap_select as ops_overlap
from ..ops import qualcut as ops_qualcut
from ..ops import stats as ops_stats
from .device import PipelineResult, to_device


def check_ported(p: KernelParams, p2: KernelParams) -> None:
    """Raise NotImplementedError for a stage this package does not run yet."""
    stages = (("duplication analysis", p.dup_enabled),
              ("polyG trimming", p.polyg_enabled),
              ("polyX trimming", p.polyx_enabled),
              ("base correction", p.correction_enabled),
              ("adapter trimming", p.adapter_trimming_enabled),
              ("pair merging", p.merge_enabled),
              ("k-mer counting", p.kmer_len > 0))
    for name, on in stages:
        if on:
            raise NotImplementedError(f"{name} is not ported to fqtool_tpu_torch")


def pe_pipeline(seq1, qual1, lens1, seq2, qual2, lens2, keep, real,
                p: KernelParams, p2: KernelParams) -> Dict[str, object]:
    """PE per-pair pipeline on one chunk.  ``p`` carries the shared/r1
    parameters, ``p2`` the r2 force-trim parameters; ``keep`` masks pairs the
    host index filter removed, ``real`` masks padding rows."""
    check_ported(p, p2)
    out: Dict[str, object] = {}
    lens1 = lens1.to(torch.int32)
    lens2 = lens2.to(torch.int32)
    keep = keep & real

    # 1. pre-stats on raw reads (peprocessor.cpp:276-277)
    out["pre1"] = ops_stats.stat_batch(seq1, qual1, lens1, select=real)
    out["pre2"] = ops_stats.stat_batch(seq2, qual2, lens2, select=real)

    # 4. trimAndCut per side (peprocessor.cpp:292-293)
    tc1 = ops_qualcut.trim_and_cut(seq1, qual1, lens1, p.front, p.tail, p)
    tc2 = ops_qualcut.trim_and_cut(seq2, qual2, lens2, p2.front, p2.tail, p2)
    seq1, qual1 = ops_qualcut.front_align(seq1, qual1, tc1, p)
    seq2, qual2 = ops_qualcut.front_align(seq2, qual2, tc2, p2)
    rlen1, rlen2 = tc1.rlen, tc2.rlen
    drop1, drop2 = tc1.dropped, tc2.dropped
    both = ~drop1 & ~drop2

    # 6. insert-size analysis (peprocessor.cpp:329-333, statInsertSize
    #    peprocessor.cpp:510-523)
    ov = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                             p.overlap_diff_limit, p.overlap_require)
    isize = torch.where(
        ov.overlapped,
        torch.where(ov.offset > 0, rlen1 + rlen2 - ov.overlap_len, ov.overlap_len),
        p.insert_size_max)
    out["isize"] = torch.clamp(isize, max=p.insert_size_max).to(torch.int16)
    out["isize_valid"] = both
    out["len_after_adapter1"] = rlen1.to(torch.int16)
    out["len_after_adapter2"] = rlen2.to(torch.int16)

    # 8. max length resize (peprocessor.cpp:342-349)
    if p.max_len > 0:
        rlen1 = torch.where(both, torch.clamp(rlen1, max=p.max_len), rlen1)
    if p2.max_len > 0:
        rlen2 = torch.where(both, torch.clamp(rlen2, max=p2.max_len), rlen2)

    # 9. classification and post-stats of passing pairs
    result1 = ops_filters.pass_filter(seq1, qual1, rlen1, drop1, p)
    result2 = ops_filters.pass_filter(seq2, qual2, rlen2, drop2, p)
    out["result1"] = result1.to(torch.uint8)
    out["result2"] = result2.to(torch.uint8)
    sel = ((result1 == ops_filters.PASS_FILTER)
           & (result2 == ops_filters.PASS_FILTER) & keep & both)
    out["post1"] = ops_stats.stat_batch(seq1, qual1, rlen1, select=sel)
    out["post2"] = ops_stats.stat_batch(seq2, qual2, rlen2, select=sel)

    span_t = torch.int16 if max(seq1.shape[1], seq2.shape[1]) < (1 << 15) \
        else torch.int32
    out["front1"] = tc1.front.to(span_t)
    out["front2"] = tc2.front.to(span_t)
    out["rlen1"] = rlen1.to(span_t)
    out["rlen2"] = rlen2.to(span_t)
    out["dropped1"], out["dropped2"] = drop1, drop2
    return out


def pe_pipeline_call(arrays: Sequence[np.ndarray], device, p: KernelParams,
                     p2: KernelParams) -> PipelineResult:
    """Upload one chunk's planes (seq1, qual1, lens1, seq2, qual2, lens2,
    keep, real) and dispatch the pipeline on ``device``."""
    device = torch.device(device)
    out = pe_pipeline(*to_device(arrays, device), p=p, p2=p2)
    return PipelineResult(out, device)
