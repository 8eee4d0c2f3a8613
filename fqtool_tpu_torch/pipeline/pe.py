"""Pair-end device pipeline.

Counterpart of ``fqtool_tpu/pipeline/pe.py::pe_pipeline``, in the op order of
``PairEndProcessor::processPairEnd`` (reference: src/peprocessor.cpp:261-508):

  pre-stats (+ k-mers) -> dup keys -> [host: index filter + UMI] -> UMI
  realignment -> trimAndCut r1/r2 -> polyG (argument-swap quirk Q4) ->
  overlap analyze -> insert size -> base correction -> adapter trim
  (overlap, then by-sequence fallback) -> polyX -> max-length resize ->
  merge / passFilter routing -> post-stats (+ k-mers).

The output dict has the keys, shapes and dtypes of the JAX pipeline's output
for the same parameters; the host builds the records from the returned spans
and correction patches.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..config.options import KernelParams

from ..ops import adapter as ops_adapter
from ..ops import correct as ops_correct
from ..ops import dup as ops_dup
from ..ops import filters as ops_filters
from ..ops import merge as ops_merge
from ..ops import overlap_select as ops_overlap
from ..ops import polyx as ops_polyx
from ..ops import qualcut as ops_qualcut
from ..ops import stats as ops_stats
from ..ops.common import align
from .device import PipelineResult, dispatch


def pe_pipeline(seq1, qual1, lens1, seq2, qual2, lens2, start1, start2, keep,
                p: KernelParams, p2: KernelParams, adapter_r1: bytes = b"",
                adapter_r2: bytes = b"", use_start0: bool = False,
                with_kmer: bool = False,
                discard_unmerged: bool = False) -> Dict[str, object]:
    """PE per-pair pipeline on one chunk; every row is a pair.  ``p`` carries
    the shared/r1 parameters, ``p2`` the r2 force-trim parameters;
    ``start1``/``start2`` are the host-computed UMI front offsets, applied
    when ``use_start0``; ``keep`` masks pairs the host index filter removed;
    ``adapter_r1``/``adapter_r2`` are the sequences of the by-sequence
    fallback ('' = none)."""
    out: Dict[str, object] = {}
    lens1 = lens1.to(torch.int32)
    lens2 = lens2.to(torch.int32)
    kmer = with_kmer and p.kmer_len

    # 1. pre-stats on raw reads (peprocessor.cpp:276-277)
    out["pre1"] = ops_stats.stat_batch(seq1, qual1, lens1)
    out["pre2"] = ops_stats.stat_batch(seq2, qual2, lens2)
    if kmer:
        out["pre1_kmer"] = ops_stats.kmer_counts(seq1, lens1, p.kmer_len)
        out["pre2_kmer"] = ops_stats.kmer_counts(seq2, lens2, p.kmer_len)

    # 2. duplication keys (peprocessor.cpp:279-281)
    if p.dup_enabled:
        out["dup"] = ops_dup.dup_keys_pe(seq1, lens1, seq2, lens2, p.dup_keylen)

    # 3. UMI front-trim offsets from the host: realign each row
    if use_start0:
        seq1, qual1 = align((seq1, qual1), start1)
        seq2, qual2 = align((seq2, qual2), start2)
        lens1 = lens1 - start1
        lens2 = lens2 - start2
    else:
        start1 = start2 = torch.zeros_like(lens1)

    # 4. trimAndCut per side (peprocessor.cpp:292-293)
    tc1 = ops_qualcut.trim_and_cut(seq1, qual1, lens1, p.front, p.tail, p)
    tc2 = ops_qualcut.trim_and_cut(seq2, qual2, lens2, p2.front, p2.tail, p2)
    seq1, qual1 = ops_qualcut.front_align(seq1, qual1, tc1, p)
    seq2, qual2 = ops_qualcut.front_align(seq2, qual2, tc2, p2)
    rlen1, rlen2 = tc1.rlen, tc2.rlen
    drop1, drop2 = tc1.dropped, tc2.dropped
    both = ~drop1 & ~drop2

    # 5. polyG with the PE argument swap (quirk Q4, peprocessor.cpp:297):
    #    compareReq <- maxMismatch, maxMismatch <- each, each <- minLen
    if p.polyg_enabled:
        pg1 = ops_polyx.trim_polyg(seq1, rlen1, compare_req=p.polyg_max_mismatch,
                                   max_mismatch=p.polyg_each, each=p.polyg_min_len)
        pg2 = ops_polyx.trim_polyg(seq2, rlen2, compare_req=p.polyg_max_mismatch,
                                   max_mismatch=p.polyg_each, each=p.polyg_min_len)
        for side, pg in ((1, pg1), (2, pg2)):
            out[f"polyg_trimmed{side}"] = pg.trimmed & both
            out[f"polyg_trim_len{side}"] = pg.trim_len.to(torch.int16)
        rlen1 = torch.where(both, pg1.rlen, rlen1)
        rlen2 = torch.where(both, pg2.rlen, rlen2)

    # 6. overlap analysis -> insert size (peprocessor.cpp:300-333,
    #    statInsertSize peprocessor.cpp:510-523) -> correction -> adapters
    ov = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                             p.overlap_diff_limit, p.overlap_require)
    isize = torch.where(
        ov.overlapped,
        torch.where(ov.offset > 0, rlen1 + rlen2 - ov.overlap_len, ov.overlap_len),
        p.insert_size_max)
    out["isize"] = torch.clamp(isize, max=p.insert_size_max).to(torch.int16)
    out["isize_valid"] = both
    if p.correction_enabled:
        # index-filtered pairs are skipped before correction in the reference
        # (peprocessor.cpp:283-286): they count no corrections
        cr = ops_correct.correct_by_overlap(seq1, qual1, rlen1, seq2, qual2,
                                            rlen2, ov, both & keep)
        seq1, qual1, seq2, qual2 = cr.seq1, cr.qual1, cr.seq2, cr.qual2
        out["corrected1"] = cr.corrected1.to(torch.uint8)
        out["corrected2"] = cr.corrected2.to(torch.uint8)
        out["correction_matrix"] = cr.matrix
        # sparse patches: the host applies them to its pack copies
        out["corr_pos1"], out["corr_seq1"], out["corr_qual1"] = \
            cr.pos1.to(torch.int16), cr.new_seq1, cr.new_qual1
        out["corr_pos2"], out["corr_seq2"], out["corr_qual2"] = \
            cr.pos2.to(torch.int16), cr.new_seq2, cr.new_qual2
    if p.adapter_trimming_enabled:
        # overlap-based trim first (adaptertrimmer.cpp:14-27)
        ov_trim = (both & (ov.diff <= 5) & ov.overlapped & (ov.offset < 0)
                   & (ov.overlap_len > torch.div(rlen1, 3, rounding_mode="floor")))
        out["ov_trimmed"] = ov_trim
        out["len1_before_ov_trim"] = rlen1.to(torch.int16)
        out["len2_before_ov_trim"] = rlen2.to(torch.int16)
        rlen1 = torch.where(ov_trim, ov.overlap_len, rlen1)
        rlen2 = torch.where(ov_trim, ov.overlap_len, rlen2)
        # by-sequence fallback when not trimmed (peprocessor.cpp:318-325)
        use = both & ~ov_trim
        if adapter_r1:
            ad1 = ops_adapter.trim_by_sequence(seq1, rlen1, adapter_r1)
            rlen1 = torch.where(use, ad1.rlen, rlen1)
            out["adapter_found1"] = ad1.found & use
            out["adapter_pos1"] = ad1.pos.to(torch.int16)
        if adapter_r2:
            ad2 = ops_adapter.trim_by_sequence(seq2, rlen2, adapter_r2)
            rlen2 = torch.where(use, ad2.rlen, rlen2)
            out["adapter_found2"] = ad2.found & use
            out["adapter_pos2"] = ad2.pos.to(torch.int16)
    out["len_after_adapter1"] = rlen1.to(torch.int16)
    out["len_after_adapter2"] = rlen2.to(torch.int16)

    # 7. polyX (peprocessor.cpp:335-340)
    if p.polyx_enabled:
        px1 = ops_polyx.trim_polyx(seq1, rlen1, p.polyx_trim_chr, p.polyx_min_len,
                                   p.polyx_max_mismatch, p.polyx_each)
        px2 = ops_polyx.trim_polyx(seq2, rlen2, p.polyx_trim_chr, p.polyx_min_len,
                                   p.polyx_max_mismatch, p.polyx_each)
        for side, px in ((1, px1), (2, px2)):
            out[f"polyx_trimmed{side}"] = px.trimmed & both
            out[f"polyx_trim_len{side}"] = px.trim_len.to(torch.int16)
            out[f"polyx_base{side}"] = px.base_idx.to(torch.uint8)
        rlen1 = torch.where(both, px1.rlen, rlen1)
        rlen2 = torch.where(both, px2.rlen, rlen2)

    # 8. max length resize (peprocessor.cpp:342-349)
    if p.max_len > 0:
        rlen1 = torch.where(both, torch.clamp(rlen1, max=p.max_len), rlen1)
    if p2.max_len > 0:
        rlen2 = torch.where(both, torch.clamp(rlen2, max=p2.max_len), rlen2)

    # 9. classification and post-stats
    result1 = ops_filters.pass_filter(seq1, qual1, rlen1, drop1, p)
    result2 = ops_filters.pass_filter(seq2, qual2, rlen2, drop2, p)
    out["result1"] = result1.to(torch.uint8)
    out["result2"] = result2.to(torch.uint8)
    pass1 = result1 == ops_filters.PASS_FILTER
    pass2 = result2 == ops_filters.PASS_FILTER

    if p.merge_enabled:
        # fresh overlap analysis on the final reads (peprocessor.cpp:354)
        ov2 = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                                  p.overlap_diff_limit, p.overlap_require)
        mergeable = both & ov2.overlapped
        mg = ops_merge.merge_pairs(seq1, qual1, rlen1, seq2, qual2, rlen2, ov2)
        resultM = ops_filters.pass_filter(mg.seq, mg.qual, mg.rlen,
                                          torch.zeros_like(mergeable), p)
        out["mergeable"] = mergeable
        out["resultM"] = resultM.to(torch.uint8)
        out["merged_len1"] = mg.len1.to(torch.int16)
        out["merged_len2"] = mg.len2.to(torch.int16)
        out["merged_rlen"] = mg.rlen.to(torch.int16)
        sel_m = mergeable & (resultM == ops_filters.PASS_FILTER) & keep
        # unmerged kept reads are statted one by one (peprocessor.cpp:367-379)
        keep_unmerged = (torch.zeros_like(mergeable) if discard_unmerged
                         else both & ~mergeable & keep)
        sel1 = keep_unmerged & pass1
        sel2 = keep_unmerged & pass2
        out["postM"] = ops_stats.stat_batch(mg.seq, mg.qual, mg.rlen, select=sel_m)
        out["post1"] = ops_stats.stat_batch(seq1, qual1, rlen1, select=sel1)
        out["post2"] = ops_stats.stat_batch(seq2, qual2, rlen2, select=sel2)
        if kmer:
            out["postM_kmer"] = ops_stats.kmer_counts(mg.seq, mg.rlen, p.kmer_len,
                                                      select=sel_m)
            out["post1_kmer"] = ops_stats.kmer_counts(seq1, rlen1, p.kmer_len,
                                                      select=sel1)
            out["post2_kmer"] = ops_stats.kmer_counts(seq2, rlen2, p.kmer_len,
                                                      select=sel2)
        # the overlap length feeds the host's merged-record assembly
        out["merged_ol"] = ov2.overlap_len.to(torch.int16)
    else:
        sel = pass1 & pass2 & keep & both
        out["post1"] = ops_stats.stat_batch(seq1, qual1, rlen1, select=sel)
        out["post2"] = ops_stats.stat_batch(seq2, qual2, rlen2, select=sel)
        if kmer:
            out["post1_kmer"] = ops_stats.kmer_counts(seq1, rlen1, p.kmer_len,
                                                      select=sel)
            out["post2_kmer"] = ops_stats.kmer_counts(seq2, rlen2, p.kmer_len,
                                                      select=sel)

    span_t = torch.int16 if max(seq1.shape[1], seq2.shape[1]) < (1 << 15) \
        else torch.int32
    out["front1"] = (start1 + tc1.front).to(span_t)
    out["front2"] = (start2 + tc2.front).to(span_t)
    out["rlen1"] = rlen1.to(span_t)
    out["rlen2"] = rlen2.to(span_t)
    out["dropped1"], out["dropped2"] = drop1, drop2
    return out


def pe_pipeline_call(arrays: Sequence[np.ndarray], device, p: KernelParams,
                     p2: KernelParams, adapter_r1: bytes = b"",
                     adapter_r2: bytes = b"", use_start0: bool = False,
                     with_kmer: bool = False,
                     discard_unmerged: bool = False) -> PipelineResult:
    """Upload one chunk's planes (seq1, qual1, lens1, seq2, qual2, lens2,
    start1, start2, keep) and dispatch the pipeline on ``device``."""
    return dispatch(pe_pipeline, arrays, device, p=p, p2=p2,
                    adapter_r1=adapter_r1, adapter_r2=adapter_r2,
                    use_start0=use_start0, with_kmer=with_kmer,
                    discard_unmerged=discard_unmerged)
