# Copy of fqtool_tpu/host/filterresult.py, unchanged: its relative imports reach
# the port's own ops/filters.py, where the original's reach JAX.
"""Host-side filtering-result accumulator.

Mirrors ``FilterResult`` (reference: src/filterresult.h/.cpp): 32-slot
read-fate counters, adapter trim counts + per-sequence maps, polyX trim
counters, the 8x8 correction matrix, and merged-pair count, plus the JSON
report fragments.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np

from ..ops.filters import FILTER_RESULT_TYPES, PASS_FILTER, FAIL_QUALITY, \
    FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY


class FilterResultAccumulator:
    def __init__(self, opt, paired: bool):
        self.opt = opt
        self.paired = paired
        self.filter_read_stats = np.zeros(FILTER_RESULT_TYPES, np.int64)
        self.trimmed_adapter_reads = 0
        self.trimmed_adapter_bases = 0
        self.adapter1_count: Counter = Counter()
        self.adapter2_count: Counter = Counter()
        self.trimmed_polyx_reads = np.zeros(5, np.int64)
        self.trimmed_polyx_bases = np.zeros(5, np.int64)
        self.correction_matrix = np.zeros(64, np.int64)
        self.corrected_reads = 0
        self.merged_pairs = 0

    # ------------------------------------------------------------------
    def add_filter_results(self, results: np.ndarray, n_each: int) -> None:
        """Vector add of per-read result codes; ``n_each`` is 1 for SE, 2 for
        paired adds (filterresult.cpp:25-34)."""
        counts = np.bincount(results, minlength=FILTER_RESULT_TYPES)
        self.filter_read_stats += counts[:FILTER_RESULT_TYPES] * n_each

    def add_filter_result(self, result: int, n: int) -> None:
        if 0 <= result < FILTER_RESULT_TYPES:
            self.filter_read_stats[result] += n

    def add_adapter_trimmed(self, adapter: bytes, is_r2: bool) -> None:
        """filterresult.cpp:138-157 -- empty adapters are ignored."""
        if not adapter:
            return
        self.trimmed_adapter_reads += 1
        self.trimmed_adapter_bases += len(adapter)
        tgt = self.adapter2_count if is_r2 else self.adapter1_count
        tgt[adapter.decode("latin-1")] += 1

    def add_adapter_trimmed_pair(self, adapter1: bytes, adapter2: bytes) -> None:
        """filterresult.cpp:159-177 -- always counts 2 reads."""
        self.trimmed_adapter_reads += 2
        self.trimmed_adapter_bases += len(adapter1) + len(adapter2)
        if adapter1:
            self.adapter1_count[adapter1.decode("latin-1")] += 1
        if adapter2:
            self.adapter2_count[adapter2.decode("latin-1")] += 1

    def add_adapter_trimmed_bulk(self, counts, is_r2: bool) -> None:
        """Bulk variant of :meth:`add_adapter_trimmed` for a chunk's worth of
        trims: ``counts`` maps non-empty adapter bytes -> occurrences (see
        host/accounting.py)."""
        tgt = self.adapter2_count if is_r2 else self.adapter1_count
        for a, c in counts.items():
            self.trimmed_adapter_reads += c
            self.trimmed_adapter_bases += len(a) * c
            tgt[a.decode("latin-1")] += c

    def add_adapter_trimmed_pairs_bulk(self, counts1, counts2, n_pairs: int,
                                       total_bases: int) -> None:
        """Bulk variant of :meth:`add_adapter_trimmed_pair`: every pair counts
        2 reads regardless of adapter emptiness; ``counts1``/``counts2`` hold
        only the non-empty adapters per side."""
        self.trimmed_adapter_reads += 2 * n_pairs
        self.trimmed_adapter_bases += total_bases
        for a, c in counts1.items():
            self.adapter1_count[a.decode("latin-1")] += c
        for a, c in counts2.items():
            self.adapter2_count[a.decode("latin-1")] += c

    def add_polyx_trimmed(self, base_idx: np.ndarray, length: np.ndarray,
                          mask: np.ndarray) -> None:
        """Vector add of per-read polyX/polyG trim events
        (filterresult.cpp:43-46)."""
        if not mask.any():
            return
        b = base_idx[mask]
        np.add.at(self.trimmed_polyx_reads, b, 1)
        np.add.at(self.trimmed_polyx_bases, b, length[mask])

    def add_correction(self, from_to_hist: np.ndarray) -> None:
        """Add an [8,8]-flattened correction histogram
        (filterresult.cpp:122-126)."""
        self.correction_matrix += from_to_hist.reshape(64).astype(np.int64)

    def inc_corrected_reads(self, n: int) -> None:
        self.corrected_reads += n

    def add_merged_pairs(self, n: int) -> None:
        self.merged_pairs += n

    def merge(self, other: "FilterResultAccumulator") -> None:
        """Fold another accumulator in (cross-host reduction; mirrors
        FilterResult::merge, reference: src/filterresult.cpp:52-102)."""
        self.filter_read_stats += other.filter_read_stats
        self.trimmed_adapter_reads += other.trimmed_adapter_reads
        self.trimmed_adapter_bases += other.trimmed_adapter_bases
        self.adapter1_count += other.adapter1_count
        self.adapter2_count += other.adapter2_count
        self.trimmed_polyx_reads += other.trimmed_polyx_reads
        self.trimmed_polyx_bases += other.trimmed_polyx_bases
        self.correction_matrix += other.correction_matrix
        self.corrected_reads += other.corrected_reads
        self.merged_pairs += other.merged_pairs

    # ------------------------------------------------------------------
    @property
    def total_corrected_bases(self) -> int:
        return int(self.correction_matrix.sum())

    def report_json_basic(self) -> dict:
        """reference: src/filterresult.cpp:204-221"""
        opt = self.opt
        j: dict = {
            "PassedFilterReads": int(self.filter_read_stats[PASS_FILTER]),
            "LowQualityReads": int(self.filter_read_stats[FAIL_QUALITY]),
            "TooManyNReads": int(self.filter_read_stats[FAIL_N_BASE]),
        }
        if opt.correction.enabled:
            j["CorrectedReads"] = self.corrected_reads
            j["CorrectedBases"] = self.total_corrected_bases
        if opt.complexity_filter.enabled:
            j["LowComplexityReads"] = int(self.filter_read_stats[FAIL_COMPLEXITY])
        if opt.length_filter.enabled:
            j["TooShortReads"] = int(self.filter_read_stats[FAIL_LENGTH])
            if opt.length_filter.max_read_length > 0:
                j["TooLongReads"] = int(self.filter_read_stats[FAIL_TOO_LONG])
        return j

    def _report_adapter_details(self, counts: Counter):
        """reference: src/filterresult.cpp:244-265.  With no adapters the
        json object stays default-constructed and serializes as null."""
        total = sum(counts.values())
        if total == 0:
            return None
        j: Dict[str, int] = {}
        reported = 0
        for seq, cnt in counts.items():
            if cnt / total < self.opt.adapter.report_threshold:
                continue
            j[seq] = cnt
            reported += cnt
        unreported = total - reported
        if unreported > 0:
            j["Others"] = unreported
        return j

    def report_adapters_json(self) -> dict:
        """reference: src/filterresult.cpp:312-327"""
        opt = self.opt
        j: dict = {
            "AdapterTrimmedReads": self.trimmed_adapter_reads,
            "AdapterTrimmedBases": self.trimmed_adapter_bases,
            "Read1AdapterSequence": (
                opt.adapter.input_adapter_seq_r1
                if opt.adapter.adapter_seq_r1_provided
                else opt.adapter.detected_adapter_seq_r1
            ),
        }
        if self.paired:
            j["Read2AdapterSequence"] = (
                opt.adapter.input_adapter_seq_r2
                if opt.adapter.adapter_seq_r2_provided
                else opt.adapter.detected_adapter_seq_r2
            )
        j["Read1AdapterCounts"] = self._report_adapter_details(self.adapter1_count)
        if self.paired:
            j["Read2AdapterCounts"] = self._report_adapter_details(self.adapter2_count)
        return j

    def report_polyx_json(self) -> dict:
        """reference: src/filterresult.cpp:383-397"""
        atcg = "ATCGN"
        return {
            "TotalPolyxTrimmedReads": int(self.trimmed_polyx_reads.sum()),
            "PolyxTrimmedReads": {atcg[b]: int(self.trimmed_polyx_reads[b]) for b in range(5)},
            "TotalPolyxTrimmedBases": int(self.trimmed_polyx_bases.sum()),
            "PolyxTrimmedBases": {atcg[b]: int(self.trimmed_polyx_bases[b]) for b in range(5)},
        }
