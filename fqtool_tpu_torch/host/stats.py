# Copy of fqtool_tpu/host/stats.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Host-side statistics accumulator and summarizer.

Aggregates per-batch device histograms (``ops.stats.BatchStats``) and
reproduces ``Stats::summarize`` / ``Stats::reportJson``
(reference: src/stats.cpp:147-228, 392-430) including the derived curves and
the cycle-count determination (first zero-count cycle).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# base & 0x07 bin indices for A/T/C/G/N in ASCII
BIN_OF = {"A": ord("A") & 7, "T": ord("T") & 7, "C": ord("C") & 7,
          "G": ord("G") & 7, "N": ord("N") & 7}


class StatsAccumulator:
    """Mirrors the per-thread Stats object, merged across batches."""

    def __init__(self, evaluated_seq_len: int, kmer_len: int = 0,
                 over_rep_sampling: int = 0,
                 over_rep_seqs: Optional[Dict[str, int]] = None):
        self.buf_len = max(evaluated_seq_len, 1)
        self.evaluated_seq_len = evaluated_seq_len
        self.reads = 0
        self.length_sum = 0
        self.kmer_len = kmer_len
        self.cycle_q20 = np.zeros((8, self.buf_len), np.int64)
        self.cycle_q30 = np.zeros((8, self.buf_len), np.int64)
        self.cycle_content = np.zeros((8, self.buf_len), np.int64)
        self.cycle_quality = np.zeros((8, self.buf_len), np.int64)
        self.cycle_total = np.zeros(self.buf_len, np.int64)
        self.cycle_total_qual = np.zeros(self.buf_len, np.int64)
        self.kmer = np.zeros(4 ** kmer_len, np.int64) if kmer_len else None
        # ORA (reference: stats.cpp:277-293, 865-877)
        self.over_rep_sampling = over_rep_sampling
        self.over_rep_count: Dict[str, int] = {}
        self.over_rep_dist: Dict[str, np.ndarray] = {}
        if over_rep_sampling and over_rep_seqs:
            for s in over_rep_seqs:
                self.over_rep_count[s] = 0
                self.over_rep_dist[s] = np.zeros(self.evaluated_seq_len, np.int64)
        self._summary = None

    def _extend(self, n: int) -> None:
        if n <= self.buf_len:
            return
        def grow(a):
            out = np.zeros(a.shape[:-1] + (n,), a.dtype)
            out[..., : a.shape[-1]] = a
            return out
        self.cycle_q20 = grow(self.cycle_q20)
        self.cycle_q30 = grow(self.cycle_q30)
        self.cycle_content = grow(self.cycle_content)
        self.cycle_quality = grow(self.cycle_quality)
        self.cycle_total = grow(self.cycle_total)
        self.cycle_total_qual = grow(self.cycle_total_qual)
        self.buf_len = n

    def add_batch(self, bs) -> None:
        """Accumulate a device BatchStats (converted to numpy)."""
        L = int(np.asarray(bs.cycle_total).shape[0])
        self._extend(L)
        self.cycle_q20[:, :L] += np.asarray(bs.cycle_q20)
        self.cycle_q30[:, :L] += np.asarray(bs.cycle_q30)
        self.cycle_content[:, :L] += np.asarray(bs.cycle_content)
        self.cycle_quality[:, :L] += np.asarray(bs.cycle_quality)
        self.cycle_total[:L] += np.asarray(bs.cycle_total)
        self.cycle_total_qual[:L] += np.asarray(bs.cycle_total_qual)
        self.reads += int(bs.reads)
        self.length_sum += int(bs.length_sum)
        self._summary = None

    def add_kmer(self, hist) -> None:
        if self.kmer is not None:
            self.kmer += np.asarray(hist, np.int64)

    def add_over_rep_read(self, seq: bytes) -> None:
        """ORA sampling for one read (reference: stats.cpp:277-293): scan step
        lengths, count tracked sequences, advance past a match, and record the
        position distribution clamped to the evaluated length."""
        steps = sorted({10, 20, 40, 100, min(150, self.evaluated_seq_len - 2)})
        s = seq.decode("latin-1")
        n = len(s)
        for step in steps:
            j = 0
            while j < n - step:
                sub = s[j : j + step]
                cnt = self.over_rep_count.get(sub)
                if cnt is not None:
                    self.over_rep_count[sub] = cnt + 1
                    dist = self.over_rep_dist[sub]
                    hi = min(j + step, self.evaluated_seq_len)
                    if j < hi:
                        dist[j:hi] += 1
                    j += step  # stats.cpp:288 (then loop ++j)
                j += 1

    def merge(self, other: "StatsAccumulator") -> None:
        """Fold another accumulator in (cross-host reduction; mirrors
        Stats::merge, reference: src/stats.cpp:815-863)."""
        self._extend(other.buf_len)
        L = other.buf_len
        self.cycle_q20[:, :L] += other.cycle_q20
        self.cycle_q30[:, :L] += other.cycle_q30
        self.cycle_content[:, :L] += other.cycle_content
        self.cycle_quality[:, :L] += other.cycle_quality
        self.cycle_total[:L] += other.cycle_total
        self.cycle_total_qual[:L] += other.cycle_total_qual
        self.reads += other.reads
        self.length_sum += other.length_sum
        if self.kmer is not None and other.kmer is not None:
            self.kmer += other.kmer
        for s, c in other.over_rep_count.items():
            if s in self.over_rep_count:
                self.over_rep_count[s] += c
                self.over_rep_dist[s] += other.over_rep_dist[s]
        self._summary = None

    # ------------------------------------------------------------------
    def summarize(self) -> dict:
        """reference: src/stats.cpp:147-228"""
        if self._summary is not None:
            return self._summary
        total = self.cycle_total
        # cycles = first zero-count cycle; bases sum up to there; min read len =
        # first decrease (stats.cpp:153-167)
        bases = 0
        min_read_len = 0
        got_min = False
        c = 0
        for c in range(self.buf_len):
            bases += int(total[c])
            if not got_min and c > 1 and total[c] < total[c - 1]:
                min_read_len = c
                got_min = True
            if total[c] == 0:
                break
        else:
            c = self.buf_len
        cycles = c

        q20_bases = np.sum(self.cycle_q20[:, :cycles], axis=1)
        q30_bases = np.sum(self.cycle_q30[:, :cycles], axis=1)
        base_contents = np.sum(self.cycle_content[:, :cycles], axis=1)
        q20_total = int(q20_bases.sum())
        q30_total = int(q30_bases.sum())

        with np.errstate(divide="ignore", invalid="ignore"):
            mean_qual = self.cycle_total_qual[:cycles] / np.maximum(total[:cycles], 0)
            mean_qual = np.where(total[:cycles] > 0,
                                 self.cycle_total_qual[:cycles] / total[:cycles], 0.0)

        quality_curves = {"Mean": mean_qual}
        content_curves = {}
        for nt in "ATCGN":
            b = BIN_OF[nt]
            contents = self.cycle_content[b, :cycles]
            quals = self.cycle_quality[b, :cycles]
            qc = np.where(contents > 0,
                          np.divide(quals, np.maximum(contents, 1)), mean_qual)
            cc = np.divide(contents, np.maximum(total[:cycles], 1),
                           dtype=np.float64)
            cc = np.where(total[:cycles] > 0, cc, 0.0)
            quality_curves[nt] = qc
            content_curves[nt] = cc
        gc = (self.cycle_content[BIN_OF["G"], :cycles]
              + self.cycle_content[BIN_OF["C"], :cycles])
        content_curves["GC"] = np.where(total[:cycles] > 0,
                                        gc / np.maximum(total[:cycles], 1), 0.0)

        self._summary = dict(
            cycles=cycles,
            bases=bases,
            min_read_len=min_read_len,
            q20_total=q20_total,
            q30_total=q30_total,
            base_contents=base_contents,
            quality_curves=quality_curves,
            content_curves=content_curves,
        )
        return self._summary

    # accessor parity with the reference getters -----------------------
    def get_reads(self) -> int:
        return self.reads

    def get_bases(self) -> int:
        return self.summarize()["bases"]

    def get_q20(self) -> int:
        return self.summarize()["q20_total"]

    def get_q30(self) -> int:
        return self.summarize()["q30_total"]

    def get_gc_number(self) -> int:
        bc = self.summarize()["base_contents"]
        return int(bc[BIN_OF["G"]] + bc[BIN_OF["C"]])

    def get_cycles(self) -> int:
        return self.summarize()["cycles"]

    def get_mean_length(self) -> int:
        if self.reads == 0:
            return 0
        return self.length_sum // self.reads

    def over_rep_passed(self, seq: str, count: int) -> bool:
        """reference: src/stats.cpp:372-386"""
        s = self.over_rep_sampling
        n = len(seq)
        if n == 10:
            return s * count > 500
        if n == 20:
            return s * count > 200
        if n == 40:
            return s * count > 100
        if n == 100:
            return s * count > 50
        return s * count > 20

    def report_json(self) -> dict:
        """reference: src/stats.cpp:392-430"""
        from .evaluator import int2seq

        sm = self.summarize()
        cycles = sm["cycles"]
        out: dict = {
            "TotalReads": self.reads,
            "TotalBases": sm["bases"],
            "Q20Bases": sm["q20_total"],
            "Q30Bases": sm["q30_total"],
            "TotalCycles": cycles,
            "QualityCurves": {
                k: [float(v) for v in sm["quality_curves"][k]]
                for k in ("A", "T", "C", "G", "Mean")
            },
            "ContentCurves": {
                k: [float(v) for v in sm["content_curves"][k]]
                for k in ("A", "T", "C", "G", "N", "GC")
            },
        }
        if self.kmer_len:
            # values serialized as strings (stats.cpp:415)
            out["KmerCount"] = {
                int2seq(i, self.kmer_len): str(int(self.kmer[i]))
                for i in range(len(self.kmer))
            }
        if self.over_rep_sampling:
            ora = {
                s: int(c) for s, c in sorted(self.over_rep_count.items())
                if self.over_rep_passed(s, c)
            }
            # nlohmann parity: a default-constructed json stays null when no
            # entry passes (stats.cpp:419-427 operator[] never runs)
            out["OverrepresentedSequences"] = ora if ora else None
        return out
