"""The plain reference of a single-end configuration: what fqtool's documented
semantics (fastp's ``SingleEndProcessor``, src/seprocessor.cpp:290-353)
write for a job's reads.

Given the planes that the generator wrote as FASTQ, it works out the output
stream as bytes and the JSON report's numbers, in blocks of reads on the
device it is given, in the reference tool's order: pre-statistics,
duplication keys, trimAndCut, trimPolyG, trimBySequence, passFilter,
post-statistics.  The per-read operations are plain torch (``plain/``); the
statistics, the adapter and polyG accounting, the record format and the
report are written here.  It handles the flags of the single-end
configurations in ``configs/``: no force trim and no quality cut (so
trimAndCut leaves every read whole), no polyX trim and no length cap.

``broken`` names a guarantee of the configuration to break, for the control
(``control.py``, the cell file's ``control``): ``adapter_trim`` skips
trimBySequence.  No ``overlap_scans``: a single-end job runs no overlap
scan.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from .pe import filter_params
from .plain import adapter as ops_adapter
from .plain import dup as ops_dup
from .plain import filters as ops_filters
from .plain import polyx as ops_polyx
from .plain.duplicate import DuplicateTable
from .records import format_records
from .stats import CycleStats

BLOCK = 32_768
PASS = ops_filters.PASS_FILTER


class Reference:
    def __init__(self, config: dict, device, broken: Optional[str] = None):
        rp = config["reference_params"]
        self.rp = rp
        self.p = filter_params(rp)
        self.device = torch.device(device)
        self.broken = broken
        self.adapter = config["adapters"][0].encode() \
            if rp["adapter_trimming"] else b""
        self.pre = CycleStats(rp["kmer_len"])
        self.post = CycleStats(rp["kmer_len"])
        self.results = np.zeros(ops_filters.FILTER_RESULT_TYPES, np.int64)
        self.dup = (DuplicateTable(rp["dup_keylen"], rp["dup_hist_size"])
                    if rp["dup_keylen"] else None)
        self.adapter_counts: Counter = Counter()
        self.polyg_reads = 0
        self.polyg_bases = 0
        self.out: list = []

    # ------------------------------------------------------------------
    def run(self, reads) -> "Reference":
        """Every block of ``reads`` (``traffic.reads.Reads``)."""
        self.names = reads.names
        for lo in range(0, reads.count, BLOCK):
            hi = min(lo + BLOCK, reads.count)
            s, q = (torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(self.device)
                    for x in (reads.seq, reads.qual))
            self._block(lo, s, q)
        return self

    def _block(self, lo, seq, qual) -> None:
        rp, dev = self.rp, self.device
        B, L = seq.shape
        rlen = torch.full((B,), L, dtype=torch.int64, device=dev)
        # 1. pre-statistics of the raw reads
        self.pre.add(seq, qual, rlen)
        # 2. duplication keys of the raw reads
        if self.dup is not None:
            d = ops_dup.dup_keys_se(seq, rlen.to(torch.int32), rp["dup_keylen"])
            host = [x.to(torch.int64).cpu().numpy() for x in
                    (d.key, d.kmer_hi, d.kmer_lo, d.gc)]
            self.dup.add_batch(host[0].astype(np.int32), host[1].astype(np.uint32),
                               host[2].astype(np.uint32), host[3].astype(np.uint8),
                               d.valid.cpu().numpy())
        # 3. trimAndCut: no force trim and no quality cut, every read whole
        # 4. polyG: the trim is recorded as G, whatever the resize did
        if rp["polyg"]:
            pg = ops_polyx.trim_polyg(seq, rlen, rp["polyg_min_len"],
                                      rp["polyg_max_mismatch"], rp["polyg_each"])
            self.polyg_reads += int(pg.trimmed.sum())
            self.polyg_bases += int(pg.trim_len[pg.trimmed].sum())
            rlen = pg.rlen
        # 5. trimBySequence: the bases it takes off, counted by sequence
        if self.adapter and self.broken != "adapter_trim":
            ad = ops_adapter.trim_by_sequence(seq, rlen, self.adapter)
            self._count_adapters(seq, rlen, ad)
            rlen = ad.rlen
        # 6. passFilter, then the post-statistics of the passing reads
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        res = ops_filters.pass_filter(seq, qual, rlen.to(torch.int32), no, self.p)
        self.results += torch.bincount(res.long(), minlength=len(self.results)
                                       ).cpu().numpy()
        ok = res == PASS
        self.post.add(seq, qual, rlen, ok)
        rows = torch.nonzero(ok)[:, 0]
        names = self.names(lo + rows.cpu().numpy())
        self.out.append(format_records(
            names, np.ones(names.shape, bool), seq[rows].cpu().numpy(),
            qual[rows].cpu().numpy(), rlen[rows].cpu().numpy()))

    def _count_adapters(self, seq, before, ad) -> None:
        """The adapter each trim records: the read's bases from ``pos`` to
        its end where ``pos >= 0``; where the match began before the read
        (``pos < 0``), the adapter's part from ``-pos`` on, which the read
        held.  An empty one records nothing."""
        rows = torch.nonzero(ad.found)[:, 0]
        pos = ad.pos[rows].cpu().numpy()
        end = before[rows].cpu().numpy()
        held = seq[rows].cpu().numpy()
        for row, p, e in zip(held, pos.tolist(), end.tolist()):
            a = row[p:e].tobytes() if p >= 0 else self.adapter[-p:]
            if a:
                self.adapter_counts[a.decode()] += 1

    # ------------------------------------------------------------------
    def stream_bytes(self, name: str) -> bytes:
        return b"".join(self.out) if name == "out1" else b""

    def report(self) -> dict:
        """The JSON report's sections, as fqtool writes them for a
        single-end run, but ``Software``."""
        rp = self.rp

        def summary(s: CycleStats):
            t = s.totals()
            bases = t["bases"]

            def rate(x):
                return 0.0 if bases == 0 else x / bases
            return {"TotalReads": s.reads, "TotalBases": bases,
                    "Q20Bases": t["q20"], "Q30Bases": t["q30"],
                    "Q20BaseRate": rate(t["q20"]), "Q30BaseRate": rate(t["q30"]),
                    "Read1Length": s.mean_length(), "GCRate": rate(t["gc"])}

        fr = {"PassedFilterReads": int(self.results[PASS]),
              "LowQualityReads": int(self.results[ops_filters.FAIL_QUALITY]),
              "TooManyNReads": int(self.results[ops_filters.FAIL_N_BASE])}
        if rp["length_filter"]:
            fr["TooShortReads"] = int(self.results[ops_filters.FAIL_LENGTH])
        rep = {"Summary": {"BeforeFiltering": summary(self.pre),
                           "AfterFiltering": summary(self.post)},
               "FilterResult": fr,
               "Read1BeforeFiltering": self.pre.report(),
               "Read1AfterFiltering": self.post.report()}
        if self.dup is not None:
            h, gc, rate = self.dup.stat_all()
            rep["Duplication"] = {"Rate": rate, "Histogram": [int(x) for x in h],
                                  "MeanGC": [float(x) for x in gc]}
        if rp["adapter_trimming"]:
            counts = self.adapter_counts
            rep["AdapterTrim"] = {
                "AdapterTrimmedReads": sum(counts.values()),
                "AdapterTrimmedBases": sum(len(a) * c for a, c in counts.items()),
                "Read1AdapterSequence": self.adapter.decode(),
                "Read1AdapterCounts": self._adapter_report(counts)}
        if rp["polyg"]:
            per = {b: 0 for b in "ATCGN"}
            rep["PolyxTrimming"] = {
                "TotalPolyxTrimmedReads": self.polyg_reads,
                "PolyxTrimmedReads": dict(per, G=self.polyg_reads),
                "TotalPolyxTrimmedBases": self.polyg_bases,
                "PolyxTrimmedBases": dict(per, G=self.polyg_bases)}
        return rep

    def _adapter_report(self, counts: Counter):
        total = sum(counts.values())
        if total == 0:
            return None
        out = {s: c for s, c in counts.items()
               if c / total >= self.rp["adapter_report_threshold"]}
        others = total - sum(out.values())
        if others > 0:
            out["Others"] = others
        return out


def expected(reads, config: dict, device, broken: Optional[str] = None) -> Reference:
    """The reference run over a job's reads (``traffic.reads.Reads``)."""
    return Reference(config, device, broken).run(reads)
