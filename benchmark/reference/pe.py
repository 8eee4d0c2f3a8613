"""The plain reference of a paired-end configuration: what fqtool's documented
semantics (fastp's ``PairEndProcessor``) write for a job's pairs.

Given the planes that the generator wrote as FASTQ, it works out every output
stream as bytes and the JSON report's numbers, in blocks of pairs on the
device it is given.  The per-read operations are plain torch (``plain/``,
frozen copies of the program's plain operations as they stood when the
benchmark was written); the statistics, the routing, the record formats and
the report are written here.  It handles the flags of the configurations in
``configs/`` on reads that no trimming drops, and says so where it is asked
for more.

``broken`` names a guarantee of the configuration to break, for the control
(``control.py``, the cell file's ``control``): ``adapter_trim`` skips the
adapter trim by overlap, ``correction`` the base correction,
``quality_filter`` the quality filter.

``overlap_scans(config)`` gives ``run.py`` the overlap scans a pair takes,
from which it counts the overlap kernel's bytes.
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from .plain import correct as ops_correct
from .plain import dup as ops_dup
from .plain import filters as ops_filters
from .plain import merge as ops_merge
from .plain import overlap as ops_overlap
from .plain.duplicate import DuplicateTable
from .records import digits, format_records
from .stats import CycleStats

BLOCK = 32_768
PASS = ops_filters.PASS_FILTER


def overlap_scans(config: dict) -> int:
    """Overlap scans a pair takes on the main path: one, and one more on the
    merged reads with ``-m``."""
    return 2 if config["reference_params"]["merge"] else 1


def filter_params(rp: dict) -> SimpleNamespace:
    """The fields ``plain/filters.py::pass_filter`` reads."""
    return SimpleNamespace(
        qual_filter_enabled=True, low_quality_limit=rp["low_quality_limit"],
        low_quality_base_limit=rp["low_quality_base_limit"],
        n_base_limit=rp["n_base_limit"], average_quality_limit=0.0,
        complexity_filter_enabled=False, complexity_threshold=0.3,
        length_filter_enabled=rp["length_filter"], max_read_length=0,
        min_read_length=rp["min_read_length"])


def _merged_names(names: np.ndarray, len1: np.ndarray, len2: np.ndarray):
    """``name[:space - 1] + _merged_<len1>_<len2> + name[space:]`` of read1's
    name lines: fastp's merged name drops the byte before the first space.
    The generator's name lines of a job all have one width."""
    n = len(names)
    sp = int(np.flatnonzero(names[0] == ord(" "))[0]) if n else 1

    def text(b: bytes):
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b))), None
    parts = [(names[:, : sp - 1], None), text(b"_merged_"), digits(len1, 3),
             text(b"_"), digits(len2, 3), (names[:, sp:], None)]
    mat = np.concatenate([m for m, _ in parts], axis=1)
    keep = np.concatenate([np.ones(m.shape, bool) if k is None else k
                           for m, k in parts], axis=1)
    return mat, keep


class Reference:
    def __init__(self, config: dict, device, broken: Optional[str] = None):
        rp = config["reference_params"]
        self.rp = rp
        self.p = filter_params(rp)
        self.p.qual_filter_enabled = broken != "quality_filter"
        self.device = torch.device(device)
        self.broken = broken
        self.adapters = config["adapters"]
        k = rp["kmer_len"]
        self.pre = [CycleStats(k), CycleStats(k)]
        self.post = [CycleStats(k), CycleStats(k)]
        self.results = np.zeros(ops_filters.FILTER_RESULT_TYPES, np.int64)
        self.isize = np.zeros(rp["insert_size_max"] + 1, np.int64)
        self.dup = (DuplicateTable(rp["dup_keylen"], rp["dup_hist_size"])
                    if rp["dup_keylen"] else None)
        self.adapter_reads = 0
        self.adapter_bases = 0
        self.adapter_counts = [Counter(), Counter()]
        self.corrected_reads = 0
        self.corrected_bases = 0
        self.streams: Dict[str, list] = {}

    # ------------------------------------------------------------------
    def run(self, pairs) -> "Reference":
        """Every block of ``pairs`` (``traffic.pairs.Pairs``)."""
        self.names = pairs.names
        for lo in range(0, pairs.count, BLOCK):
            hi = min(lo + BLOCK, pairs.count)
            t = [torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(self.device)
                 for x in (pairs.seq1, pairs.qual1, pairs.seq2, pairs.qual2)]
            self._block(lo, *t)
        return self

    def _block(self, lo, s1, q1, s2, q2) -> None:
        rp, p, dev = self.rp, self.p, self.device
        B, L = s1.shape
        full = torch.full((B,), L, dtype=torch.int32, device=dev)
        r1, r2 = full.clone(), full.clone()
        self.pre[0].add(s1, q1, r1)
        self.pre[1].add(s2, q2, r2)
        if self.dup is not None:
            d = ops_dup.dup_keys_pe(s1, r1, s2, r2, rp["dup_keylen"])
            host = [x.to(torch.int64).cpu().numpy() for x in
                    (d.key, d.kmer_hi, d.kmer_lo, d.gc)]
            self.dup.add_batch(host[0].astype(np.int32), host[1].astype(np.uint32),
                               host[2].astype(np.uint32), host[3].astype(np.uint8),
                               d.valid.cpu().numpy())
        ov = ops_overlap.analyze(s1, r1, s2, r2, rp["overlap_diff_limit"],
                                 rp["overlap_require"])
        imax = rp["insert_size_max"]
        isize = torch.where(ov.overlapped,
                            torch.where(ov.offset > 0, r1 + r2 - ov.overlap_len,
                                        ov.overlap_len), imax).clamp(max=imax)
        self.isize += torch.bincount(isize.long(), minlength=imax + 1).cpu().numpy()
        if rp["correction"] and self.broken != "correction":
            cr = ops_correct.correct_by_overlap(
                s1, q1, r1, s2, q2, r2, ov, torch.ones_like(ov.overlapped))
            s1, q1, s2, q2 = cr.seq1, cr.qual1, cr.seq2, cr.qual2
            c1, c2 = cr.corrected1, cr.corrected2
            self.corrected_reads += int((c1 > 0).sum() + (c2 > 0).sum())
            self.corrected_bases += int(cr.matrix.long().sum())
        if rp["adapter_trimming"] and self.broken != "adapter_trim":
            trim = ((ov.diff <= 5) & ov.overlapped & (ov.offset < 0)
                    & (ov.overlap_len > torch.div(r1, 3, rounding_mode="floor")))
            ol = ov.overlap_len
            rows = torch.nonzero(trim)[:, 0]
            for side, (s, r) in enumerate(((s1, r1), (s2, r2))):
                self._count_adapters(side, s[rows], ol[rows], r[rows])
            self.adapter_reads += 2 * len(rows)
            self.adapter_bases += int(((r1 - ol).clamp(min=0)[trim]).sum()
                                      + ((r2 - ol).clamp(min=0)[trim]).sum())
            r1 = torch.where(trim, ol, r1)
            r2 = torch.where(trim, ol, r2)
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        res1 = ops_filters.pass_filter(s1, q1, r1, no, p)
        res2 = ops_filters.pass_filter(s2, q2, r2, no, p)
        pass1, pass2 = res1 == PASS, res2 == PASS
        if rp["merge"]:
            self._merge_route(lo, s1, q1, r1, s2, q2, r2, res1, res2)
            return
        both = pass1 & pass2
        self.results += 2 * torch.bincount(torch.maximum(res1, res2).long(),
                                           minlength=len(self.results)).cpu().numpy()
        self.post[0].add(s1, q1, r1, both)
        self.post[1].add(s2, q2, r2, both)
        rows = torch.nonzero(both)[:, 0].cpu().numpy()
        for mate, (s, q, r) in enumerate(((s1, q1, r1), (s2, q2, r2)), 1):
            names = self.names(lo + rows, mate)
            self._emit(f"out{mate}", names, np.ones(names.shape, bool),
                       s, q, r, rows)

    def _count_adapters(self, side, seq, ol, rlen) -> None:
        """The bases past the overlap that the trim takes off, counted by
        sequence."""
        seq, ol, rlen = seq.cpu().numpy(), ol.cpu().numpy(), rlen.cpu().numpy()
        c = self.adapter_counts[side]
        for row, a, b in zip(seq, ol.tolist(), rlen.tolist()):
            if b > a:
                c[row[a:b].tobytes().decode()] += 1

    def _merge_route(self, lo, s1, q1, r1, s2, q2, r2, res1, res2) -> None:
        rp, p = self.rp, self.p
        ov2 = ops_overlap.analyze(s1, r1, s2, r2, rp["overlap_diff_limit"],
                                  rp["overlap_require"])
        mg = ops_merge.merge_pairs(s1, q1, r1, s2, q2, r2, ov2)
        zero = torch.zeros_like(ov2.overlapped)
        resM = ops_filters.pass_filter(mg.seq, mg.qual, mg.rlen, zero, p)
        mergeable = ov2.overlapped
        unm = ~mergeable
        nb = len(self.results)
        self.results += 2 * torch.bincount(resM[mergeable].long(), minlength=nb).cpu().numpy()
        self.results += torch.bincount(res1[unm].long(), minlength=nb).cpu().numpy()
        self.results += torch.bincount(res2[unm].long(), minlength=nb).cpu().numpy()
        selM = mergeable & (resM == PASS)
        sel1 = unm & (res1 == PASS)
        sel2 = unm & (res2 == PASS)
        self.post[0].add(mg.seq, mg.qual, mg.rlen, selM)
        self.post[0].add(s1, q1, r1, sel1)
        self.post[1].add(s2, q2, r2, sel2)
        # the merged stream, in pair order: the merged read, or the unmerged
        # pair's passing reads, read1 first
        B = s1.shape[0]
        W = mg.seq.shape[1]
        pad = W - s1.shape[1]
        seq = torch.stack([mg.seq, torch.nn.functional.pad(s1, (0, pad)),
                           torch.nn.functional.pad(s2, (0, pad))], 1).reshape(3 * B, W)
        qual = torch.stack([mg.qual, torch.nn.functional.pad(q1, (0, pad)),
                            torch.nn.functional.pad(q2, (0, pad))], 1).reshape(3 * B, W)
        lens = torch.stack([mg.rlen, r1, r2], 1).reshape(-1)
        sel = torch.stack([selM, sel1, sel2], 1).reshape(-1)
        keep = torch.nonzero(sel)[:, 0].cpu().numpy()
        kind = keep % 3
        pair = keep // 3
        n1 = self.names(lo + np.arange(B), 1)
        n2 = self.names(lo + np.arange(B), 2)
        mrows = pair[kind == 0]
        mnames, mkeep = _merged_names(n1[mrows], mg.len1[mrows].cpu().numpy(),
                                      mg.len2[mrows].cpu().numpy())
        Wn = mnames.shape[1]
        names = np.zeros((len(keep), Wn), np.uint8)
        nkeep = np.zeros((len(keep), Wn), bool)
        names[kind == 0] = mnames
        nkeep[kind == 0] = mkeep
        w = n1.shape[1]
        names[kind == 1, :w] = n1[pair[kind == 1]]
        names[kind == 2, :w] = n2[pair[kind == 2]]
        nkeep[kind != 0, :w] = True
        self._emit("merged", names, nkeep, seq, qual, lens, keep)

    def _emit(self, stream, names, name_keep, seq, qual, rlen, rows) -> None:
        idx = torch.from_numpy(rows).to(seq.device)
        s = seq[idx].cpu().numpy()
        q = qual[idx].cpu().numpy()
        ln = rlen[idx].cpu().numpy()
        self.streams.setdefault(stream, []).append(
            format_records(names, name_keep, s, q, ln))

    # ------------------------------------------------------------------
    def stream_bytes(self, name: str) -> bytes:
        return b"".join(self.streams.get(name, []))

    def report(self) -> dict:
        """The JSON report's sections, as fqtool writes them, but
        ``Software``."""
        rp = self.rp
        pre, post = self.pre, self.post

        def summary(a, b):
            ta, tb = a.totals(), b.totals()
            bases = ta["bases"] + tb["bases"]

            def rate(x):
                return 0.0 if bases == 0 else x / bases
            return {"TotalReads": a.reads + b.reads, "TotalBases": bases,
                    "Q20Bases": ta["q20"] + tb["q20"],
                    "Q30Bases": ta["q30"] + tb["q30"],
                    "Q20BaseRate": rate(ta["q20"] + tb["q20"]),
                    "Q30BaseRate": rate(ta["q30"] + tb["q30"]),
                    "Read1Length": a.mean_length(), "Read2Length": b.mean_length(),
                    "GCRate": rate(ta["gc"] + tb["gc"])}

        fr = {"PassedFilterReads": int(self.results[PASS]),
              "LowQualityReads": int(self.results[ops_filters.FAIL_QUALITY]),
              "TooManyNReads": int(self.results[ops_filters.FAIL_N_BASE])}
        if rp["correction"]:
            fr["CorrectedReads"] = self.corrected_reads
            fr["CorrectedBases"] = self.corrected_bases
        if rp["length_filter"]:
            fr["TooShortReads"] = int(self.results[ops_filters.FAIL_LENGTH])
        imax = rp["insert_size_max"]
        hist = self.isize
        rep = {"Summary": {"BeforeFiltering": summary(*pre),
                           "AfterFiltering": summary(*post)},
               "FilterResult": fr,
               "InsertSize": {"Peak": int(np.argmax(hist[:imax])),
                              "Unknown": int(hist[imax]),
                              "Histogram": [int(x) for x in hist[:imax]]},
               "Read1BeforeFiltering": pre[0].report(),
               "Read2BeforeFiltering": pre[1].report()}
        if self.dup is not None:
            h, gc, rate = self.dup.stat_all()
            rep["Duplication"] = {"Rate": rate, "Histogram": [int(x) for x in h],
                                  "MeanGC": [float(x) for x in gc]}
        if rp["adapter_trimming"]:
            rep["AdapterTrim"] = {
                "AdapterTrimmedReads": self.adapter_reads,
                "AdapterTrimmedBases": self.adapter_bases,
                "Read1AdapterSequence": self.adapters[0],
                "Read2AdapterSequence": self.adapters[1],
                "Read1AdapterCounts": self._adapter_report(self.adapter_counts[0]),
                "Read2AdapterCounts": self._adapter_report(self.adapter_counts[1])}
        if rp["merge"]:
            rep["MergedAndFiltered"] = post[0].report()
        else:
            rep["Read1AfterFiltering"] = post[0].report()
            rep["Read2AfterFiltering"] = post[1].report()
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


def expected(pairs, config: dict, device, broken: Optional[str] = None) -> Reference:
    """The reference run over a job's pairs (``traffic.pairs.Pairs``)."""
    return Reference(config, device, broken).run(pairs)
