"""Per-cycle read statistics and k-mer counts, as fqtool's JSON report gives
them (fastp's ``Stats``): per cycle the reads that reach it, their quality
sum, and per base (binned by ``base & 7``) the count, quality sum and the
bases above Q20 and Q30 (strict ``>`` against '5' and '?').  Plain torch for
the sums, numpy float64 for the curves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

WIDTH = 640  # longer than any read or merged read of the cells
BINS = {"A": ord("A") & 7, "T": ord("T") & 7, "C": ord("C") & 7,
        "G": ord("G") & 7, "N": ord("N") & 7}
KMER_BASES = "ATCG"  # 2-bit codes, first base highest


class CycleStats:
    def __init__(self, kmer_len: int = 0):
        self.reads = 0
        self.length_sum = 0
        # [content, q20, q30, quality] x 8 bins x WIDTH cycles
        self.hist = np.zeros((8, WIDTH, 4), np.int64)
        self.kmer_len = kmer_len
        self.kmer = np.zeros(4 ** kmer_len, np.int64) if kmer_len else None

    def add(self, seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
            select: Optional[torch.Tensor] = None) -> None:
        """Count the rows of ``seq``/``qual`` (uint8 [B, W]) within their
        lengths, the rows of ``select`` only."""
        B, W = seq.shape
        if select is None:
            select = torch.ones(B, dtype=torch.bool, device=seq.device)
        rlen = rlen.to(torch.int64)
        mask = (torch.arange(W, device=seq.device)[None, :] < rlen[:, None]) \
            & select[:, None]
        q = qual.to(torch.int64)
        vals = torch.stack([torch.ones_like(q), (q > ord("5")).long(),
                            (q > ord("?")).long(), q - 33], -1)[mask]
        cyc = torch.arange(W, device=seq.device).expand(B, W)[mask]
        b = (seq.to(torch.int64) & 7)[mask]
        h = torch.zeros((8 * WIDTH, 4), dtype=torch.int64, device=seq.device)
        h.index_add_(0, b * WIDTH + cyc, vals)
        self.hist += h.reshape(8, WIDTH, 4).cpu().numpy()
        self.reads += int(select.sum())
        self.length_sum += int(rlen[select].sum())
        if self.kmer is not None:
            self.kmer += kmers(seq, rlen, self.kmer_len, select)

    def totals(self) -> dict:
        content = self.hist[:, :, 0]
        total = content.sum(0)
        zero = np.flatnonzero(total == 0)
        cycles = int(zero[0]) if len(zero) else WIDTH
        return dict(total=total, cycles=cycles, bases=int(total[:cycles].sum()),
                    q20=int(self.hist[:, :cycles, 1].sum()),
                    q30=int(self.hist[:, :cycles, 2].sum()),
                    gc=int(content[BINS["G"], :cycles].sum()
                           + content[BINS["C"], :cycles].sum()))

    def mean_length(self) -> int:
        return self.length_sum // self.reads if self.reads else 0

    def report(self) -> dict:
        t = self.totals()
        c = t["cycles"]
        total = t["total"][:c]
        qsum = self.hist[:, :c, 3].sum(0)
        mean = np.where(total > 0, qsum / np.maximum(total, 1), 0.0)
        qc, cc = {"Mean": mean}, {}
        for nt, b in BINS.items():
            cont = self.hist[b, :c, 0]
            qc[nt] = np.where(cont > 0, self.hist[b, :c, 3] / np.maximum(cont, 1), mean)
            cc[nt] = np.where(total > 0, cont / np.maximum(total, 1), 0.0)
        gc = self.hist[BINS["G"], :c, 0] + self.hist[BINS["C"], :c, 0]
        cc["GC"] = np.where(total > 0, gc / np.maximum(total, 1), 0.0)
        out = {"TotalReads": self.reads, "TotalBases": t["bases"],
               "Q20Bases": t["q20"], "Q30Bases": t["q30"], "TotalCycles": c,
               "QualityCurves": {k: [float(v) for v in qc[k]]
                                 for k in ("A", "T", "C", "G", "Mean")},
               "ContentCurves": {k: [float(v) for v in cc[k]]
                                 for k in ("A", "T", "C", "G", "N", "GC")}}
        if self.kmer is not None:
            k = self.kmer_len
            out["KmerCount"] = {
                "".join(KMER_BASES[(i >> (2 * (k - 1 - p))) & 3] for p in range(k)):
                str(int(v)) for i, v in enumerate(self.kmer)}
        return out


def kmers(seq: torch.Tensor, rlen: torch.Tensor, k: int,
          select: torch.Tensor) -> np.ndarray:
    """Histogram of the k-base windows within each selected read whose bases
    are all A/C/G/T, keyed 2 bits a base (A=0 T=1 C=2 G=3), first base
    highest."""
    B, W = seq.shape
    lut = torch.full((256,), -1, dtype=torch.int64, device=seq.device)
    for code, base in enumerate(b"ATCG"):
        lut[base] = code
    codes = lut[seq.long()]
    n = W - k + 1
    key = torch.zeros((B, n), dtype=torch.int64, device=seq.device)
    ok = (torch.arange(n, device=seq.device)[None, :] + k <= rlen[:, None]) \
        & select[:, None]
    for j in range(k):
        c = codes[:, j : j + n]
        key = key * 4 + c.clamp(min=0)
        ok &= c >= 0
    return torch.bincount(key[ok], minlength=4 ** k).cpu().numpy()
