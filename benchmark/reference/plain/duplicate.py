# The dense path of fqtool_tpu_torch/host/duplicate.py (keys of up to 15
# bases, one process), frozen when the benchmark was written; the
# benchmark's reference imports nothing of the program.
"""Duplication-analysis table and final histogram.

Host-side combiner for the device-extracted keys (``ops.dup.DupKeys``).
Replaces the mutex-guarded ``Duplicate::addRecord`` table
(reference: src/duplicate.cpp:46-62) with an order-equivalent vectorized
update; the per-key combine rule is

    (min kmer32 wins; equal kmer32 adds counts; gc = gc of the key's FIRST
     record if that record holds the minimum, else 0)

which is exactly the reference's sequential outcome because later records find
``mCounts[key] != 0`` and therefore stat a gc of 0 (duplicate.cpp:83-92).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class DuplicateTable:
    def __init__(self, keylen: int, hist_size: int):
        self.keylen = keylen
        self.hist_size = hist_size
        n = 1 << (2 * keylen)
        # min_kmer is only meaningful where ``seen`` is set, with unseen
        # treated as +inf by the folds
        self.min_kmer = np.zeros(n, np.uint64)
        self.counts = np.zeros(n, np.uint32)
        self.first_kmer = np.zeros(n, np.uint64)
        self.first_gc = np.zeros(n, np.uint8)
        self.seen = np.zeros(n, bool)

    def add_batch(self, key: np.ndarray, kmer_hi: np.ndarray, kmer_lo: np.ndarray,
                  gc: np.ndarray, valid: np.ndarray) -> None:
        """Fold one batch of per-read records (input order preserved for the
        first-record rule)."""
        if not valid.any():
            return
        # device keys ride as int32 bit patterns; reinterpret as unsigned
        key = key[valid].view(np.uint32).astype(np.int64)
        kmer = (kmer_hi[valid].astype(np.uint64) << np.uint64(32)) | \
            kmer_lo[valid].astype(np.uint64)
        gc = gc[valid]

        # group batch records by key with one stable sort
        order = np.argsort(key, kind="stable")
        ks = key[order]
        kmers = kmer[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        uniq = ks[starts]
        first_in_batch = order[starts]  # stable sort => earliest occurrence

        newly = ~self.seen[uniq]
        new_keys = uniq[newly]
        self.first_kmer[new_keys] = kmer[first_in_batch[newly]]
        self.first_gc[new_keys] = gc[first_in_batch[newly]]
        self.seen[new_keys] = True

        # batch minimum per key, then merge with the running minimum
        batch_min = np.minimum.reduceat(kmers, starts)
        old_min = np.where(newly, np.iinfo(np.uint64).max,
                           self.min_kmer[uniq])
        new_min = np.minimum(old_min, batch_min)
        # a strictly smaller minimum resets the count (duplicate.cpp:55-58)
        self.counts[uniq] = np.where(new_min < old_min, 0, self.counts[uniq])
        self.min_kmer[uniq] = new_min
        # count batch records equal to the (possibly new) minimum
        sizes = np.diff(np.r_[starts, len(ks)])
        eq_sorted = kmers == np.repeat(new_min, sizes)
        self.counts[uniq] += np.add.reduceat(
            eq_sorted.astype(np.uint32), starts)

    def stat_all(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """Histogram of duplication levels + mean GC per level + overall rate
        (reference: src/duplicate.cpp:131-166)."""
        hist_size = self.hist_size
        hist = np.zeros(hist_size, np.int64)
        mean_gc = np.zeros(hist_size, np.float64)
        gc_num = np.zeros(hist_size, np.int64)

        occupied = self.counts > 0
        counts = self.counts[occupied].astype(np.int64)
        # final gc: first record's gc if it holds the min, else 0
        gc = np.where(self.first_kmer[occupied] == self.min_kmer[occupied],
                      self.first_gc[occupied], 0).astype(np.float64)

        total_num = int(counts.sum())
        dup_num = int((counts - 1).sum())

        # note the reference's binning quirk: count > histSize -> last bin,
        # otherwise bin index = count (so bin histSize-1 aggregates both
        # count == histSize-1 and count > histSize... no: count == histSize
        # clamp to the last bin (duplicate.cpp:148-156; count == histSize
        # writes out of bounds in the C++ -- UB we do not copy, see PARITY.md)
        bins = np.minimum(counts, hist_size - 1)
        np.add.at(hist, bins, 1)
        np.add.at(mean_gc, bins, gc)
        np.add.at(gc_num, bins, 1)

        nz = gc_num > 0
        mean_gc[nz] = mean_gc[nz] / 255.0 / gc_num[nz]
        rate = 0.0 if total_num == 0 else dup_num / total_num
        return hist, mean_gc, rate
