# Copy of fqtool_tpu/host/duplicate.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
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


# Dense per-key arrays cost 22 bytes x 4^keylen: fine through keylen 15
# (~24 GB at 15 is already too much -- cap lower), unacceptable past it.  The
# reference allocates 13 B x 4^keylen unconditionally and OOMs at keylen >= 16
# (duplicate.cpp:3-13); instead of copying that flaw, large key lengths spill
# to a sparse slot table (dict key->slot over growable arrays) with identical
# combine semantics.
_DENSE_KEYLEN_MAX = 15  # 4^15 * 22 B = 24 GB worst case; >= 16 goes sparse


class DuplicateTable:
    def __init__(self, keylen: int, hist_size: int, force_sparse: bool = False):
        self.keylen = keylen
        self.hist_size = hist_size
        self.sparse = force_sparse or keylen > _DENSE_KEYLEN_MAX
        n = 1024 if self.sparse else (1 << (2 * keylen))
        self._slots: dict = {} if self.sparse else None
        # all arrays calloc-backed zeros (np.full of 4^keylen entries costs
        # ~0.4s each at keylen 12); min_kmer/first_pos are only meaningful
        # where ``seen`` is set, with unseen treated as +inf by the folds
        self.min_kmer = np.zeros(n, np.uint64)
        self.counts = np.zeros(n, np.uint32)
        self.first_kmer = np.zeros(n, np.uint64)
        self.first_gc = np.zeros(n, np.uint8)
        self.seen = np.zeros(n, bool)
        # global stream position of each key's first record: lets tables from
        # different hosts (each holding a strided subset of the stream) merge
        # with the exact first-record-GC rule
        self.first_pos = np.zeros(n, np.int64)
        self._next_pos = 0

    def _grow(self, need: int) -> None:
        cap = len(self.counts)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)

        def grow(a, fill=0):
            out = np.full(new_cap, fill, a.dtype)
            out[:cap] = a
            return out

        self.min_kmer = grow(self.min_kmer)
        self.counts = grow(self.counts)
        self.first_kmer = grow(self.first_kmer)
        self.first_gc = grow(self.first_gc)
        self.seen = grow(self.seen)
        self.first_pos = grow(self.first_pos)

    def _to_slots(self, key: np.ndarray) -> np.ndarray:
        """Map raw keys to dense slot indices (sparse mode), preserving order."""
        slots = self._slots
        nxt = len(slots)
        out = np.empty(len(key), np.int64)
        for i, k in enumerate(key.tolist()):
            s = slots.get(k)
            if s is None:
                s = slots[k] = nxt
                nxt += 1
            out[i] = s
        self._grow(nxt)
        return out

    def add_batch(self, key: np.ndarray, kmer_hi: np.ndarray, kmer_lo: np.ndarray,
                  gc: np.ndarray, valid: np.ndarray,
                  key_hi: np.ndarray = None, base: int = None) -> None:
        """Fold one batch of per-read records (input order preserved for the
        first-record rule).  ``key_hi`` carries key bits past 32 (keylen > 16,
        sparse mode only).  ``base`` is the global stream index of row 0 (for
        cross-host merges); defaults to a local monotonic counter."""
        if base is None:
            base = self._next_pos
        self._next_pos = max(self._next_pos, base + len(valid))
        if not valid.any():
            return
        pos = base + np.flatnonzero(valid)
        # device keys ride as int32 bit patterns; reinterpret as unsigned so
        # keylen = 16 (keys past 2^31) still indexes correctly
        key = key[valid].view(np.uint32).astype(np.int64)
        if key_hi is not None:
            key = key | (key_hi[valid].view(np.uint32).astype(np.int64) << 32)
        if self.sparse:
            key = self._to_slots(key)
        kmer = (kmer_hi[valid].astype(np.uint64) << np.uint64(32)) | \
            kmer_lo[valid].astype(np.uint64)
        gc = gc[valid]

        # group batch records by key with one stable sort; all per-group
        # folds are C-speed reduceats over the batch (never O(table size) --
        # a full-table scratch array costs ~0.5s/batch at keylen 12)
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
        self.first_pos[new_keys] = pos[first_in_batch[newly]]
        self.seen[new_keys] = True

        # batch minimum per key, then merge with the running minimum
        # (unseen-before keys read as +inf: table slots are zero-initialized)
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

    # -- cross-host reduction ------------------------------------------
    def payload(self) -> dict:
        """Sparse snapshot of live entries for cross-host transfer: raw keys
        plus the per-key combine state."""
        if self.sparse:
            nslots = len(self._slots)
            raw = np.fromiter(self._slots.keys(), np.int64, nslots)
            slot = np.fromiter(self._slots.values(), np.int64, nslots)
            sel = self.seen[slot]
            raw, slot = raw[sel], slot[sel]
        else:
            slot = np.flatnonzero(self.seen)
            raw = slot
        return dict(key=raw.astype(np.int64),
                    min_kmer=self.min_kmer[slot],
                    counts=self.counts[slot],
                    first_kmer=self.first_kmer[slot],
                    first_gc=self.first_gc[slot],
                    first_pos=self.first_pos[slot])

    def merge_payload(self, pl: dict) -> None:
        """Combine another table's snapshot.  Per key the sequential outcome
        is (min kmer, #records equal to the min, first record's state), all
        order-independent given ``first_pos``, so the merge is associative."""
        key = pl["key"]
        if len(key) == 0:
            return
        slot = self._to_slots(key) if self.sparse else key
        o_min = pl["min_kmer"]
        o_cnt = pl["counts"]
        s_min = np.where(self.seen[slot], self.min_kmer[slot],
                         np.iinfo(np.uint64).max)
        s_cnt = self.counts[slot]
        self.counts[slot] = np.where(
            s_min == o_min, s_cnt + o_cnt,
            np.where(o_min < s_min, o_cnt, s_cnt))
        self.min_kmer[slot] = np.minimum(s_min, o_min)
        other_first = ~self.seen[slot] | (pl["first_pos"] < self.first_pos[slot])
        for mine, theirs in ((self.first_kmer, pl["first_kmer"]),
                             (self.first_gc, pl["first_gc"]),
                             (self.first_pos, pl["first_pos"])):
            cur = mine[slot]
            mine[slot] = np.where(other_first, theirs, cur)
        self.seen[slot] = True

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
