# Copy of fqtool_tpu/host/ora_defer.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""World-size-invariant post-filter ORA sampling for multi-host runs.

The reference samples every ``over_rep_sampling``-th *passing* read, in
stream order, into the post-filter Stats (reference: src/stats.cpp:246-248,
277-293; sampled at seprocessor.cpp:342-345 only for reads that pass).
Which reads get sampled therefore depends on the global prefix count of
passing reads -- a quantity no rank knows during a multi-host run, because
earlier packs may be owned by other ranks.

Round 4 left this as the one documented JSON deviation (per-host strided
sampling, PARITY.md).  This module removes it: during the run each rank
spools the trimmed sequence bytes of EVERY passing read it emits (cheap:
one vectorized ragged gather per pack, sequential writes to a temp file),
keyed by the interval's global read index.  At end of stream the ranks
exchange their per-interval passing counts (a few ints per pack), compute
the exact global passing-prefix for each interval, and replay the
reference's every-s-th sampling locally -- the sampled set, and so the
final JSON, is identical to the single-process run at any world size.

Total sampling work equals the single-process run (1/s of passing reads
are scanned); the extra cost is one write+read of the passing sequence
bytes through the spool file.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Dict, List, Tuple

import numpy as np


def ragged_gather(mat: np.ndarray, rows: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Concatenate ``mat[rows[i], starts[i]:starts[i]+lens[i]]`` for all i
    into one flat uint8 array (vectorized; no per-row Python)."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.uint8)
    ends = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    row_idx = np.repeat(np.asarray(rows, np.int64), lens)
    col_idx = within + np.repeat(np.asarray(starts, np.int64), lens)
    return np.ascontiguousarray(mat[row_idx, col_idx])


def place_segments(dest: np.ndarray, dest_offsets: np.ndarray,
                   seg_flat: np.ndarray, seg_lens: np.ndarray) -> None:
    """Scatter per-row segments of ``seg_flat`` (concatenated in row order,
    lengths ``seg_lens``) into ``dest`` starting at ``dest_offsets[i]``."""
    seg_lens = np.asarray(seg_lens, np.int64)
    total = int(seg_lens.sum())
    if total == 0:
        return
    ends = np.cumsum(seg_lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - seg_lens,
                                                          seg_lens)
    idx = within + np.repeat(np.asarray(dest_offsets, np.int64), seg_lens)
    dest[idx] = seg_flat


class DeferredOraSampler:
    """Spool-and-replay post-filter ORA sampling for one Stats accumulator.

    ``add_interval(key, flat, lens)`` records one disjoint interval of the
    global emit stream: ``key`` is the interval's global read index (any
    disjoint ascending-keyed partition of the stream works -- prefix counts
    are computed over globally sorted keys), ``flat``/``lens`` the
    concatenated trimmed sequences of the interval's passing reads in emit
    order.  ``replay(prefix)`` runs the deferred sampling once the global
    passing-prefix count for each key is known.
    """

    def __init__(self, sampling: int, acc):
        self.sampling = int(sampling)
        self.acc = acc
        # anonymous spool: unlinked on close / process exit
        self._fh = tempfile.TemporaryFile(
            prefix="fqtool_ora_", dir=os.environ.get("TMPDIR") or None)
        # key -> (file offset, n_reads, flat byte length)
        self._intervals: Dict[int, Tuple[int, int, int]] = {}
        self._pos = 0

    def add_interval(self, key: int, flat: np.ndarray,
                     lens: np.ndarray) -> None:
        key = int(key)
        assert key not in self._intervals, "duplicate ORA interval key"
        lens32 = np.asarray(lens, np.int32)
        n = len(lens32)
        blob = lens32.tobytes() + flat.tobytes()
        self._fh.write(blob)
        self._intervals[key] = (self._pos, n, int(flat.nbytes))
        self._pos += len(blob)

    def counts(self) -> Dict[int, int]:
        """{interval key: passing read count} -- the end-of-stream exchange
        payload (plain ints)."""
        return {k: n for k, (_, n, _) in self._intervals.items()}

    @staticmethod
    def merge_counts(per_rank: List[Dict[int, int]]) -> Dict[int, int]:
        merged: Dict[int, int] = {}
        for d in per_rank:
            merged.update(d)
        return merged

    @staticmethod
    def prefixes(merged: Dict[int, int]) -> Dict[int, int]:
        """Global passing-read prefix count for every interval key."""
        out = {}
        run = 0
        for k in sorted(merged):
            out[k] = run
            run += merged[k]
        return out

    def replay(self, prefix: Dict[int, int]) -> None:
        s = self.sampling
        for key in sorted(self._intervals):
            off, n, flat_len = self._intervals[key]
            if n == 0:
                continue
            first = (-prefix[key]) % s
            if first >= n:
                continue
            self._fh.seek(off)
            lens = np.frombuffer(self._fh.read(4 * n), np.int32)
            flat = self._fh.read(flat_len)
            ends = np.cumsum(lens.astype(np.int64))
            starts = ends - lens
            for k in range(first, n, s):
                self.acc.add_over_rep_read(flat[starts[k]:ends[k]])

    def close(self) -> None:
        self._fh.close()
        self._intervals.clear()


def exchange_and_replay(mh, samplers: List["DeferredOraSampler"]) -> None:
    """One collective round per sampler stream: gather per-interval passing
    counts to rank 0, broadcast the merged map, replay locally.  All ranks
    must call this in lockstep (before the stats gather)."""
    for smp in samplers:
        gathered = mh.gather(smp.counts())
        if mh.rank == 0:
            merged = DeferredOraSampler.merge_counts(gathered)
            mh.broadcast(merged)
        else:
            merged = mh.broadcast()
        smp.replay(DeferredOraSampler.prefixes(merged))
        smp.close()
