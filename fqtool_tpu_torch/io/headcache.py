# Copy of fqtool_tpu/io/headcache.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Shared head-pack cache for the evaluation pre-passes.

The reference re-opens and re-reads the input head 4-5 times before
processing begins (read length, read number, ORS, PE adapter detection,
then the main pass -- reference: src/main.cpp:128-143, a startup quirk to
beat, not to keep).  Round 3 mirrored that: ``prepass`` was 17.8% of the
traced full-PE wall, most of it re-inflating and re-tokenizing bytes the
main pass immediately re-reads.

This cache opens ONE PackReader per input file with the main pass's exact
pack framing.  The pre-passes (host/evaluator.py) consume the cached packs
in matrix form, and the main runner then drains the cache and continues the
same reader -- every input byte is inflated and tokenized exactly once.

Activation is explicit (main.py) so library users of the evaluator see no
behavior change; every consumer falls back to direct file reads when no
cache is registered for the path.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .fastq import (PackReader, ReadPack, iter_packs, iter_packs_paired,
                    prefetch_iter, zip_pack_iters)

_registry: Dict[str, "HeadCache"] = {}
_lock = threading.Lock()


def activate(path: str, pack_reads: int, phred64: bool) -> None:
    """Register a head cache for ``path`` (idempotent; stdin excluded --
    its spool path handles rewind separately)."""
    if not path or path == "/dev/stdin":
        return
    with _lock:
        if path not in _registry:
            _registry[path] = HeadCache(path, pack_reads, phred64)


def get(path: str) -> Optional["HeadCache"]:
    with _lock:
        return _registry.get(path)


def discard_all() -> None:
    """Drop all caches (multi-host runs read inputs through the region
    planner instead of the cached readers)."""
    with _lock:
        caches = list(_registry.values())
        _registry.clear()
    for c in caches:
        c.close()


def iter_packs_cached(path: str, pack_reads: int, phred64: bool,
                      width_multiple: int = 8) -> Iterator[ReadPack]:
    """Resume the head cache into a full pack stream when the framing
    matches; otherwise a fresh reader (discarding any stale cache)."""
    with _lock:
        cache = _registry.pop(path, None)
    if cache is not None:
        if (cache.pack_reads == pack_reads and cache.phred64 == phred64
                and not cache.consumed):
            return cache.drain_iter()
        cache.close()
    return iter_packs(path, pack_reads, phred64, width_multiple)


def iter_packs_paired_cached(path1: str, path2: str, interleaved: bool,
                             pack_reads: int, phred64: bool,
                             width_multiple: int = 8
                             ) -> Iterator[Tuple[ReadPack, ReadPack]]:
    """Paired-pack stream resuming each side's head cache (interleaved input
    is record-framed and never cached -- direct passthrough)."""
    if interleaved:
        return iter_packs_paired(path1, path2, True, pack_reads, phred64,
                                 width_multiple)
    it1 = prefetch_iter(
        iter_packs_cached(path1, pack_reads, phred64, width_multiple), depth=2)
    it2 = prefetch_iter(
        iter_packs_cached(path2, pack_reads, phred64, width_multiple), depth=2)
    return zip_pack_iters(it1, it2)


class HeadCache:
    def __init__(self, path: str, pack_reads: int, phred64: bool):
        self.path = path
        self.pack_reads = pack_reads
        self.phred64 = phred64
        self.packs: List[ReadPack] = []
        self.consumed = False
        self._reader: Optional[PackReader] = PackReader(path, pack_reads,
                                                        phred64)
        self._reads = 0
        self._bases = 0
        self._eof = False
        self._pull_lock = threading.Lock()

    # -- filling -------------------------------------------------------
    def ensure(self, reads: float = float("inf"),
               bases: float = float("inf")) -> None:
        """Pull packs until >= ``reads`` records or >= ``bases`` bases are
        cached (or EOF).  Callers that stop at EITHER limit pass both."""
        with self._pull_lock:
            while (not self._eof and self._reads < reads
                   and self._bases < bases):
                pack = self._reader.next_pack()
                if pack is None:
                    self._eof = True
                    return
                self.packs.append(pack)
                self._reads += pack.count
                self._bases += int(pack.lens.sum())

    # -- pre-pass views --------------------------------------------------
    def read_len(self, n: int = 1000) -> int:
        """Max sequence length of the first ``n`` records (reference:
        src/evaluator.cpp:93-109)."""
        self.ensure(reads=n)
        best = 0
        left = n
        for pack in self.packs:
            take = min(left, pack.count)
            if take:
                best = max(best, int(pack.lens[:take].max(initial=0)))
            left -= take
            if left <= 0:
                break
        return best

    def matrix(self, read_limit: int,
               base_limit: int) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-padded [N, W] sequence matrix + lens with the adapter
        detector's record-take semantics (host/evaluator.py
        _load_record_matrix)."""
        self.ensure(reads=read_limit, bases=base_limit)
        mats: List[np.ndarray] = []
        lens_parts: List[np.ndarray] = []
        rows = 0
        bases = 0
        for pack in self.packs:
            if rows >= read_limit or bases >= base_limit:
                break
            lens = np.asarray(pack.lens)
            cum = np.cumsum(lens) - lens
            take = min(int(np.sum((bases + cum) < base_limit)),
                       read_limit - rows, pack.count)
            mats.append(pack.seq[:take])
            lens_parts.append(lens[:take].astype(np.int32))
            rows += take
            bases += int(lens[:take].sum())
        if not mats:
            return np.zeros((0, 0), np.uint8), np.zeros(0, np.int32)
        # width from the TAKEN rows (rounded to the pack width multiple), not
        # the full main-pass pack -- so the cached and uncached detection
        # paths produce byte-identical matrices (ADVICE r4: results were
        # already equivalent, but identical artifacts are easier to debug)
        all_lens = np.concatenate(lens_parts)
        width = -(-int(all_lens.max(initial=1)) // 8) * 8
        mats = [m[:, :width] if m.shape[1] >= width
                else np.pad(m, ((0, 0), (0, width - m.shape[1])))
                for m in mats]
        return np.concatenate(mats), all_lens

    def seq_prefix(self, base_limit: int) -> Tuple[np.ndarray, np.ndarray]:
        """(flat, lens) of records taken while the running base count stays
        below ``base_limit`` (the ORS prefix rule, src/evaluator.cpp:120-131:
        check-then-append)."""
        self.ensure(bases=base_limit)
        flats: List[np.ndarray] = []
        lens_parts: List[np.ndarray] = []
        bases = 0
        for pack in self.packs:
            lens = np.asarray(pack.lens, np.int64)
            cum = np.cumsum(lens) - lens
            take = int(np.sum((bases + cum) < base_limit))
            if take == 0:
                break
            lens = lens[:take]
            mask = (np.arange(pack.seq.shape[1])[None, :]
                    < lens[:, None])
            flats.append(pack.seq[:take][mask])
            lens_parts.append(lens)
            bases += int(lens.sum())
            if bases >= base_limit:
                break
        if not flats:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64)
        return np.concatenate(flats), np.concatenate(lens_parts)

    # -- main-pass resume ------------------------------------------------
    def drain_iter(self) -> Iterator[ReadPack]:
        self.consumed = True

        def gen():
            try:
                for i in range(len(self.packs)):
                    pack = self.packs[i]
                    self.packs[i] = None  # free as consumed
                    yield pack
                while not self._eof:
                    pack = self._reader.next_pack()
                    if pack is None:
                        return
                    yield pack
            finally:
                self.close()
        return gen()

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        self.packs = []
