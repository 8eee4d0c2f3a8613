"""Synthetic paired-end reads, made from a seed.

Pairs are read from both ends of a random fragment (the insert) whose length
follows a clipped normal law.  A read that runs past its insert reads the
TruSeq adapter of its mate and then random bases.  About 1 % of the bases are
substituted, about 0.5 % of the reads carry a run of 1-8 N, and the quality
decays linearly along the read with Gaussian noise; it may be binned to the
levels an instrument reports.  The law of the data is that of
``tests/torch_pairs.py::make_pairs``, with its constants as parameters.
Read names follow the layout that Illumina's bcl2fastq writes (CASAVA 1.8),
with the instrument, run, flowcell, lane and index as parameters.

A generator module gives ``UNIT`` (what a job counts: the cell file's
``job_<UNIT>`` key), ``INPUTS`` (the file names a job reads), ``law(params)``,
``make(law, n, seed)`` and ``make_and_write(law, n, seed, *paths)``, one path
per entry of ``INPUTS``; its records give ``count`` and ``bases``.  ``run.py``
finds it by the cell's ``traffic.generator``.

The stream is made in blocks of ``BLOCK`` pairs, block k from the seed
sequence ``(seed, k)``, so a job's pairs do not depend on how many threads
make them.  numpy only.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

UNIT = "pairs"
INPUTS = ("r1.fq.gz", "r2.fq.gz")
BLOCK = 131_072
TILE_PAIRS = 20_000   # pairs a tile holds before the name's tile steps
TILES = 12
ACGT = np.frombuffer(b"ACGT", np.uint8)
ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMP = np.full(256, ord("N"), np.uint8)
for _s, _d in zip(b"ACGTN", b"TGCAN"):
    COMP[_s] = _d


@dataclass(frozen=True)
class PairLaw:
    """The parameters of a cell's traffic file (``workloads/<cell>.json``,
    key ``traffic``)."""

    read_len: int = 150
    insert_mean: float = 250.0
    insert_sd: float = 75.0
    insert_min: int = 60
    insert_max: int = 600
    adapters: bool = True
    subst_rate: float = 0.01
    n_run_rate: float = 0.005
    qual_start: float = 38.0
    qual_drop: float = 14.0
    qual_sd: float = 4.0
    qual_min: int = 2
    qual_max: int = 41
    # Phred levels the instrument reports; empty = unbinned
    qual_bins: List[int] = field(default_factory=list)
    # the read name: @<name_head>:<lane>:<tile>:<x>:<y> <mate>:N:0:<index>,
    # name_head being <instrument>:<run>:<flowcell>
    name_head: str = "NB501288:411:HKFJ2BGXB"
    lane: int = 1
    tile_first: int = 11101
    index: str = "ATCACGAT"

    @classmethod
    def from_dict(cls, d: dict) -> "PairLaw":
        return cls(**{k: (list(v) if isinstance(v, list) else v)
                      for k, v in d.items()})


def law(params: dict) -> PairLaw:
    """The law of a cell file's ``traffic`` parameters."""
    return PairLaw.from_dict(params)


def bin_table(bins) -> np.ndarray:
    """Phred value -> the nearest reported level (ties to the lower)."""
    levels = np.asarray(sorted(bins), np.int64)
    q = np.arange(64)[:, None]
    return levels[np.argmin(np.abs(q - levels[None, :]) * 2
                            + (q < levels[None, :]), axis=1)].astype(np.uint8)


def _past_insert(filler: np.ndarray, isize: np.ndarray, adapter: bytes):
    """``filler`` with the adapter written from each row's insert end on."""
    ad = np.frombuffer(adapter, np.uint8)
    rows = np.flatnonzero(isize < filler.shape[1])
    k = (np.arange(filler.shape[1], dtype=np.int32)[None, :]
         - isize[rows, None])
    at = (k >= 0) & (k < len(ad))
    sub = filler[rows]
    sub[at] = ad[k[at]]
    out = filler.copy()
    out[rows] = sub
    return out


def make_block(law: PairLaw, n: int, seed: int, block: int):
    """(seq1, qual1, seq2, qual2, isize) of ``n`` pairs: uint8 [n, read_len]
    ASCII planes and the int32 insert sizes."""
    rng = np.random.default_rng([seed % (1 << 64), block])
    L = law.read_len
    isize = np.rint(rng.normal(law.insert_mean, law.insert_sd, n))
    isize = np.minimum(np.maximum(isize, law.insert_min),
                       law.insert_max).astype(np.int32)
    # the insert's first L bases, then (in reverse) its last L bases where
    # they lie past the first L: read2 base j is insert position isize-1-j
    frag = ACGT[rng.integers(0, 4, (n, 2 * L), dtype=np.uint8)]
    j = np.arange(L)[None, :]
    inside = j < isize[:, None]
    filler = ACGT[rng.integers(0, 4, (2, n, L), dtype=np.uint8)]
    if law.adapters:
        filler = (_past_insert(filler[0], isize, ADAPTER_R1),
                  _past_insert(filler[1], isize, ADAPTER_R2))
    seq1 = np.where(inside, frag[:, :L], filler[0])
    p = isize[:, None] - 1 - j
    col = np.where(p < L, np.clip(p, 0, L - 1), L + j)
    seq2 = np.where(inside, COMP[np.take_along_axis(frag, col, 1)], filler[1])
    table = bin_table(law.qual_bins) if law.qual_bins else None
    quals = []
    for seq in (seq1, seq2):
        sub = rng.random(seq.shape, dtype=np.float32) < law.subst_rate
        seq[sub] = ACGT[rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)]
        rows = np.flatnonzero(rng.random(n) < law.n_run_rate)
        starts = rng.integers(0, L, len(rows))
        lens = rng.integers(1, 9, len(rows))
        for r, s, k in zip(rows, starts, lens):
            seq[r, s : s + k] = ord("N")
        q = (np.float32(law.qual_start) - (law.qual_drop / L * j).astype(np.float32)
             + law.qual_sd * rng.standard_normal(seq.shape, np.float32))
        np.rint(q, out=q)
        np.maximum(q, law.qual_min, out=q)
        np.minimum(q, law.qual_max, out=q)
        q = q.astype(np.uint8)
        if table is not None:
            q = table[q]
        q[seq == ord("N")] = 2
        quals.append(q + 33)
    return seq1, quals[0], seq2, quals[1], isize


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((len(values), width), np.uint8)
    for c in range(width):
        out[:, c] = (values // 10 ** (width - 1 - c)) % 10 + 48
    return out


def name_lines(law: PairLaw, idx: np.ndarray, mate: int) -> np.ndarray:
    """uint8 [n, w] name lines (no newline) of the pairs ``idx``:
    ``@<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> <mate>:N:0:<index>``.
    The tile steps every ``TILE_PAIRS`` pairs over ``TILES`` tiles from
    ``tile_first``; y is the pair's place in its tile and x counts the
    tiles passed, both five digits, so every name of a law has one width and
    the first 400 M names differ."""
    idx = np.asarray(idx, np.int64)
    n = len(idx)

    def text(b: bytes) -> np.ndarray:
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))
    tile = law.tile_first + (idx // TILE_PAIRS) % TILES
    x = 10_000 + (idx // TILE_PAIRS) % 20_000
    y = 10_000 + idx % TILE_PAIRS
    return np.concatenate([
        text(b"@%s:%d:" % (law.name_head.encode(), law.lane)),
        _digits(tile, len(str(law.tile_first))), text(b":"),
        _digits(x, 5), text(b":"), _digits(y, 5),
        text(b" %d:N:0:%s" % (mate, law.index.encode()))], axis=1)


def fastq_bytes(law: PairLaw, seq: np.ndarray, qual: np.ndarray, mate: int,
                first: int) -> bytes:
    """Fixed-width FASTQ records of the rows, named from ``first``."""
    n, L = seq.shape
    names = name_lines(law, np.arange(first, first + n), mate)
    w = names.shape[1]
    rec = np.empty((n, w + 1 + L + 3 + L + 1), np.uint8)
    rec[:, :w] = names
    rec[:, w] = ord("\n")
    rec[:, w + 1 : w + 1 + L] = seq
    rec[:, w + 1 + L : w + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + 4 + L : w + 4 + 2 * L] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()


class Pairs:
    """A job's pairs: the planes the reference reads, and the gzipped FASTQ
    files the program reads."""

    def __init__(self, law: PairLaw, seq1, qual1, seq2, qual2, isize):
        self.law = law
        self.seq1, self.qual1, self.seq2, self.qual2 = seq1, qual1, seq2, qual2
        self.isize = isize

    def names(self, idx: np.ndarray, mate: int) -> np.ndarray:
        """The name lines of pairs ``idx`` of mate ``mate``."""
        return name_lines(self.law, idx, mate)

    @property
    def count(self) -> int:
        return len(self.isize)

    @property
    def bases(self) -> int:
        """The input bases the program reads: both mates of every pair."""
        return self.count * 2 * self.law.read_len


def _blocks(law: PairLaw, n: int, seed: int, ex: ThreadPoolExecutor):
    spans = [(lo, min(BLOCK, n - lo)) for lo in range(0, n, BLOCK)]
    return ex.map(lambda s: make_block(law, s[1], seed, s[0] // BLOCK), spans)


def _join(law: PairLaw, blocks) -> Pairs:
    if not blocks:
        z = np.zeros((0, law.read_len), np.uint8)
        return Pairs(law, z, z, z, z, np.zeros(0, np.int32))
    return Pairs(law, *(np.concatenate([b[i] for b in blocks]) for i in range(5)))


def make(law: PairLaw, n: int, seed: int, threads: int = 6) -> Pairs:
    """``n`` pairs of the law from ``seed``, made block by block on
    ``threads`` threads."""
    with ThreadPoolExecutor(max(1, threads)) as ex:
        return _join(law, list(_blocks(law, n, seed, ex)))


def make_and_write(law: PairLaw, n: int, seed: int, *paths: str,
                   level: int = 1, threads: int = 6) -> Tuple[Pairs, int]:
    """``make`` while each mate's blocks are deflated, in order, into
    one gzip stream per file of ``paths`` (read1's, read2's: ``INPUTS``) on a
    thread of its own; returns the pairs and the bytes written."""
    path1, path2 = paths
    comps = [zlib.compressobj(level, zlib.DEFLATED, 31) for _ in range(2)]
    blocks = []
    written = 0
    with open(path1, "wb") as f1, open(path2, "wb") as f2, \
            ThreadPoolExecutor(max(1, threads)) as ex, \
            ThreadPoolExecutor(1) as w1, ThreadPoolExecutor(1) as w2:
        pending = []

        def deflate(comp, f, seq, qual, mate, first):
            data = comp.compress(fastq_bytes(law, seq, qual, mate, first))
            f.write(data)
            return len(data)

        first = 0
        for b in _blocks(law, n, seed, ex):
            blocks.append(b)
            pending.append(w1.submit(deflate, comps[0], f1, b[0], b[1], 1, first))
            pending.append(w2.submit(deflate, comps[1], f2, b[2], b[3], 2, first))
            first += len(b[4])
        written = sum(p.result() for p in pending)
        for comp, f in zip(comps, (f1, f2)):
            tail = comp.flush()
            f.write(tail)
            written += len(tail)
    return _join(law, blocks), written
