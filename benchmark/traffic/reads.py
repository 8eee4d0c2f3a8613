"""Synthetic single-end reads, made from a seed.

Each read starts a random fragment whose length follows a clipped normal
law.  A read that runs past its fragment reads what a TruSeq library holds
past the insert: the read-1 adapter, the i7 index, the rest of the P7
adapter, and then G, the no-signal call of two-colour chemistry once the
cluster has nothing left to read.  A share of the reads goes dark at a cycle
drawn uniformly from ``dark_from`` to the read's end, and reads G from there
(Chen et al. 2018, "polyG tail trimming").  The quality law, the 1 %
substitutions and the N runs are those of ``traffic/pairs.py``, whose bin
table, bcl2fastq name lines and FASTQ writer this module uses.

The module gives what ``run.py`` asks of a generator (see ``pairs.py``):
``UNIT``, ``INPUTS``, ``law``, ``make`` and ``make_and_write``.  The stream
is made in blocks of ``BLOCK`` reads, block k from the seed sequence
``(seed, k)``, so a job's reads do not depend on how many threads make
them.  numpy only.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from traffic.pairs import ACGT, ADAPTER_R1, bin_table, fastq_bytes, name_lines

UNIT = "reads"
INPUTS = ("r1.fq.gz",)
BLOCK = 131_072
# the rest of the P7 adapter after the i7 index (Illumina Adapter Sequences,
# TruSeq single index adapters)
P7_REST = b"ATCTCGTATGCCGTCTTCTGCTTG"


@dataclass(frozen=True)
class ReadLaw:
    """The parameters of a cell's traffic file (``workloads/<cell>.json``,
    key ``traffic``)."""

    read_len: int = 75
    fragment_mean: float = 180.0
    fragment_sd: float = 60.0
    fragment_min: int = 20
    fragment_max: int = 600
    # the share of reads that go dark, at a cycle from dark_from on
    dark_share: float = 0.01
    dark_from: int = 20
    subst_rate: float = 0.01
    n_run_rate: float = 0.005
    qual_start: float = 38.0
    qual_drop: float = 14.0
    qual_sd: float = 4.0
    qual_min: int = 2
    qual_max: int = 41
    # Phred levels the instrument reports; empty = unbinned
    qual_bins: List[int] = field(default_factory=list)
    # the read name, as traffic/pairs.py::name_lines writes it
    name_head: str = "NB501288:411:HKFJ2BGXB"
    lane: int = 1
    tile_first: int = 11101
    index: str = "ATCACGAT"

    @classmethod
    def from_dict(cls, d: dict) -> "ReadLaw":
        return cls(**{k: (list(v) if isinstance(v, list) else v)
                      for k, v in d.items()})

    def past_fragment(self) -> bytes:
        """The bases a read reads past its fragment, before the G."""
        return ADAPTER_R1 + self.index.split("+")[0].encode() + P7_REST


def law(params: dict) -> ReadLaw:
    """The law of a cell file's ``traffic`` parameters."""
    return ReadLaw.from_dict(params)


def make_block(law: ReadLaw, n: int, seed: int, block: int):
    """(seq, qual, frag, dark) of ``n`` reads: uint8 [n, read_len] ASCII
    planes, the int32 fragment lengths and the int32 cycle at which each read
    goes dark (``read_len`` where it does not)."""
    rng = np.random.default_rng([seed % (1 << 64), block])
    L = law.read_len
    frag = np.rint(rng.normal(law.fragment_mean, law.fragment_sd, n))
    frag = np.minimum(np.maximum(frag, law.fragment_min),
                      law.fragment_max).astype(np.int32)
    j = np.arange(L, dtype=np.int32)[None, :]
    seq = ACGT[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    # past the fragment: the adapter, the index and P7, then G to the end
    past = np.frombuffer(law.past_fragment(), np.uint8)
    k = j - frag[:, None]
    tail = np.where(k < len(past), past[np.clip(k, 0, len(past) - 1)],
                    np.uint8(ord("G")))
    seq = np.where(k >= 0, tail, seq)
    dark = np.full(n, L, np.int32)
    goes = rng.random(n) < law.dark_share
    dark[goes] = rng.integers(law.dark_from, L, int(goes.sum()))
    seq[j >= dark[:, None]] = ord("G")
    sub = rng.random(seq.shape, dtype=np.float32) < law.subst_rate
    seq[sub] = ACGT[rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)]
    rows = np.flatnonzero(rng.random(n) < law.n_run_rate)
    starts = rng.integers(0, L, len(rows))
    lens = rng.integers(1, 9, len(rows))
    for r, s, m in zip(rows, starts, lens):
        seq[r, s : s + m] = ord("N")
    q = (np.float32(law.qual_start) - (law.qual_drop / L * j).astype(np.float32)
         + law.qual_sd * rng.standard_normal(seq.shape, np.float32))
    np.rint(q, out=q)
    np.maximum(q, law.qual_min, out=q)
    np.minimum(q, law.qual_max, out=q)
    q = q.astype(np.uint8)
    if law.qual_bins:
        q = bin_table(law.qual_bins)[q]
    q[seq == ord("N")] = 2
    return seq, q + 33, frag, dark


class Reads:
    """A job's reads: the planes the reference reads, and the gzipped FASTQ
    file the program reads."""

    def __init__(self, law: ReadLaw, seq, qual, frag, dark):
        self.law = law
        self.seq, self.qual = seq, qual
        self.frag, self.dark = frag, dark

    def names(self, idx: np.ndarray) -> np.ndarray:
        """The name lines of reads ``idx``."""
        return name_lines(self.law, idx, 1)

    @property
    def count(self) -> int:
        return len(self.frag)

    @property
    def bases(self) -> int:
        """The input bases the program reads."""
        return self.count * self.law.read_len


def _blocks(law: ReadLaw, n: int, seed: int, ex: ThreadPoolExecutor):
    spans = [(lo, min(BLOCK, n - lo)) for lo in range(0, n, BLOCK)]
    return ex.map(lambda s: make_block(law, s[1], seed, s[0] // BLOCK), spans)


def _join(law: ReadLaw, blocks) -> Reads:
    if not blocks:
        z = np.zeros((0, law.read_len), np.uint8)
        e = np.zeros(0, np.int32)
        return Reads(law, z, z, e, e)
    return Reads(law, *(np.concatenate([b[i] for b in blocks]) for i in range(4)))


def make(law: ReadLaw, n: int, seed: int, threads: int = 6) -> Reads:
    """``n`` reads of the law from ``seed``, made block by block on
    ``threads`` threads."""
    with ThreadPoolExecutor(max(1, threads)) as ex:
        return _join(law, list(_blocks(law, n, seed, ex)))


def make_and_write(law: ReadLaw, n: int, seed: int, *paths: str,
                   level: int = 1, threads: int = 6) -> Tuple[Reads, int]:
    """``make`` while the blocks are deflated, in order, into one gzip
    stream at the one path of ``paths`` (``INPUTS``) on a thread of its own;
    returns the reads and the bytes written."""
    (path,) = paths
    comp = zlib.compressobj(level, zlib.DEFLATED, 31)
    blocks = []
    with open(path, "wb") as f, ThreadPoolExecutor(max(1, threads)) as ex, \
            ThreadPoolExecutor(1) as w:
        pending = []

        def deflate(seq, qual, first):
            data = comp.compress(fastq_bytes(law, seq, qual, 1, first))
            f.write(data)
            return len(data)

        first = 0
        for b in _blocks(law, n, seed, ex):
            blocks.append(b)
            pending.append(w.submit(deflate, b[0], b[1], first))
            first += len(b[2])
        written = sum(p.result() for p in pending)
        tail = comp.flush()
        f.write(tail)
        written += len(tail)
    return _join(law, blocks), written
