"""Synthetic single-end reads for the fqtool_tpu_torch tests and chip_smoke.py.

Each 151 bp read starts a random fragment whose length is drawn from about
N(250, 75) and clipped to [20, 600].  A read that runs past its fragment
reads the Illumina adapter ``AGATCGGAAGAGCACACGTCTGAACTCCAGTCA`` and then G
(the dark cycles of two-colour chemistry), so adapter, polyG and polyX
trimming have real work.  About 1% substitutions, N runs in ~0.5% of the
reads, and the quality profile of ``torch_pairs`` that decays along the read.
numpy only: no JAX, no torch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .torch_pairs import fastq_bytes

ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_reads(n: int, seed: int, read_len: int = 151):
    """Return (seq, qual, frag_len): uint8 [n, read_len] ASCII planes and the
    int32 fragment lengths they were cut from."""
    rng = np.random.default_rng(seed)
    flen = np.clip(np.rint(rng.normal(250, 75, n)), 20, 600).astype(np.int32)
    j = np.arange(read_len)[None, :]
    seq = _ACGT[rng.integers(0, 4, (n, read_len), dtype=np.uint8)]
    tail = np.full((n, read_len), ord("G"), np.uint8)
    ad = j - flen[:, None]  # index into the adapter past the fragment
    in_ad = (ad >= 0) & (ad < len(ADAPTER))
    tail[in_ad] = np.frombuffer(ADAPTER, np.uint8)[ad[in_ad]]
    seq = np.where(j < flen[:, None], seq, tail)
    sub = rng.random(seq.shape) < 0.01
    seq[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)]
    # N runs of 1-8 bases in ~0.5% of the reads
    rows = np.flatnonzero(rng.random(n) < 0.005)
    starts = rng.integers(0, read_len, len(rows))
    lens = rng.integers(1, 9, len(rows))
    for r, s, k in zip(rows, starts, lens):
        seq[r, s : s + k] = ord("N")
    q = 38 - 14 * j / read_len + rng.normal(0, 4, seq.shape)
    q = np.clip(np.rint(q), 2, 41).astype(np.uint8)
    q[seq == ord("N")] = 2
    return seq, q + 33, flen


QUAL_BINS = (2, 11, 21, 27, 32, 37)  # six Phred levels, as binned instruments report
# quality byte -> its binned byte: the highest bin not above it (Q0-Q1 -> Q2)
QUAL_BIN_TABLE = np.arange(256, dtype=np.uint8)
for _q in range(94):
    QUAL_BIN_TABLE[_q + 33] = max((b for b in QUAL_BINS if b <= _q),
                                  default=QUAL_BINS[0]) + 33


def bin_qualities(src, dst) -> Path:
    """``src`` (plain FASTQ, single-end or one mate) with every quality
    binned by ``QUAL_BIN_TABLE``: six quality values, so that a pack's
    (base, quality) bytes fit the 32-entry dictionary of the 5-bit
    transport."""
    table = QUAL_BIN_TABLE.tobytes()
    lines = Path(src).read_bytes().splitlines(keepends=True)
    lines[3::4] = [line.translate(table) for line in lines[3::4]]
    Path(dst).write_bytes(b"".join(lines))
    return Path(dst)


def write_reads(path, n: int, seed: int, read_len: int = 151,
                block: int = 250_000) -> np.ndarray:
    """Write ``n`` reads as plain FASTQ to ``path`` in blocks of ``block``
    reads (block k is seeded with ``seed + k``, so a prefix of the stream is
    the same for any ``n``); returns the fragment lengths."""
    sizes = []
    with open(path, "wb") as f:
        for k, lo in enumerate(range(0, n, block)):
            m = min(block, n - lo)
            seq, qual, flen = make_reads(m, seed + k, read_len)
            f.write(fastq_bytes(seq, qual, 1, lo))
            sizes.append(flen)
    return np.concatenate(sizes) if sizes else np.zeros(0, np.int32)
