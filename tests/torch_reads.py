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
