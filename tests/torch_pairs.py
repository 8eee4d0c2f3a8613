"""Synthetic paired-end reads for the fqtool_tpu_torch tests and chip_smoke.py.

Pairs are read from both ends of a random fragment whose length (the insert
size) is drawn from about N(250, 75) and clipped to [60, 600], so most 2x151 bp
pairs truly overlap and some run past the fragment: into random bases, or
with ``adapters=True`` into the TruSeq adapters and then random bases.  About
1% substitutions, a few N runs, and a quality profile that decays along the
read.  numpy only: no JAX, no torch.
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
# the TruSeq adapters that follow the insert in read1 and read2
ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
_COMP = np.full(256, ord("N"), np.uint8)
for _s, _d in zip(b"ACGTN", b"TGCAN"):
    _COMP[_s] = _d


def _past_insert(filler: np.ndarray, isize: np.ndarray, adapter: bytes):
    """``filler`` with the adapter written from each row's insert end on."""
    ad = np.frombuffer(adapter, np.uint8)
    k = np.arange(filler.shape[1])[None, :] - isize[:, None]
    return np.where((k >= 0) & (k < len(ad)), ad[np.clip(k, 0, len(ad) - 1)],
                    filler)


def make_pairs(n: int, seed: int, read_len: int = 151, adapters: bool = False):
    """Return (seq1, qual1, seq2, qual2, isize): uint8 [n, read_len] ASCII
    planes and the int32 insert sizes they were cut from.  A read past its
    insert reads random bases, or with ``adapters`` its TruSeq adapter first;
    the random draws are the same either way."""
    rng = np.random.default_rng(seed)
    isize = np.clip(np.rint(rng.normal(250, 75, n)), 60, 600).astype(np.int32)
    frag = _ACGT[rng.integers(0, 4, (n, 600), dtype=np.uint8)]
    j = np.arange(read_len)[None, :]
    inside = j < isize[:, None]
    filler = _ACGT[rng.integers(0, 4, (2, n, read_len), dtype=np.uint8)]
    if adapters:
        filler = (_past_insert(filler[0], isize, ADAPTER_R1),
                  _past_insert(filler[1], isize, ADAPTER_R2))
    seq1 = np.where(inside, frag[:, :read_len], filler[0])
    back = np.take_along_axis(frag, np.clip(isize[:, None] - 1 - j, 0, 599), axis=1)
    seq2 = np.where(inside, _COMP[back], filler[1])
    quals = []
    for seq in (seq1, seq2):
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
        quals.append(q + 33)
    return seq1, quals[0], seq2, quals[1], isize


def plant_low_quality(seq, qual, rng, rows_frac=0.5, most=3):
    """On a fraction of the rows, up to ``most`` substitutions at quality
    '#' (Q2): inside an overlap whose mate base is >= Q30 they are what the
    base correction fixes, fewer than 5 a read so dead patch slots occur."""
    B, L = seq.shape
    for r in np.flatnonzero(rng.random(B) < rows_frac):
        cols = rng.integers(0, L, int(rng.integers(1, most + 1)))
        seq[r, cols] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, len(cols))]
        qual[r, cols] = ord("#")


def planted_pairs(seed: int, B: int, L1: int, L2: int):
    """(seq1, qual1, rlen1, seq2, qual2, rlen2) of pairs read from both ends
    of fragments 1/3 to 2x the wider read long (so inserts both shorter and
    longer than a read occur at every width), read lengths up to the width
    (~10% at 0-3), qualities mostly >= Q30 with up to 3 Q2 substitutions on
    half of the reads, zero past each length."""
    rng = np.random.default_rng(seed)
    L = max(L1, L2)
    isize = rng.integers(L // 3, 2 * L, B)
    frag = _ACGT[rng.integers(0, 4, (B, 2 * L))]
    j = np.arange(L)[None, :]
    inside = j < isize[:, None]
    back = np.take_along_axis(frag, np.clip(isize[:, None] - 1 - j, 0, 2 * L - 1), 1)
    reads = (np.where(inside, frag[:, :L], _ACGT[rng.integers(0, 4, (B, L))]),
             np.where(inside, _COMP[back], _ACGT[rng.integers(0, 4, (B, L))]))
    out = []
    for s, W in zip(reads, (L1, L2)):
        s = s[:, :W].copy()
        q = rng.integers(30, 42, (B, W)).astype(np.uint8) + 33
        plant_low_quality(s, q, rng)
        rlen = np.full(B, W, np.int32)
        short = rng.random(B) < 0.3
        rlen[short] = rng.integers(0, W + 1, short.sum())
        tiny = rng.random(B) < 0.1
        rlen[tiny] = rng.integers(0, 4, tiny.sum())
        pad = np.arange(W)[None, :] >= rlen[:, None]
        s[pad] = 0
        q[pad] = 0
        out += [s, q, rlen]
    return out


# read bytes of the overlap edge cases: both cases of ACGTN, and '.' and 'R',
# which are compared as raw bytes and complement to 'N'
_EDGE_BYTES = np.frombuffer(b"ACGTNacgtn.R", np.uint8)
_EDGE_P = np.array([0.22] * 4 + [0.03] + [0.01] * 7)
_EDGE_P /= _EDGE_P.sum()
# read2 bytes whose complement is each read1 byte (``_COMP_FULL`` below)
_COMP_FULL = np.full(256, ord("N"), np.uint8)
for _s, _d in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP_FULL[_s] = _d
_PRE_IMAGES = {c: np.flatnonzero(_COMP_FULL[_EDGE_BYTES] == c)
               for c in b"ACGTN"}


# the overlap edge cases (tests/test_torch_overlap.py on the CPU, chip_smoke.py
# phase 3 on the card): (l1, l2, diff_limit, require, random bytes past the
# lengths); widths unpadded, so the kernel loads bytewise, except 48/64 (8
# bytes at once)
OVERLAP_EDGE_CASES = [
    (37, 37, 5, 10, False), (37, 37, 60, 10, True), (50, 50, 0, 30, False),
    (48, 64, 5, 10, True),
    (50, 50, 5, 10, True), (51, 53, 5, 30, False), (53, 51, 5, 10, True),
    (51, 51, 60, 30, False), (151, 151, 5, 30, False), (151, 151, 0, 30, True),
    (151, 151, 60, 30, False), (151, 53, 5, 30, False), (37, 151, 5, 10, True)]


def edge_pairs(B: int, L1: int, L2: int, seed: int, garbage: bool = False):
    """(seq1, rlen1, seq2, rlen2) at exactly the widths given (no padding)
    for the overlap scan's edge cases: lowercase and non-ACGTN bytes in both
    reads, ~10% of lengths in 0-3, and in half of the rows a planted overlap
    whose offset runs over every residue mod 4 in both phases (so the
    compared windows start on and across 32-bit word boundaries).  Read2's
    planted bases are any byte whose complement is read1's base, so a
    lowercase base of read2 can match while one of read1 cannot.  Bytes past
    each length are 0, as the pack reader leaves them, or with ``garbage``
    random bytes, which no output may depend on."""
    rng = np.random.default_rng(seed)
    seq1 = rng.choice(_EDGE_BYTES, size=(B, L1), p=_EDGE_P)
    seq2 = rng.choice(_EDGE_BYTES, size=(B, L2), p=_EDGE_P)
    rlen1 = rng.integers(0, L1 + 1, B).astype(np.int32)
    rlen2 = rng.integers(0, L2 + 1, B).astype(np.int32)
    full = rng.random(B) < 0.4
    rlen1[full] = L1
    rlen2[full] = L2
    tiny = rng.random(B) < 0.1
    rlen1[tiny] = rng.integers(0, 4, tiny.sum())
    tiny = rng.random(B) < 0.1
    rlen2[tiny] = rng.integers(0, 4, tiny.sum())
    for b in range(0, B, 2):
        n1, n2 = int(rlen1[b]), int(rlen2[b])
        # offset o >= 0: read1[o + i] pairs with rc(read2)[i]; o < 0 the other way
        o = int(rng.integers(-n2 + 1, n1)) if n1 and n2 else 0
        a, c = max(o, 0), max(-o, 0)
        ol = min(n1 - a, n2 - c)
        for i in range(max(ol, 0)):
            want = seq1[b, a + i]
            pre = _PRE_IMAGES.get(int(want))
            if pre is not None and rng.random() > 0.02:
                seq2[b, n2 - 1 - c - i] = _EDGE_BYTES[rng.choice(pre)]
    for seq, rlen in ((seq1, rlen1), (seq2, rlen2)):
        past = np.arange(seq.shape[1])[None, :] >= rlen[:, None]
        seq[past] = rng.integers(0, 256, int(past.sum())) if garbage else 0
    return seq1, rlen1, seq2, rlen2


def _options(argv, cli=None):
    """Options for ``argv``, derived as ``config.cli.parse_args`` derives
    them (no input files needed).  ``cli`` is the ``config.cli`` module to
    parse with: the port's by default, ``fqtool_tpu.config.cli`` for the
    KernelParams that the JAX package's functions take."""
    if cli is None:
        from fqtool_tpu_torch.config import cli
    opt = cli.namespace_to_options(cli.build_parser().parse_args(argv))
    opt.update(argv)
    return opt


def kernel_params(*flags: str, cli=None):
    """(p, p2) KernelParams of a paired-end argv with ``flags``."""
    opt = _options(["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq",
                    *flags], cli)
    return opt.kernel_params(is_r2=False), opt.kernel_params(is_r2=True)


def kernel_params_se(*flags: str, cli=None):
    """KernelParams of a single-end argv with ``flags``."""
    return _options(["-i", "r1.fq", "-o", "o1.fq", *flags], cli).kernel_params()


def random_batch(rng, B: int = 256, L: int = 152):
    """(seq, qual, rlen) with the edge cases of a real pack: lengths from 0 to
    L, zero padding past the length, N runs, low-complexity rows and
    qualities at '!' and at 'J' and above."""
    seq = _ACGT[rng.integers(0, 4, (B, L), dtype=np.uint8)]
    seq[rng.random((B, L)) < 0.02] = ord("N")
    for r in rng.choice(B, B // 16, replace=False):
        s = rng.integers(0, L)
        seq[r, s : s + rng.integers(1, 30)] = ord("N")
    for r in rng.choice(B, B // 16, replace=False):
        seq[r, :] = _ACGT[rng.integers(0, 4)]  # homopolymer
    qual = rng.integers(33, 76, (B, L)).astype(np.uint8)
    qual[rng.random((B, L)) < 0.05] = ord("!")
    lo = rng.choice(B, B // 8, replace=False)
    qual[lo, :] = rng.integers(33, 45, (len(lo), L))
    hi = rng.choice(B, B // 8, replace=False)
    qual[hi, :] = rng.integers(74, 80, (len(hi), L))
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    rlen[: B // 16] = 0
    rlen[B // 16 : B // 8] = L
    rlen[B // 8 : B // 8 + 8] = np.arange(1, 9)
    pad = np.arange(L)[None, :] >= rlen[:, None]
    seq[pad] = 0
    qual[pad] = 0
    return seq, qual, rlen


def fastq_bytes(seq: np.ndarray, qual: np.ndarray, mate: int,
                first: int) -> bytes:
    """FASTQ records ``@SIM:<first + i> <mate>:N:0:ACGTAC`` of the rows."""
    n, L = seq.shape
    names = np.array([b"@SIM:%09d %d:N:0:ACGTAC" % (first + i, mate)
                      for i in range(n)])
    w = names.dtype.itemsize
    rec = np.empty((n, w + 1 + L + 3 + L + 1), np.uint8)
    rec[:, :w] = names.view(np.uint8).reshape(n, w)
    rec[:, w] = ord("\n")
    rec[:, w + 1 : w + 1 + L] = seq
    rec[:, w + 1 + L : w + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + 4 + L : w + 4 + 2 * L] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_pairs(path1, path2, n: int, seed: int, read_len: int = 151,
                block: int = 250_000, adapters: bool = False) -> np.ndarray:
    """Write ``n`` pairs as plain FASTQ to ``path1``/``path2`` in blocks of
    ``block`` pairs (block k is seeded with ``seed + k``, so a prefix of the
    stream is the same for any ``n``); returns the insert sizes.
    ``adapters`` as for ``make_pairs``."""
    sizes = []
    with open(path1, "wb") as f1, open(path2, "wb") as f2:
        for k, lo in enumerate(range(0, n, block)):
            m = min(block, n - lo)
            s1, q1, s2, q2, isz = make_pairs(m, seed + k, read_len, adapters)
            f1.write(fastq_bytes(s1, q1, 1, lo))
            f2.write(fastq_bytes(s2, q2, 2, lo))
            sizes.append(isz)
    return np.concatenate(sizes) if sizes else np.zeros(0, np.int32)


def write_interleaved(path, n: int, seed: int, adapters: bool = False) -> None:
    """Write the pairs of ``write_pairs(..., n, seed, adapters=adapters)`` to
    one FASTQ file, read1 then read2 of each pair (``--in_fq_interleaved``)."""
    s1, q1, s2, q2, _ = make_pairs(n, seed, 151, adapters)
    r1 = fastq_bytes(s1, q1, 1, 0)
    r2 = fastq_bytes(s2, q2, 2, 0)
    w = len(r1) // max(n, 1)
    with open(path, "wb") as f:
        for i in range(n):
            f.write(r1[i * w : (i + 1) * w])
            f.write(r2[i * w : (i + 1) * w])
