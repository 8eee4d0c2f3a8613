# Copy of fqtool_tpu/host/nucleotidetree.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Nucleotide trie for adapter-sequence extension.

Behavioral spec from ``NucleotideTree`` (reference: src/nucleotidetree.cpp):
an 8-ary trie keyed by ``base & 0x07`` whose dominant path (>= 95% of >= 50
counts per level) extends a detected adapter seed.

The production path is :func:`dominant_path`, a vectorized equivalent: the
trie is only ever walked along its single dominant branch, so per-level child
counts can be computed as masked column counts over a byte matrix of the
inserted sequences -- O(depth) numpy passes instead of per-character Python
trie insertion (the insertion loop dominated adapter-detection startup).
The :class:`NucleotideTree` trie is kept as the executable spec; the two are
cross-checked in tests/test_names_vectorized.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

RATIO_THRESHOLD = 0.95  # nucleotidetree.cpp:59
NUM_THRESHOLD = 50      # nucleotidetree.cpp:60


class _Node:
    __slots__ = ("count", "base", "children")

    def __init__(self, base: str = "N"):
        self.count = 0
        self.base = base
        self.children: Dict[int, _Node] = {}


class NucleotideTree:
    def __init__(self):
        self.root = _Node()

    def add_seq(self, seq: str) -> None:
        """reference: src/nucleotidetree.cpp:41-55 -- stops at the first N."""
        cur = self.root
        for ch in seq:
            if ch == "N":
                break
            b = ord(ch) & 0x07
            nxt = cur.children.get(b)
            if nxt is None:
                nxt = _Node(ch)
                cur.children[b] = nxt
            nxt.count += 1
            cur = nxt

    def get_dominant_path(self) -> Tuple[str, bool]:
        """Returns (path, reached_leaf); reached_leaf is False when a level
        with enough coverage has no dominant child
        (reference: src/nucleotidetree.cpp:57-90)."""
        out = []
        reached_leaf = True
        cur = self.root
        while True:
            total = sum(c.count for c in cur.children.values())
            if total < NUM_THRESHOLD:
                break
            dominant = None
            # iterate in child-index order (0..7) like the reference array scan
            for b in sorted(cur.children):
                child = cur.children[b]
                if child.count / total >= RATIO_THRESHOLD:
                    dominant = child
                    break
            if dominant is None:
                reached_leaf = False
                break
            out.append(dominant.base)
            cur = dominant
        return "".join(out), reached_leaf


def dominant_path(seqs: List[str]) -> Tuple[str, bool]:
    """Vectorized ``add_seq``-all + ``get_dominant_path`` over strings.

    Equivalent to inserting every sequence into a fresh trie and walking the
    dominant branch: a sequence contributes a child at depth d iff its first
    'N' (insertion stop, nucleotidetree.cpp:45-46) and its length both lie
    beyond d and its bucketed prefix (``base & 0x07``) matches the path
    chosen so far.
    """
    n = len(seqs)
    if n == 0:
        return "", True
    width = max(len(s) for s in seqs)
    if width == 0:
        return "", True
    mat = np.zeros((n, width), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        if s:
            mat[i, : len(s)] = np.frombuffer(s.encode("latin-1"), np.uint8)
            lens[i] = len(s)
    return dominant_path_mat(mat, lens)


def dominant_path_mat(mat: np.ndarray, lens: np.ndarray) -> Tuple[str, bool]:
    """Matrix form of :func:`dominant_path`: rows are uint8 sequences of
    explicit length ``lens[r]`` (bytes past that are ignored).

    Replicates the trie exactly: children are bucketed by ``byte & 0x07``
    (so e.g. 'W' and 'G' share a bucket and their counts merge,
    nucleotidetree.cpp:44), buckets are scanned in 0..7 order, rows in
    insertion (row) order, and the path character at each level is the byte
    of the FIRST row that created the node -- the trie stores the creating
    insertion's character (nucleotidetree.cpp:49-51), not the bucket.
    """
    n, width = mat.shape
    if n == 0 or width == 0:
        return "", True
    # effective insertion depth: first 'N' (insertion stop) or end of row
    isn = mat == ord("N")
    firstn = np.where(isn.any(axis=1), isn.argmax(axis=1), width)
    eff = np.minimum(firstn, lens.astype(np.int64))

    buckets = mat & 7
    active = np.ones(n, bool)
    out: List[str] = []
    for d in range(width):
        contrib = active & (eff > d)
        total = int(contrib.sum())
        if total < NUM_THRESHOLD:
            return "".join(out), True
        col = buckets[:, d]
        for b in range(8):
            in_bucket = (col == b) & contrib
            cnt = int(in_bucket.sum())
            if cnt and cnt / total >= RATIO_THRESHOLD:
                creator = int(np.argmax(in_bucket))  # first row in order
                out.append(chr(mat[creator, d]))
                active = in_bucket
                break
        else:
            return "".join(out), False
    # depth exhausted: every child level beyond here is empty (total 0 < 50)
    return "".join(out), True
