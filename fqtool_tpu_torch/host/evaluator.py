# Copy of fqtool_tpu/host/evaluator.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Pre-processing evaluation passes.

Host-side port of the Evaluator (reference: src/evaluator.cpp): read-length
estimation, read-number estimation, overrepresented-sequence seeding, and
adapter auto-detection (10-mer seed histogram + nucleotide-tree extension +
known-adapter prefix matching).

These passes scan bounded prefixes of the input once each and run at startup;
they stay on host (numpy) by design.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..config.options import Options
from ..io.fastq import iter_records
from .known_adapters import KNOWN_ADAPTERS
from .nucleotidetree import dominant_path_mat

_BASE_VAL = {65: 0, 84: 1, 67: 2, 71: 3}  # A T C G


def seq2int(seq: str, pos: int, keylen: int) -> int:
    """2-bit packing; -1 when any base is not A/T/C/G
    (reference: src/evaluator.cpp:3-49)."""
    key = 0
    for i in range(pos, pos + keylen):
        v = _BASE_VAL.get(ord(seq[i])) if i < len(seq) else None
        if v is None:
            return -1
        key = (key << 2) + v
    return key


def int2seq(val: int, seq_len: int) -> str:
    """reference: src/evaluator.cpp:51-61"""
    bases = "ATCG"
    out = ["N"] * seq_len
    for index in range(seq_len):
        out[seq_len - index - 1] = bases[val & 0x03]
        val >>= 2
    return "".join(out)


def evaluate_read_len(opt: Options) -> None:
    """reference: src/evaluator.cpp:84-109"""
    if opt.in1:
        opt.est.seq_len1 = compute_read_len(opt.in1)
    if opt.in2:
        opt.est.seq_len2 = compute_read_len(opt.in2)


def compute_read_len(filename: str) -> int:
    from ..io import headcache

    cache = headcache.get(filename)
    if cache is not None:
        return cache.read_len(1000)
    seq_len = 0
    for i, (_, seq, _, _) in enumerate(iter_records(filename)):
        if i >= 1000:
            break
        seq_len = max(seq_len, len(seq))
    return seq_len


def evaluate_read_num(opt: Options) -> None:
    """Estimate the total read count from bytes/read over a bounded prefix
    (reference: src/evaluator.cpp:191-227).

    The reference measures *compressed* offsets via gzoffset for .gz inputs;
    we track consumed bytes of the underlying raw stream, which matches to
    within the readahead granularity.  The estimate feeds only ``--split``
    sizing and carries the reference's own x1.01 fudge.
    """
    import gzip

    READ_LIMIT = 512 * 1024
    BASE_LIMIT = 151 * 512 * 1024
    path = opt.in1
    bytes_total = os.path.getsize(path)

    raw = open(path, "rb")
    counted = _CountingReader(raw)
    fh = gzip.GzipFile(fileobj=counted) if path.endswith(".gz") else counted

    records = 0
    bases = 0
    first_read_pos = 0
    reached_eof = False
    try:
        it = _iter_records_fh(fh)
        while records < READ_LIMIT and bases < BASE_LIMIT:
            rec = next(it, None)
            if rec is None:
                reached_eof = True
                break
            if records == 0:
                first_read_pos = counted.consumed
            records += 1
            bases += len(rec[1])
    finally:
        raw.close()

    opt.est.reads_num = 0
    if reached_eof:
        opt.est.reads_num = records
    elif records > 1:
        bytes_read = counted.consumed
        bytes_per_read = (bytes_read - first_read_pos) / (records - 1)
        opt.est.reads_num = int(bytes_total * 1.01 / bytes_per_read)


class _CountingReader:
    def __init__(self, fh):
        self._fh = fh
        self.consumed = 0

    def read(self, n=-1):
        data = self._fh.read(n)
        self.consumed += len(data)
        return data

    def readline(self, n=-1):
        data = self._fh.readline(n)
        self.consumed += len(data)
        return data

    def readable(self):
        return True

    def seekable(self):
        return False


def _iter_records_fh(fh):
    while True:
        name = None
        while True:
            line = fh.readline()
            if not line:
                return
            line = line.rstrip(b"\r\n")
            if line.startswith(b"@"):
                name = line
                break
        seq = fh.readline().rstrip(b"\r\n")
        strand = fh.readline().rstrip(b"\r\n")
        qual = fh.readline().rstrip(b"\r\n")
        yield name, seq, strand, qual


# ----------------------------------------------------------------------
# Overrepresented sequence seeding (reference: evaluator.cpp:111-189)

def evaluate_over_rep_seqs(opt: Options) -> None:
    if opt.in1:
        opt.over_rep.over_rep_seq_count_r1 = compute_over_rep_seq(opt.in1)
    if opt.in2:
        opt.over_rep.over_rep_seq_count_r2 = compute_over_rep_seq(opt.in2)


def _ors_threshold(n: int) -> int:
    """Count threshold for a length-n substring (evaluator.cpp:151-161)."""
    if n >= 151 - 1:
        return 3
    if n >= 100:
        return 5
    if n >= 40:
        return 20
    if n >= 20:
        return 100
    if n >= 10:
        return 500
    return 1 << 30


def _inv_u64(p: int) -> int:
    """Multiplicative inverse of an odd p modulo 2^64 (Newton iteration)."""
    x = p
    for _ in range(6):
        x = (x * (2 - p * x)) % (1 << 64)
    return x


_ORS_PRIMES = (1099511628211, 6364136223846793005)  # FNV prime, PCG multiplier


def _hash_ctx(flat: np.ndarray, primes=_ORS_PRIMES):
    """Per-prime (weighted cumsum, inverse powers): one pass over the corpus,
    after which window hashes of ANY length are O(windows)."""
    n = len(flat)
    if n == 0:
        return [(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
                for _ in primes]
    ctx = []
    with np.errstate(over="ignore"):
        f = flat.astype(np.uint64)
        for p in primes:
            pows = np.empty(n, np.uint64)
            pows[0] = 1
            np.multiply.accumulate(np.full(n - 1, np.uint64(p)), out=pows[1:])
            ipows = np.empty(n, np.uint64)
            ipows[0] = 1
            np.multiply.accumulate(
                np.full(n - 1, np.uint64(_inv_u64(p))), out=ipows[1:])
            ctx.append((np.cumsum(f * pows[::-1]), ipows))
    return ctx


def _window_hashes(ctx, n: int, step: int, k: int = 0) -> np.ndarray:
    """Polynomial hashes mod 2^64 of every length-``step`` window
    (position independent) from a precomputed :func:`_hash_ctx`."""
    m = n - step + 1
    csum, ipows = ctx[k]
    with np.errstate(over="ignore"):
        diff = csum[step - 1 :].copy()
        diff[1:] -= csum[: m - 1]
        return diff * ipows[n - step :: -1]


def compute_over_rep_seq(filename: str) -> Dict[str, int]:
    """reference: src/evaluator.cpp:120-189.

    The reference counts every substring of 5 step lengths into a std::map
    (~7.5M map ops over the 1.5 Mb prefix).  Here window counting is
    vectorized: 128-bit rolling hashes of all windows per step length,
    np.unique for the counts, and exact substring extraction only for the
    few hash groups above threshold.
    """
    from ..io import headcache

    BASE_LIMIT = 151 * 10000
    steps = sorted({10, 20, 40, 100, min(150, 151 - 2)})
    cache = headcache.get(filename)
    if cache is not None:
        flat, lens = cache.seq_prefix(BASE_LIMIT)
    else:
        bases = 0
        seqs: List[bytes] = []
        for name, seq, strand, qual in iter_records(filename):
            if bases >= BASE_LIMIT:
                break
            seqs.append(seq)
            bases += len(seq)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        lens = np.fromiter((len(s) for s in seqs), count=len(seqs),
                           dtype=np.int64)
    if len(lens) == 0:
        return {}

    n = len(flat)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])

    # native scan: rolling hashes + sort in C (fastq_core.cpp fq_ors_scan),
    # ~0.5s for the 1.5 Mb prefix vs ~15s for the numpy path on 1 vCPU
    from ..io import native
    if native.get_lib() is not None:
        hot = {}
        for step in steps:
            got = native.ors_scan(flat, starts, lens, step, _ors_threshold(step))
            for p, c in zip(*got):
                s = flat[int(p) : int(p) + step].tobytes().decode("latin-1")
                hot[s] = int(c)
        return _filter_substrings(hot)

    read_of_pos = np.repeat(np.arange(len(lens)), lens)
    ctx = _hash_ctx(flat)
    hot: Dict[str, int] = {}
    for step in steps:
        if n < step + 1:
            continue
        m = n - step + 1
        # window start i is countable iff i stays within its read:
        # local index < rlen - step (evaluator.cpp: i < rlen - step)
        rid = read_of_pos[:m]
        valid = (np.arange(m) - starts[rid]) < (lens[rid] - step)
        if not valid.any():
            continue
        h = np.empty((m, 2), np.uint64)
        h[:, 0] = _window_hashes(ctx, n, step, 0)
        h[:, 1] = _window_hashes(ctx, n, step, 1)
        hv = np.ascontiguousarray(h[valid]).view("V16").reshape(-1)
        vpos = np.flatnonzero(valid)
        uniq, first_idx, counts = np.unique(
            hv, return_index=True, return_counts=True)
        thr = _ors_threshold(step)
        for u in np.flatnonzero(counts >= thr):
            p = int(vpos[first_idx[u]])
            s = flat[p : p + step].tobytes().decode("latin-1")
            hot[s] = int(counts[u])

    return _filter_substrings(hot)


def _filter_substrings(hot: Dict[str, int]) -> Dict[str, int]:
    """Drop substrings of kept superstrings with similar counts
    (evaluator.cpp:166-188).  The reference scans all pairs (quadratic in the
    hot-set size -- minutes on repeat-heavy inputs); same outcome here via a
    hashed containment index (candidates verified exactly), with the removal
    pass walking the same lexicographic order the std::map iteration uses and
    honoring prior erasures."""
    if not hot:
        return hot
    from ..io import native

    items = sorted(hot.items())
    n_items = len(items)
    strs = [s for s, _ in items]
    slen = np.fromiter((len(s) for s in strs), count=n_items, dtype=np.int64)
    flat = np.frombuffer("".join(strs).encode("latin-1"), np.uint8)
    n = len(flat)
    starts = np.zeros(n_items, np.int64)
    np.cumsum(slen[:-1], out=starts[1:])
    use_native = native.get_lib() is not None
    if not use_native:
        item_of_pos = np.repeat(np.arange(n_items), slen)
        ctx = _hash_ctx(flat, _ORS_PRIMES[:1])

    cand: Dict[int, np.ndarray] = {}
    cand_si: List[np.ndarray] = []
    cand_it: List[np.ndarray] = []
    for step in sorted({len(s) for s in strs}):
        short_idx = np.flatnonzero(slen == step)
        if len(short_idx) == 0:
            continue
        if use_native:
            # containment candidates in C: every step-window of the longer
            # items probed against the sorted short-string hash set
            sh = np.fromiter(
                (native.hash64(s.encode("latin-1")) for s in
                 (strs[int(i)] for i in short_idx)),
                count=len(short_idx), dtype=np.uint64)
            sh_order = np.argsort(sh, kind="stable")
            ranks, items_arr = native.contain_pairs(
                flat, starts, slen, step, sh[sh_order])
            cand_si.append(short_idx[sh_order[ranks]])
            cand_it.append(items_arr)
            continue
        else:
            m = n - step + 1
            if m <= 0:
                break
            h = _window_hashes(ctx, n, step, 0)
            # windows fully inside a STRICTLY longer hot string
            rid = item_of_pos[:m]
            local = np.arange(m) - starts[rid]
            valid = (local <= slen[rid] - step) & (slen[rid] > step)
            if not valid.any():
                continue
            wh = h[valid]
            witem = rid[valid]
            order = np.argsort(wh, kind="stable")
            wh = wh[order]
            witem = witem[order]
            sh = h[starts[short_idx]]  # hash of each short string itself
        lo = np.searchsorted(wh, sh, side="left")
        hi = np.searchsorted(wh, sh, side="right")
        for k, si in enumerate(short_idx):
            if hi[k] > lo[k]:
                cand[int(si)] = witem[lo[k] : hi[k]]

    counts_arr = np.fromiter((c for _, c in items), count=n_items,
                             dtype=np.int64)
    if cand_si:
        # group the flat candidate arrays by short index; the ratio test is
        # vectorized per short so Python only touches passing candidates
        si_all = np.concatenate(cand_si)
        it_all = np.concatenate(cand_it)
        order = np.argsort(si_all, kind="stable")
        si_all = si_all[order]
        it_all = it_all[order]
        bounds = np.searchsorted(si_all, np.arange(n_items + 1))

    removed_flags = np.zeros(n_items, bool)
    removed = []
    for i, (s, count) in enumerate(items):
        if cand_si:
            cs = it_all[bounds[i] : bounds[i + 1]]
            if len(cs) == 0:
                continue
            ok = ~removed_flags[cs] & (count // counts_arr[cs] < 10)
            cs = cs[ok]
        else:
            cs = cand.get(i, ())
        for idx in cs:
            s2, count2 = items[int(idx)]
            # hash candidates are verified exactly (s in s2) before acting
            if not removed_flags[idx] and count // count2 < 10 and s in s2:
                removed_flags[i] = True
                removed.append(s)
                break
    for s in removed:
        del hot[s]
    return hot


# ----------------------------------------------------------------------
# Adapter auto-detection (reference: evaluator.cpp:229-446)

def evaluate_adapter_seq(opt: Options, is_r2: bool) -> None:
    filename = opt.in2 if is_r2 else opt.in1
    detected = detect_adapter(filename, opt.trim.tail1)
    if is_r2:
        opt.adapter.detected_adapter_seq_r2 = detected
        if detected and detected in KNOWN_ADAPTERS:
            opt.est.illumina_adapter = True
    else:
        opt.adapter.detected_adapter_seq_r1 = detected
        if detected and detected in KNOWN_ADAPTERS:
            opt.est.illumina_adapter = True


def detect_adapter(filename: str, trim_tail1: int) -> str:
    """reference: src/evaluator.cpp:229-390"""
    READ_LIMIT = 256 * 1024
    BASE_LIMIT = 151 * READ_LIMIT
    keylen = 10
    size = 1 << (keylen * 2)

    mat, lens = _load_record_matrix(filename, READ_LIMIT, BASE_LIMIT)

    if mat.shape[0] < 10000:
        return ""

    shift_tail = max(1, trim_tail1)
    counts = _count_seed_kmers(mat, lens, keylen, shift_tail)

    counts[0] = 0  # zero the poly-A key (evaluator.cpp:284)
    topkeys, total = _top_keys(counts, keylen)

    FOLD_THRESHOLD = 20
    for key in topkeys:
        if key == 0:
            continue
        seq = int2seq(key, keylen)
        count = int(counts[key])
        if count < 10 or count * size < total * FOLD_THRESHOLD:
            break  # evaluator.cpp:348 (break, not continue)
        # low-complexity re-check (evaluator.cpp:350-359)
        diff = sum(1 for i in range(len(seq) - 1) if seq[i] != seq[i + 1])
        if diff < 3:
            continue
        est = _get_adapter_with_seed(key, mat, lens, keylen, trim_tail1)
        if est:
            return est
    return ""


def _load_record_matrix(filename: str, read_limit: int,
                        base_limit: int) -> Tuple[np.ndarray, np.ndarray]:
    """Load up to read_limit/base_limit sequences as one zero-padded
    [N, W] uint8 matrix + lens -- the whole detection pipeline stays in
    matrix space (per-record Python strings were the startup bottleneck
    for large detection scans)."""
    from ..io import headcache
    from ..io.fastq import PackReader

    cache = headcache.get(filename)
    if cache is not None:
        return cache.matrix(read_limit, base_limit)

    reader = PackReader(filename, pack_reads=min(read_limit, 65536))
    mats: List[np.ndarray] = []
    lens_parts: List[np.ndarray] = []
    rows = 0
    bases = 0
    try:
        while rows < read_limit and bases < base_limit:
            pack = reader.next_pack()
            if pack is None:
                break
            lens = np.asarray(pack.lens)
            # a record is taken iff rows-so-far < read_limit and
            # bases-so-far < base_limit (checked before adding each record)
            cum = np.cumsum(lens) - lens  # exclusive prefix sums
            take = min(int(np.sum((bases + cum) < base_limit)),
                       read_limit - rows, pack.count)
            mats.append(pack.seq[:take])
            lens_parts.append(lens[:take].astype(np.int32))
            rows += take
            bases += int(lens[:take].sum())
    finally:
        reader.close()
    if not mats:
        return np.zeros((0, 0), np.uint8), np.zeros(0, np.int32)
    # width from the TAKEN rows rounded to the pack width multiple -- the
    # same rule as the head-cache path, so both produce identical arrays
    all_lens = np.concatenate(lens_parts)
    width = -(-int(all_lens.max(initial=1)) // 8) * 8
    mats = [m[:, :width] if m.shape[1] >= width
            else np.pad(m, ((0, 0), (0, width - m.shape[1])))
            for m in mats]
    return np.concatenate(mats), all_lens


def _count_seed_kmers(mat: np.ndarray, lens: np.ndarray, keylen: int,
                      shift_tail: int) -> np.ndarray:
    """10-mer histogram over positions >= 20 (evaluator.cpp:273-282):
    per-length blocks through the native rolling-window scan
    (fastq_core.cpp fq_seed_hist, ~0.2s for a 256Ki-read scan), with an
    int32 numpy fallback."""
    from ..io import native

    size = 1 << (keylen * 2)
    counts = np.zeros(size, np.int64)
    lut = np.full(256, -1, np.int8)
    for b, v in _BASE_VAL.items():
        lut[b] = v
    for rlen in np.unique(lens):
        # positions pos in [20, rlen - keylen - shift_tail]
        rlen = int(rlen)
        last = rlen - keylen - shift_tail
        if last < 20:
            continue
        arr = np.ascontiguousarray(mat[lens == rlen, :rlen])
        if native.seed_hist(arr, keylen, shift_tail, counts):
            continue
        codes = lut[arr].astype(np.int32)
        npos = last - 20 + 1
        keys = np.zeros((arr.shape[0], npos), np.int32)
        ok = np.ones((arr.shape[0], npos), bool)
        for j in range(keylen):
            c = codes[:, 20 + j : 20 + j + npos]
            keys = keys * 4 + np.maximum(c, 0)
            ok &= c >= 0
        # bincount, not np.add.at: the unbuffered ufunc costs ~1us/element
        counts += np.bincount(keys[ok].reshape(-1), minlength=size)
    return counts


_eligible_cache: Dict[int, np.ndarray] = {}


def _eligible_keys(keylen: int) -> np.ndarray:
    """Seed eligibility (evaluator.cpp:287-337 exclusions: low-complexity,
    high-GC, GGGG prefix); pure function of keylen, cached (4^10 bools)."""
    cached = _eligible_cache.get(keylen)
    if cached is not None:
        return cached
    size = 1 << (keylen * 2)
    ks = np.arange(size, dtype=np.int64)
    atcg = np.zeros((4, size), np.int16)
    for i in range(keylen):
        b = (ks >> (i * 2)) & 0x3
        for v in range(4):
            atcg[v] += b == v
    low_complexity = (atcg >= keylen - 4).any(axis=0)
    high_gc = (atcg[2] + atcg[3]) >= keylen - 2
    gggg_prefix = (ks >> 12) == 0xFF
    eligible = ~(low_complexity | high_gc | gggg_prefix)
    _eligible_cache[keylen] = eligible
    return eligible


def _top_keys(counts: np.ndarray, keylen: int) -> Tuple[List[int], int]:
    """Top-10 seed selection with the reference's complexity/GC/GGGG-prefix
    exclusions and its quirky insertion order (evaluator.cpp:287-337)."""
    from ..io import native

    eligible = _eligible_keys(keylen)
    total = int(counts[eligible].sum())

    # Reproduce the reference's exact insertion loop over ascending k.  It has
    # a quirk: a value that beats the current top (t == 0 branch) shifts and
    # inserts at 0, but a value beating position t>0 inserts at t+1.
    topnum = 10

    # only keys with nonzero count (plus the implicit zeros) can matter
    candidates = np.nonzero(eligible & (counts > 0))[0].astype(np.int64)
    nat = native.top_keys(counts, candidates, topnum)
    if nat is not None:
        return nat.tolist(), total

    topkeys = [0] * topnum
    for k in candidates.tolist():
        val = counts[k]
        for t in range(topnum - 1, -1, -1):
            if val < counts[topkeys[t]]:
                if t < topnum - 1:
                    for m in range(topnum - 1, t + 1, -1):
                        topkeys[m] = topkeys[m - 1]
                    topkeys[t + 1] = k
                break
            elif t == 0:
                for m in range(topnum - 1, t, -1):
                    topkeys[m] = topkeys[m - 1]
                topkeys[t] = k
    return topkeys, total


def _get_adapter_with_seed(seed: int, mat: np.ndarray, lens: np.ndarray,
                           keylen: int, trim: int) -> str:
    """reference: src/evaluator.cpp:392-426"""
    from ..io import native

    shift_tail = max(1, trim)
    seed_seq = int2seq(seed, keylen)
    seed_bytes = seed_seq.encode()
    hits = native.find_seed(mat, lens, seed_bytes, 20, shift_tail)
    if hits is None:
        # numpy fallback: all windows == seed, positions in [20, last]
        W = mat.shape[1]
        if W < keylen:
            rows = np.zeros(0, np.int64)
            poss = np.zeros(0, np.int32)
        else:
            win = np.lib.stride_tricks.sliding_window_view(mat, keylen, axis=1)
            eq = (win == np.frombuffer(seed_bytes, np.uint8)).all(axis=2)
            p = np.arange(eq.shape[1])[None, :]
            last = (lens - keylen - shift_tail)[:, None]
            rows, poss = np.nonzero(eq & (p >= 20) & (p <= last))
            poss = poss.astype(np.int32)
    else:
        rows, poss = hits

    # forward tree: r[pos+keylen : len-shift_tail]; backward: r[:pos][::-1]
    hlens = lens[rows]
    flens = np.maximum(hlens - shift_tail - poss - keylen, 0).astype(np.int32)
    fw = int(flens.max(initial=0))
    pos_ax = np.arange(max(fw, 1), dtype=np.int32)[None, :]
    src = np.clip((poss + keylen)[:, None] + pos_ax, 0, max(mat.shape[1] - 1, 0))
    fwd_mat = mat[rows[:, None], src] if len(rows) else np.zeros((0, 1), np.uint8)
    blens = poss.astype(np.int32)
    bw = int(blens.max(initial=0))
    bpos_ax = np.arange(max(bw, 1), dtype=np.int32)[None, :]
    bsrc = np.clip(poss[:, None] - 1 - bpos_ax, 0, max(mat.shape[1] - 1, 0))
    bwd_mat = mat[rows[:, None], bsrc] if len(rows) else np.zeros((0, 1), np.uint8)

    forward_path, f_leaf = dominant_path_mat(fwd_mat, flens)
    backward_path, b_leaf = dominant_path_mat(bwd_mat, blens)
    reached_leaf = f_leaf and b_leaf
    adapter = backward_path[::-1] + seed_seq + forward_path
    if len(adapter) > 60:
        adapter = adapter[:60]
    matched = match_known_adapter(adapter)
    if matched:
        return matched
    return adapter if reached_leaf else ""


def match_known_adapter(seq: str) -> str:
    """Exact-prefix match against the known adapter DB
    (reference: src/evaluator.cpp:428-446)."""
    for adapter in KNOWN_ADAPTERS:
        if len(seq) < len(adapter):
            continue
        if seq.startswith(adapter):
            return adapter
    return ""
