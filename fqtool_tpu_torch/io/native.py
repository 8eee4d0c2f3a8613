# Copy of fqtool_tpu/io/native.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""ctypes binding for the native FASTQ core.

Builds ``libfastq_core.so`` from the bundled C++ source on first use (g++ is
part of the supported toolchain) and caches it next to the package.  Every
entry point has a pure-Python fallback, so the framework degrades gracefully
on systems without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "fastq_core.cpp")
_LIB_DIR = os.environ.get("FQTOOL_TPU_NATIVE_DIR",
                          os.path.join(_HERE, "..", "native"))
_LIB = os.path.join(_LIB_DIR, "libfastq_core.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> bool:
    try:
        cmd = ["g++", "-std=c++17", "-O3", "-shared", "-fPIC",
               "-o", _LIB, _SRC, "-lz"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # pragma: no cover - toolchain issues
        sys.stderr.write(f"fastq_core native build failed ({e}); "
                         "falling back to pure Python\n")
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("FQTOOL_TPU_NO_NATIVE"):
            return None
        if not os.path.exists(_LIB) or \
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.fq_parse.restype = ctypes.c_int64
        lib.fq_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _i64p, _i32p, _i64p, _i32p, _i64p, _i32p, _i64p, _i32p,
            _i64p, _i32p]
        lib.fq_pack.restype = None
        lib.fq_pack.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _i64p, _i32p, _i64p,
            _u8p, _u8p, ctypes.c_int64, ctypes.c_int32]
        lib.fq_format.restype = ctypes.c_int64
        lib.fq_format.argtypes = [
            ctypes.c_int64, _u8p,
            ctypes.c_char_p, _i64p, _i32p,
            ctypes.c_char_p, _i64p, _i32p,
            _u8p, _u8p, ctypes.c_int64,
            _i32p, _i32p,
            ctypes.c_char_p, _i64p, _i32p,
            ctypes.c_char_p]
        lib.fq_format_planes.restype = ctypes.c_int64
        lib.fq_format_planes.argtypes = [
            ctypes.c_int64, _u8p,
            ctypes.c_char_p, _i64p, _i32p,
            ctypes.c_char_p, _i64p, _i32p,
            _u8p, _u8p, ctypes.c_int64,
            _u8p, _u8p, ctypes.c_int64,
            _u8p, _u8p, ctypes.c_int64,
            _u8p, _i32p,
            _i32p, _i32p,
            ctypes.c_char_p, _i64p, _i32p,
            ctypes.c_char_p]
        lib.gz_inflate_new.restype = ctypes.c_void_p
        lib.gz_inflate_new.argtypes = []
        lib.gz_inflate.restype = ctypes.c_int64
        lib.gz_inflate.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64, _u8p, ctypes.c_int64,
                                   _i64p, _i32p]
        lib.gz_inflate_free.restype = None
        lib.gz_inflate_free.argtypes = [ctypes.c_void_p]
        lib.fq_seed_hist.restype = None
        lib.fq_seed_hist.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32, _i64p]
        lib.fq_ors_scan.restype = ctypes.c_int64
        lib.fq_ors_scan.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int64,
                                    _i64p, _i64p, ctypes.c_int64]
        lib.fq_top_keys.restype = None
        lib.fq_top_keys.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                    ctypes.c_int32, _i64p]
        lib.fq_find_seed.restype = ctypes.c_int64
        lib.fq_find_seed.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                     _i32p, _u8p, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32,
                                     _i64p, _i32p, ctypes.c_int64]
        _u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fq_contain_pairs.restype = ctypes.c_int64
        lib.fq_contain_pairs.argtypes = [_u8p, _i64p, _i64p,
                                         ctypes.c_int64, ctypes.c_int32,
                                         _u64p, ctypes.c_int64,
                                         _i64p, _i64p, ctypes.c_int64]
        lib.fq_hash64.restype = ctypes.c_uint64
        lib.fq_hash64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fq_assemble_merged.restype = None
        lib.fq_assemble_merged.argtypes = [
            _u8p, _u8p, ctypes.c_int64,
            _u8p, _u8p, ctypes.c_int64,
            ctypes.c_int64, _u8p,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, _u8p, ctypes.c_int64]
        lib.fq_encode.restype = ctypes.c_int32
        lib.fq_encode.argtypes = [_u8p, _u8p, ctypes.c_int64, _u8p, _u8p]
        lib.fq_pack5.restype = ctypes.c_int64
        lib.fq_pack5.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, _u8p, _u8p]
        lib.fq_copy_spans.restype = None
        lib.fq_copy_spans.argtypes = [_u8p, _i64p, _u8p, _i64p, _i64p,
                                      ctypes.c_int64]
        lib.fq_scan_new.restype = ctypes.c_void_p
        lib.fq_scan_new.argtypes = [ctypes.c_int32]
        lib.fq_scan_feed.restype = None
        lib.fq_scan_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64]
        lib.fq_scan_finish.restype = None
        lib.fq_scan_finish.argtypes = [ctypes.c_void_p, _i64p, _u8p]
        lib.fq_scan_free.restype = None
        lib.fq_scan_free.argtypes = [ctypes.c_void_p]
        lib.fq_skip_newlines.restype = ctypes.c_int64
        lib.fq_skip_newlines.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_int64, _i64p]
        lib.gz_inflate_member.restype = ctypes.c_int64
        lib.gz_inflate_member.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int64, _u8p, ctypes.c_int64,
                                          _i64p, _i32p]
        lib.gz_inflate_reset.restype = ctypes.c_int32
        lib.gz_inflate_reset.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def assemble_merged(m1s, m1q, m2s, m2q, sel, front1, front2, rlen2, ol,
                    len1, len2, wm: int):
    """Merged-read matrices [n, wm] for the selected rows, or None without
    the native library."""
    lib = get_lib()
    if lib is None:
        return None
    n = m1s.shape[0]
    ms = np.empty((n, wm), np.uint8)
    mq = np.empty((n, wm), np.uint8)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    lib.fq_assemble_merged(
        _ptr(np.ascontiguousarray(m1s), _u8p),
        _ptr(np.ascontiguousarray(m1q), _u8p), m1s.shape[1],
        _ptr(np.ascontiguousarray(m2s), _u8p),
        _ptr(np.ascontiguousarray(m2q), _u8p), m2s.shape[1],
        n, _ptr(np.ascontiguousarray(sel, np.uint8), _u8p),
        _ptr(i32(front1), _i32p), _ptr(i32(front2), _i32p),
        _ptr(i32(rlen2), _i32p), _ptr(i32(ol), _i32p),
        _ptr(i32(len1), _i32p), _ptr(i32(len2), _i32p),
        _ptr(ms, _u8p), _ptr(mq, _u8p), wm)
    return ms, mq


def contain_pairs(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  step: int, short_hash_sorted: np.ndarray):
    """(short_rank, containing_item) candidate pairs for step-windows inside
    strictly longer items, or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    sh = np.ascontiguousarray(short_hash_sorted, np.uint64)
    cap = max(int(np.where(lens > step, lens - step + 1, 0).sum()), 16)
    out_s = np.empty(cap, np.int64)
    out_i = np.empty(cap, np.int64)
    n = lib.fq_contain_pairs(
        _ptr(flat, _u8p), _ptr(starts, _i64p), _ptr(lens, _i64p),
        len(lens), step,
        sh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(sh),
        _ptr(out_s, _i64p), _ptr(out_i, _i64p), cap)
    return out_s[:n], out_i[:n]


def hash64(data: bytes) -> int:
    lib = get_lib()
    return int(lib.fq_hash64(data, len(data)))


def ors_scan(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
             step: int, threshold: int):
    """Above-threshold window groups as (first_pos, count) arrays, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    windows = int(np.maximum(lens - step, 0).sum())
    max_out = max(windows // max(threshold, 1) + 1, 16)
    out_pos = np.empty(max_out, np.int64)
    out_count = np.empty(max_out, np.int64)
    n = lib.fq_ors_scan(_ptr(flat, _u8p), _ptr(starts, _i64p),
                        _ptr(lens, _i64p), len(lens), step, threshold,
                        _ptr(out_pos, _i64p), _ptr(out_count, _i64p), max_out)
    return out_pos[:n], out_count[:n]


def seed_hist(block: np.ndarray, keylen: int, shift_tail: int,
              counts: np.ndarray) -> bool:
    """Accumulate the adapter-detection k-mer histogram over a uniform-length
    [n, rlen] uint8 block into ``counts`` (int64[4^keylen]).  Returns False
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    block = np.ascontiguousarray(block, np.uint8)
    lib.fq_seed_hist(_ptr(block, _u8p), block.shape[0], block.shape[1],
                     keylen, shift_tail, _ptr(counts, _i64p))
    return True


def find_seed(mat: np.ndarray, lens: np.ndarray, seed: bytes,
              min_pos: int, shift_tail: int):
    """All (row, pos) occurrences of ``seed`` in each row's first
    ``lens[r] - len(seed) - shift_tail + len(seed)`` bytes starting at
    ``min_pos`` (reference find loop, evaluator.cpp:398-409).  None without
    the native library."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    seed_arr = np.frombuffer(seed, np.uint8)
    cap = max(len(lens), 1024)
    while True:
        out_row = np.empty(cap, np.int64)
        out_pos = np.empty(cap, np.int32)
        m = lib.fq_find_seed(_ptr(mat, _u8p), mat.shape[0], mat.shape[1],
                             _ptr(lens, _i32p), _ptr(seed_arr, _u8p),
                             len(seed), min_pos, shift_tail,
                             _ptr(out_row, _i64p), _ptr(out_pos, _i32p), cap)
        if m <= cap:
            return out_row[:m], out_pos[:m]
        cap = int(m)


def top_keys(counts: np.ndarray, candidates: np.ndarray,
             topnum: int) -> Optional[np.ndarray]:
    """The reference's sequential top-N seed insertion (evaluator.cpp:287-337)
    over ascending candidate keys.  None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, np.int64)
    candidates = np.ascontiguousarray(candidates, np.int64)
    out = np.zeros(topnum, np.int64)
    lib.fq_top_keys(_ptr(counts, _i64p), _ptr(candidates, _i64p),
                    len(candidates), topnum, _ptr(out, _i64p))
    return out


def encode_native(seq: np.ndarray, qual: np.ndarray,
                  lut: np.ndarray) -> Optional[np.ndarray]:
    """One-pass enc = lut[seq, qual] (ops/packed.py::encode_host); None when
    the library is unavailable OR the content is invalid (max enc == 255)."""
    lib = get_lib()
    if lib is None:
        return None
    enc = np.empty(seq.shape, np.uint8)
    mx = lib.fq_encode(_ptr(seq, _u8p), _ptr(qual, _u8p), seq.size,
                       _ptr(lut, _u8p), _ptr(enc, _u8p))
    return None if mx == 255 else enc


def pack5_native(enc: np.ndarray):
    """5-bit dictionary packing (ops/packed.py::encode5_host).  Returns
    (packed, dict32), None when the alphabet exceeds 32 values, or False
    when the library is unavailable (caller uses the numpy path)."""
    lib = get_lib()
    if lib is None:
        return False
    B, L = enc.shape
    Lp = -(-L // 8) * 8
    packed = np.empty((B, (Lp // 8) * 5), np.uint8)
    dict32 = np.zeros(32, np.uint8)
    nvals = lib.fq_pack5(_ptr(enc, _u8p), B, L, Lp,
                         _ptr(packed, _u8p), _ptr(dict32, _u8p))
    return None if nvals < 0 else (packed, dict32)


def copy_spans_native(dst: np.ndarray, dst_off: np.ndarray,
                      src: np.ndarray, src_off: np.ndarray,
                      lens: np.ndarray) -> bool:
    """Ragged span copy (dst[dst_off[i]:+lens[i]] = src[src_off[i]:+lens[i]]).
    False when the library is unavailable (caller falls back to numpy).
    All arrays must be contiguous; offsets int64."""
    lib = get_lib()
    if lib is None:
        return False
    lib.fq_copy_spans(_ptr(dst, _u8p), _ptr(dst_off, _i64p),
                      _ptr(src, _u8p), _ptr(src_off, _i64p),
                      _ptr(lens, _i64p), len(lens))
    return True


class Inflater:
    """Streaming multi-member gzip inflater over the native codec; mirrors
    the zlib.decompressobj(wbits=47) + reset-on-member-end fallback."""

    def __init__(self, lib):
        self._lib = lib
        self._ctx = lib.gz_inflate_new()
        if not self._ctx:
            raise MemoryError("gz_inflate_new failed")
        self._pending = b""

    def inflate(self, data: bytes, out_cap: int) -> bytes:
        """Decompress up to ``out_cap`` bytes from pending + ``data``;
        unconsumed input is carried to the next call."""
        if self._pending:
            data = self._pending + data
            self._pending = b""
        out = np.empty(out_cap, np.uint8)
        used = np.zeros(1, np.int64)
        state = np.zeros(1, np.int32)
        n = self._lib.gz_inflate(self._ctx, data, len(data),
                                 _ptr(out, _u8p), out_cap,
                                 _ptr(used, _i64p), _ptr(state, _i32p))
        if state[0] < 0:
            raise RuntimeError("corrupt gzip stream")
        if used[0] < len(data):
            self._pending = data[int(used[0]):]
        return out[:n].tobytes()

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def close(self) -> None:
        if self._ctx:
            self._lib.gz_inflate_free(self._ctx)
            self._ctx = None

    def __del__(self):  # pragma: no cover
        self.close()


def make_inflater() -> Optional[Inflater]:
    lib = get_lib()
    return Inflater(lib) if lib is not None else None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def parse_buffer(buf: bytes, max_records: int, final: bool):
    """Native tokenize: returns (n, spans dict, consumed, error)."""
    lib = get_lib()
    if lib is None:
        return None
    name_off = np.empty(max_records, np.int64)
    name_len = np.empty(max_records, np.int32)
    seq_off = np.empty(max_records, np.int64)
    seq_len = np.empty(max_records, np.int32)
    strand_off = np.empty(max_records, np.int64)
    strand_len = np.empty(max_records, np.int32)
    qual_off = np.empty(max_records, np.int64)
    qual_len = np.empty(max_records, np.int32)
    consumed = np.zeros(1, np.int64)
    error = np.zeros(1, np.int32)
    n = lib.fq_parse(buf, len(buf), max_records, int(final),
                     _ptr(name_off, _i64p), _ptr(name_len, _i32p),
                     _ptr(seq_off, _i64p), _ptr(seq_len, _i32p),
                     _ptr(strand_off, _i64p), _ptr(strand_len, _i32p),
                     _ptr(qual_off, _i64p), _ptr(qual_len, _i32p),
                     _ptr(consumed, _i64p), _ptr(error, _i32p))
    return (int(n), dict(name_off=name_off[:n], name_len=name_len[:n],
                         seq_off=seq_off[:n], seq_len=seq_len[:n],
                         strand_off=strand_off[:n], strand_len=strand_len[:n],
                         qual_off=qual_off[:n], qual_len=qual_len[:n]),
            int(consumed[0]), int(error[0]))


def pack_spans(buf: bytes, spans: dict, width: int, phred64: bool):
    """Native pack of seq/qual spans into [n, width] matrices."""
    lib = get_lib()
    n = len(spans["seq_off"])
    seq = np.empty((n, width), np.uint8)
    qual = np.empty((n, width), np.uint8)
    lib.fq_pack(buf, n,
                _ptr(np.ascontiguousarray(spans["seq_off"]), _i64p),
                _ptr(np.ascontiguousarray(spans["seq_len"]), _i32p),
                _ptr(np.ascontiguousarray(spans["qual_off"]), _i64p),
                _ptr(seq, _u8p), _ptr(qual, _u8p), width, int(phred64))
    return seq, qual


def format_plane_records(select: np.ndarray,
                         names_buf: bytes, name_off: np.ndarray, name_len: np.ndarray,
                         strands_buf: bytes, strand_off: np.ndarray, strand_len: np.ndarray,
                         planes, plane_id: np.ndarray, row_idx: np.ndarray,
                         start: np.ndarray, out_len: np.ndarray,
                         tags: Optional[Tuple[bytes, np.ndarray, np.ndarray]] = None) -> bytes:
    """Native record materialization where each record's content row comes
    from one of up to three (seq, qual) matrix planes -- no interleaved copy.
    ``planes``: list of up to 3 (seq, qual) uint8 matrices."""
    lib = get_lib()
    n = len(select)
    sel = np.ascontiguousarray(select, np.uint8)
    start = np.ascontiguousarray(start, np.int32)
    out_len = np.ascontiguousarray(out_len, np.int32)
    name_off = np.ascontiguousarray(name_off, np.int64)
    name_len = np.ascontiguousarray(name_len, np.int32)
    strand_off = np.ascontiguousarray(strand_off, np.int64)
    strand_len = np.ascontiguousarray(strand_len, np.int32)
    plane_id = np.ascontiguousarray(plane_id, np.uint8)
    row_idx = np.ascontiguousarray(row_idx, np.int32)
    if tags is not None:
        tags_buf, tag_off, tag_len = tags
        tag_off = np.ascontiguousarray(tag_off, np.int64)
        tag_len = np.ascontiguousarray(tag_len, np.int32)
        extra = np.where(tag_len > 0, tag_len + 1, 0)
    else:
        tags_buf, tag_off, tag_len = None, None, None
        extra = 0
    m = sel.astype(bool)
    total = int(np.sum((name_len + 1 + out_len + 1 + strand_len + 1 + out_len + 1
                        + extra)[m], dtype=np.int64))
    # np.empty, not create_string_buffer: the ctypes buffer zero-fills
    # (~0.12 s per 50 MB pack on this box) before C overwrites every byte
    out = np.empty(max(total, 1), np.uint8)
    out_p = ctypes.cast(_ptr(out, _u8p), ctypes.c_char_p)
    args = []
    keep = []  # hold contiguous copies alive across the C call
    for k in range(3):
        if k < len(planes) and planes[k] is not None:
            s, q = planes[k]
            s = np.ascontiguousarray(s)
            q = np.ascontiguousarray(q)
            keep += [s, q]
            args += [_ptr(s, _u8p), _ptr(q, _u8p), s.shape[1]]
        else:
            args += [None, None, 0]
    written = lib.fq_format_planes(
        n, _ptr(sel, _u8p),
        names_buf, _ptr(name_off, _i64p), _ptr(name_len, _i32p),
        strands_buf, _ptr(strand_off, _i64p), _ptr(strand_len, _i32p),
        *args,
        _ptr(plane_id, _u8p), _ptr(row_idx, _i32p),
        _ptr(start, _i32p), _ptr(out_len, _i32p),
        tags_buf,
        _ptr(tag_off, _i64p) if tag_off is not None else None,
        _ptr(tag_len, _i32p) if tag_len is not None else None,
        out_p)
    return out[:written].tobytes()


def format_records(select: np.ndarray,
                   names_buf: bytes, name_off: np.ndarray, name_len: np.ndarray,
                   strands_buf: bytes, strand_off: np.ndarray, strand_len: np.ndarray,
                   seq: np.ndarray, qual: np.ndarray,
                   start: np.ndarray, out_len: np.ndarray,
                   tags: Optional[Tuple[bytes, np.ndarray, np.ndarray]] = None) -> bytes:
    """Native record materialization; returns the serialized FASTQ bytes."""
    lib = get_lib()
    n = len(select)
    sel = np.ascontiguousarray(select, np.uint8)
    start = np.ascontiguousarray(start, np.int32)
    out_len = np.ascontiguousarray(out_len, np.int32)
    name_off = np.ascontiguousarray(name_off, np.int64)
    name_len = np.ascontiguousarray(name_len, np.int32)
    strand_off = np.ascontiguousarray(strand_off, np.int64)
    strand_len = np.ascontiguousarray(strand_len, np.int32)
    if tags is not None:
        tags_buf, tag_off, tag_len = tags
        tag_off = np.ascontiguousarray(tag_off, np.int64)
        tag_len = np.ascontiguousarray(tag_len, np.int32)
        extra = np.where(tag_len > 0, tag_len + 1, 0)
    else:
        tags_buf, tag_off, tag_len = None, None, None  # NULL => no tags in C
        extra = 0
    m = sel.astype(bool)
    total = int(np.sum((name_len + 1 + out_len + 1 + strand_len + 1 + out_len + 1
                        + extra)[m], dtype=np.int64))
    # np.empty, not create_string_buffer: the ctypes buffer zero-fills
    # (~0.12 s per 50 MB pack on this box) before C overwrites every byte
    out = np.empty(max(total, 1), np.uint8)
    out_p = ctypes.cast(_ptr(out, _u8p), ctypes.c_char_p)
    written = lib.fq_format(
        n, _ptr(sel, _u8p),
        names_buf, _ptr(name_off, _i64p), _ptr(name_len, _i32p),
        strands_buf, _ptr(strand_off, _i64p), _ptr(strand_len, _i32p),
        _ptr(np.ascontiguousarray(seq), _u8p),
        _ptr(np.ascontiguousarray(qual), _u8p), seq.shape[1],
        _ptr(start, _i32p), _ptr(out_len, _i32p),
        tags_buf,
        _ptr(tag_off, _i64p) if tag_off is not None else None,
        _ptr(tag_len, _i32p) if tag_len is not None else None,
        out_p)
    return out[:written].tobytes()


class LineScanner:
    """Incremental strict-FASTQ line scanner over one input region (the
    parallel-ingest count pass, dist/ingest.py).  Feed raw text chunks;
    ``finish()`` returns the region summary used to compose the global pack
    plan."""

    def __init__(self, at_stream_start: bool):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._ctx = self._lib.fq_scan_new(int(at_stream_start))

    def feed(self, data: bytes) -> None:
        if data:
            self._lib.fq_scan_feed(self._ctx, data, len(data))

    def finish(self) -> dict:
        out = np.zeros(24, np.int64)
        last4b = np.zeros(4, np.uint8)
        self._lib.fq_scan_finish(self._ctx, _ptr(out, _i64p),
                                 _ptr(last4b, _u8p))
        self._lib.fq_scan_free(self._ctx)
        self._ctx = None
        return dict(
            n_nl=int(out[0]), head_len=int(out[1]), head_first=int(out[2]),
            tail_len=int(out[3]), tail_first=int(out[4]),
            seen_cr=bool(out[5]),
            ok=[bool(out[6 + h]) for h in range(4)],
            first_lens=[int(v) for v in out[10:14]],
            first_bytes=[int(v) for v in out[14:18]],
            last_lens=[int(v) for v in out[18:22]],
            last_bytes=[int(v) for v in last4b],
            n_first=int(out[22]), n_checked=int(out[23]))

    def close(self) -> None:
        if self._ctx:
            self._lib.fq_scan_free(self._ctx)
            self._ctx = None

    def __del__(self):  # pragma: no cover
        self.close()


def skip_newlines(buf: bytes, k: int):
    """(bytes_consumed, newlines_skipped) skipping up to k '\\n' in buf."""
    lib = get_lib()
    skipped = np.zeros(1, np.int64)
    consumed = lib.fq_skip_newlines(buf, len(buf), k, _ptr(skipped, _i64p))
    return int(consumed), int(skipped[0])


class MemberInflater:
    """Gzip inflater that STOPS at each member boundary (state 2) instead of
    resetting -- the parallel-ingest region scan uses the member-end events
    to verify a region's compressed bytes end exactly on a member boundary.

    inflate() returns (out_bytes, member_end: bool); after a member end the
    caller must call reset() before feeding further input."""

    def __init__(self):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._ctx = self._lib.gz_inflate_new()
        if not self._ctx:
            raise MemoryError("gz_inflate_new failed")
        self._pending = b""

    def inflate(self, data: bytes, out_cap: int):
        if self._pending:
            data = self._pending + data
            self._pending = b""
        out = np.empty(out_cap, np.uint8)
        used = np.zeros(1, np.int64)
        state = np.zeros(1, np.int32)
        n = self._lib.gz_inflate_member(self._ctx, data, len(data),
                                        _ptr(out, _u8p), out_cap,
                                        _ptr(used, _i64p), _ptr(state, _i32p))
        if state[0] < 0:
            raise RuntimeError("corrupt gzip stream")
        if used[0] < len(data):
            self._pending = data[int(used[0]):]
        return out[:n].tobytes(), state[0] == 2

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def reset(self) -> None:
        if self._lib.gz_inflate_reset(self._ctx) != 0:
            raise RuntimeError("inflateReset failed")

    def close(self) -> None:
        if self._ctx:
            self._lib.gz_inflate_free(self._ctx)
            self._ctx = None

    def __del__(self):  # pragma: no cover
        self.close()
