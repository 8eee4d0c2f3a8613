# Copy of fqtool_tpu/io/fastq.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""FASTQ pack I/O.

The TPU pipeline consumes *packs*: struct-of-array batches with fixed-shape
``uint8[B, L]`` base/quality matrices plus per-read lengths.  Names and strand
lines stay in the raw text buffer as (offset, length) spans -- the native core
(``native/fastq_core.cpp``) tokenizes input text and re-materializes output
records without per-record Python work.  This replaces the reference's
per-read ``FqReader``/``Writer`` objects (reference: src/fqreader.cpp:160-195,
src/writer.cpp:81-92).

Record-level parsing semantics follow the reference reader:
  * name lines: blank lines and lines not starting with '@' are skipped
    (fqreader.cpp:169-171);
  * a quality/sequence length mismatch reports an error and terminates the
    stream (fqreader.cpp:184-191);
  * phred64 input is converted to phred33 clamped at 33 (read.h:71-75).
"""

from __future__ import annotations

import gzip
import os
import struct
import sys
import threading
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import native

DEFAULT_PACK_READS = 100000  # reference: options.h:21 maxReadsInPack
_READ_CHUNK = 8 << 20


@dataclass
class ReadPack:
    """A batch of reads in struct-of-arrays form.

    ``buf`` owns the raw header text; names (including the leading '@') and
    strand lines are (offset, length) spans into it.  ``seq``/``qual`` are
    zero-padded ASCII byte matrices.
    """

    buf: bytes
    name_off: np.ndarray     # int64 [B]
    name_len: np.ndarray     # int32 [B]
    strand_off: np.ndarray   # int64 [B]
    strand_len: np.ndarray   # int32 [B]
    seq: np.ndarray          # uint8 [B, L]
    qual: np.ndarray         # uint8 [B, L]
    lens: np.ndarray         # int32 [B]
    _names: Optional[List[bytes]] = field(default=None, repr=False)
    # replacement name buffer (UMI tagging rewrites names wholesale);
    # name_off/name_len then index into it instead of ``buf``
    _name_buf: Optional[bytes] = field(default=None, repr=False)
    # packed-transport encoding of (seq, qual) (ops/packed.py), computed in
    # the prefetch thread when the link probe enables packing; None when
    # packing is off or the content is outside the encodable alphabet
    enc: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def count(self) -> int:
        return len(self.lens)

    @property
    def width(self) -> int:
        return self.seq.shape[1]

    # -- names ---------------------------------------------------------
    @property
    def _nbuf(self) -> bytes:
        return self.buf if self._name_buf is None else self._name_buf

    @property
    def names(self) -> List[bytes]:
        """Materialized (mutable) name list; mutations are honored by
        ``name_arrays`` via a rebuild."""
        if self._names is None:
            nbuf = self._nbuf
            self._names = [
                nbuf[self.name_off[i]: self.name_off[i] + self.name_len[i]]
                for i in range(self.count)]
        return self._names

    def name(self, i: int) -> bytes:
        if self._names is not None:
            return self._names[i]
        nbuf = self._nbuf
        return nbuf[self.name_off[i]: self.name_off[i] + self.name_len[i]]

    def set_name_arrays(self, buf: bytes, off: np.ndarray, lens: np.ndarray) -> None:
        """Replace every name wholesale (vectorized UMI tagging)."""
        self._name_buf = buf
        self.name_off = off.astype(np.int64)
        self.name_len = lens.astype(np.int32)
        self._names = None

    def strand(self, i: int) -> bytes:
        return self.buf[self.strand_off[i]: self.strand_off[i] + self.strand_len[i]]

    @property
    def strands(self) -> List[bytes]:
        return [self.strand(i) for i in range(self.count)]

    def name_arrays(self) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """(buf, offsets, lengths) for native formatting, reflecting any
        mutation made through ``names``."""
        if self._names is None:
            return self._nbuf, self.name_off, self.name_len
        lens = np.fromiter((len(n) for n in self._names),
                           count=self.count, dtype=np.int32)
        off = np.zeros(self.count, np.int64)
        np.cumsum(lens[:-1], out=off[1:])
        return b"".join(self._names), off, lens

    def strand_arrays(self) -> Tuple[bytes, np.ndarray, np.ndarray]:
        return self.buf, self.strand_off, self.strand_len

    # -- content -------------------------------------------------------
    def read_seq(self, i: int, start: int = 0, length: Optional[int] = None) -> bytes:
        n = self.lens[i] if length is None else length
        return self.seq[i, start : start + n].tobytes()

    def read_qual(self, i: int, start: int = 0, length: Optional[int] = None) -> bytes:
        n = self.lens[i] if length is None else length
        return self.qual[i, start : start + n].tobytes()


def _round_width(n: int, multiple: int = 8) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def make_pack(records: List[Tuple[bytes, bytes, bytes, bytes]], phred64: bool = False,
              width_multiple: int = 8) -> ReadPack:
    """Build a ReadPack from (name, seq, strand, qual) byte tuples (pure
    Python path; used by tests and as the no-compiler fallback)."""
    B = len(records)
    names = [r[0] for r in records]
    strands = [r[2] for r in records]
    seqs = [r[1] for r in records]
    quals = [r[3] for r in records]
    if B == 0:
        z64 = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return ReadPack(b"", z64, z32, z64.copy(), z32.copy(),
                        np.zeros((0, 8), np.uint8), np.zeros((0, 8), np.uint8),
                        np.zeros(0, np.int32))
    lens = np.fromiter((len(s) for s in seqs), count=B, dtype=np.int32)
    width = _round_width(int(lens.max(initial=0)), width_multiple)
    seq = np.frombuffer(np.array(seqs, dtype=f"S{width}").tobytes(), np.uint8).reshape(-1, width)
    qual = np.frombuffer(np.array(quals, dtype=f"S{width}").tobytes(), np.uint8).reshape(-1, width).copy()
    if phred64:
        qual = np.where(qual > 0, np.maximum(qual.astype(np.int16) - 31, 33), 0).astype(np.uint8)
    name_len = np.fromiter((len(n) for n in names), count=B, dtype=np.int32)
    strand_len = np.fromiter((len(s) for s in strands), count=B, dtype=np.int32)
    name_buf = b"".join(names)
    strand_buf = b"".join(strands)
    name_off = np.zeros(B, np.int64)
    np.cumsum(name_len[:-1], out=name_off[1:])
    strand_off = np.zeros(B, np.int64)
    np.cumsum(strand_len[:-1], out=strand_off[1:])
    return ReadPack(name_buf + strand_buf, name_off, name_len,
                    strand_off + len(name_buf), strand_len,
                    seq, qual, lens)


class FastqStreamError(RuntimeError):
    pass


class SkippedPack:
    """Placeholder for a pack owned by another host: the stream was advanced
    and record boundaries counted, but no matrices were built."""

    __slots__ = ("count",)

    def __init__(self, count: int):
        self.count = count


class FastqIOError(Exception):
    """Unreadable input stream (corrupt gzip, IO failure).  The reference
    prints "Error to read gzip file" and then crashes on the dead stream
    (fqreader.cpp:35-38); we print the same message and exit cleanly."""


class _RawStream:
    """Chunked reader over a possibly-gzipped (multi-member) file.

    Decompression goes through the native zlib codec (native/fastq_core.cpp
    gz_inflate, GIL-released and callable from IO worker threads) with the
    Python zlib object as fallback."""

    def __init__(self, path: str):
        self.path = path
        if path == "/dev/stdin":
            self._fh = sys.stdin.buffer
            self._close = False
        else:
            self._fh = open(path, "rb", buffering=1 << 20)
            self._close = True
        self._gz = path.endswith(".gz")
        # only constructed when the native lib loaded (PackReader guards),
        # so the native inflater is always available for gz inputs
        self._inf = native.make_inflater() if self._gz else None
        self._raw_eof = False

    def _read_native(self) -> bytes:
        out = []
        total = 0
        while total < _READ_CHUNK:
            if self._inf.has_pending:
                d = self._inf.inflate(b"", _READ_CHUNK - total)
            else:
                raw = self._fh.read(1 << 20)
                if not raw:
                    self._raw_eof = True
                    break
                d = self._inf.inflate(raw, _READ_CHUNK - total)
            if d:
                out.append(d)
                total += len(d)
            elif not self._inf.has_pending and self._raw_eof:
                break
        return b"".join(out)

    def read_chunk(self) -> bytes:
        if not self._gz:
            return self._fh.read(_READ_CHUNK)
        try:
            return self._read_native()
        except (zlib.error, RuntimeError) as e:
            raise FastqIOError(
                f"Error to read gzip file: {self.path} ({e})") from e

    def close(self):
        if self._close:
            self._fh.close()


class PackReader:
    """Streaming pack reader over one FASTQ file (native tokenizer when
    available, Python fallback otherwise)."""

    def __init__(self, path: str, pack_reads: int = DEFAULT_PACK_READS,
                 phred64: bool = False, width_multiple: int = 8):
        self.path = path
        self.pack_reads = pack_reads
        self.phred64 = phred64
        self.width_multiple = width_multiple
        self._use_native = native.get_lib() is not None
        if self._use_native:
            self._stream = _RawStream(path)
            # gz inputs: inflate in its own thread so decompression overlaps
            # tokenize + pack build (both native, GIL-released) -- the input
            # chain otherwise serializes inflate->parse->pack in one thread
            self._chunks = (prefetch_iter(iter(self._stream.read_chunk, b""),
                                          depth=3)
                            if path.endswith(".gz") else None)
            self._pending = bytearray()
            self._eof = False
            self._err = False
            self._bytes_per_rec = 300.0
        else:
            self._py_iter = iter_records(path)
        self._done = False

    def next_pack(self, skip: bool = False):
        """Next pack, or a :class:`SkippedPack` (record count only) when
        ``skip`` is set -- used by multi-host runs to advance past packs owned
        by other hosts without building matrices."""
        if self._done:
            return None
        pack = (self._next_native(skip) if self._use_native
                else self._next_python(skip))
        if pack is None or pack.count == 0:
            self._done = True
            if self._use_native:
                self._close_native()
            return None
        return pack

    def close(self) -> None:
        if self._use_native:
            self._close_native()
        else:
            self._py_iter.close()

    def _close_native(self) -> None:
        if self._chunks is not None:
            self._chunks.close()  # unwind the inflate thread
            self._chunks = None
        self._stream.close()

    # ------------------------------------------------------------------
    def _next_native(self, skip: bool = False):
        if self._err:
            return None
        want = int(self.pack_reads * self._bytes_per_rec * 1.1) + (1 << 16)
        while True:
            while not self._eof and len(self._pending) < want:
                chunk = (next(self._chunks, b"") if self._chunks is not None
                         else self._stream.read_chunk())
                if not chunk:
                    self._eof = True
                    break
                self._pending += chunk
            buf = bytes(self._pending)
            n, spans, consumed, err = native.parse_buffer(
                buf, self.pack_reads, final=self._eof)
            if err:
                sys.stderr.write(
                    "Error: base sequnce and quality sequence have different length\n")
                self._err = True
            if n >= self.pack_reads or self._eof or err:
                if n == 0:
                    return None
                del self._pending[:consumed]
                self._bytes_per_rec = max(50.0, consumed / max(n, 1))
                if skip:
                    return SkippedPack(n)
                return self._make_native_pack(buf, n, spans)
            # not enough data parsed yet: read more (the loop condition
            # already returned above when _eof was set)
            want = int(want * 1.5) + (1 << 20)

    def _make_native_pack(self, buf: bytes, n: int, spans: dict) -> ReadPack:
        return pack_from_spans(buf, spans, self.phred64, self.width_multiple)

    def _next_python(self, skip: bool = False):
        recs = []
        for rec in self._py_iter:
            recs.append(rec)
            if len(recs) >= self.pack_reads:
                break
        if not recs:
            return None
        if skip:
            return SkippedPack(len(recs))
        return make_pack(recs, self.phred64, self.width_multiple)


def pack_from_spans(buf: bytes, spans: dict, phred64: bool,
                    width_multiple: int = 8) -> ReadPack:
    """Build a ReadPack from native tokenizer spans (also used by the
    parallel-ingest materializer, dist/ingest.py)."""
    lens = spans["seq_len"].astype(np.int32)
    width = _round_width(int(lens.max(initial=0)), width_multiple)
    seq, qual = native.pack_spans(buf, spans, width, phred64)
    return ReadPack(buf, spans["name_off"].copy(), spans["name_len"].copy(),
                    spans["strand_off"].copy(), spans["strand_len"].copy(),
                    seq, qual, lens)


def iter_records(path: str) -> Iterator[Tuple[bytes, bytes, bytes, bytes]]:
    """Yield (name, seq, strand, qual) raw byte tuples from a FASTQ file
    (pure Python; reference semantics fqreader.cpp:160-195)."""
    try:
        yield from _iter_records(path)
    except EOFError:
        # truncated stream: the reference's gzread returns what it has and
        # the run continues with the records read so far (fqreader.cpp:35-43)
        return
    except (zlib.error, OSError) as e:
        # corrupt stream (gzip.BadGzipFile is an OSError subclass)
        raise FastqIOError(f"Error to read gzip file: {path} ({e})") from e


def _iter_records(path: str) -> Iterator[Tuple[bytes, bytes, bytes, bytes]]:
    if path == "/dev/stdin":
        fh = sys.stdin.buffer
    elif path.endswith(".gz"):
        fh = gzip.open(path, "rb")
    else:
        fh = open(path, "rb")
    with fh:
        # reference getLine semantics (fqreader.cpp:90-150, mirrored by the
        # native tokenizer): a line ends at the FIRST of \r or \n, and one
        # following \n is swallowed (handles \r\n AND merges an empty next
        # line into the break) unless it is the last byte of the stream
        buf = b""
        pos = 0
        eof = False

        def refill() -> None:
            nonlocal buf, pos, eof
            if pos:
                buf = buf[pos:]
                pos = 0
            d = fh.read(1 << 20)
            if not d:
                eof = True
            else:
                buf += d

        def get_line() -> Optional[bytes]:
            nonlocal pos
            while True:
                i1 = buf.find(b"\n", pos)
                i2 = buf.find(b"\r", pos)
                end = i1 if i2 < 0 else (i2 if i1 < 0 else min(i1, i2))
                if end < 0:
                    if eof:
                        if pos >= len(buf):
                            return None
                        line = buf[pos:]
                        pos = len(buf)
                        return line
                    refill()
                    continue
                after = end + 1
                if after >= len(buf) - 1 and not eof:
                    refill()
                    continue
                line = buf[pos:end]
                pos = after
                if pos < len(buf) - 1 and buf[pos] == 0x0A:
                    pos += 1
                return line

        while True:
            name = None
            while True:
                line = get_line()
                if line is None:
                    return
                if line.startswith(b"@"):
                    name = line
                    break
            seq = get_line()
            if seq is None:
                return
            strand = get_line()
            qual = get_line()
            strand = b"" if strand is None else strand
            qual = b"" if qual is None else qual
            if len(qual) != len(seq):
                sys.stderr.write(
                    "Error: base sequnce and quality sequence have different length: \n"
                    + name.decode("latin-1") + "\n" + seq.decode("latin-1") + "\n"
                    + qual.decode("latin-1") + "\n" + strand.decode("latin-1") + "\n")
                return
            yield (name, seq, strand, qual)


def iter_packs(path: str, pack_reads: int = DEFAULT_PACK_READS, phred64: bool = False,
               width_multiple: int = 8) -> Iterator[ReadPack]:
    reader = PackReader(path, pack_reads, phred64, width_multiple)
    try:
        while True:
            pack = reader.next_pack()
            if pack is None:
                return
            yield pack
    finally:
        reader.close()


def iter_packs_paired(path1: str, path2: str, interleaved: bool = False,
                      pack_reads: int = DEFAULT_PACK_READS, phred64: bool = False,
                      width_multiple: int = 8) -> Iterator[Tuple[ReadPack, ReadPack]]:
    """Yield (pack1, pack2) with equal counts; stops at the shorter stream
    (reference: fqreader.cpp:254-267 returns NULL when either side is out)."""
    if interleaved:
        def gen():
            it = iter_records(path1)
            while True:
                r1 = next(it, None)
                if r1 is None:
                    return
                r2 = next(it, None)
                if r2 is None:
                    return
                yield r1, r2

        pairs = gen()
        buf1: List[Tuple[bytes, bytes, bytes, bytes]] = []
        buf2: List[Tuple[bytes, bytes, bytes, bytes]] = []
        for r1, r2 in pairs:
            buf1.append(r1)
            buf2.append(r2)
            if len(buf1) >= pack_reads:
                yield make_pack(buf1, phred64, width_multiple), \
                    make_pack(buf2, phred64, width_multiple)
                buf1, buf2 = [], []
        if buf1:
            yield make_pack(buf1, phred64, width_multiple), \
                make_pack(buf2, phred64, width_multiple)
        return

    rd1 = PackReader(path1, pack_reads, phred64, width_multiple)
    rd2 = PackReader(path2, pack_reads, phred64, width_multiple)

    # one decode thread per side: R1 and R2 gzip inflation + tokenization run
    # in parallel (zlib releases the GIL) instead of serially in one thread
    def packs_of(rd):
        def gen():
            try:
                while True:
                    p = rd.next_pack()
                    if p is None:
                        return
                    yield p
            finally:
                rd.close()
        return prefetch_iter(gen(), depth=2)

    yield from zip_pack_iters(packs_of(rd1), packs_of(rd2))


def zip_pack_iters(it1, it2) -> Iterator[Tuple[ReadPack, ReadPack]]:
    """Pair two pack streams with the shorter-stream stop + truncation
    semantics of :func:`iter_packs_paired` (shared with the head-cache
    resume path, io/headcache.py)."""
    try:
        while True:
            p1 = next(it1, None)
            p2 = next(it2, None)
            if p1 is None or p2 is None:
                return
            n = min(p1.count, p2.count)
            if n == 0:
                return
            if p1.count != p2.count:
                p1 = _truncate_pack(p1, n)
                p2 = _truncate_pack(p2, n)
                yield p1, p2
                return  # shorter stream exhausted
            yield p1, p2
    finally:
        # early returns (mismatch, shorter stream) abandon the other side's
        # prefetch thread otherwise: close() unwinds it and the PackReader
        it1.close()
        it2.close()


def _truncate_pack(p: ReadPack, n: int) -> ReadPack:
    return ReadPack(p.buf, p.name_off[:n], p.name_len[:n],
                    p.strand_off[:n], p.strand_len[:n],
                    p.seq[:n], p.qual[:n], p.lens[:n])


# Shared worker pool for GIL-releasing host work: gzip block deflate
# (below), packed-transport encode, and merged-record formatting all ride
# it, so total host CPU stays bounded near the core count.  Deflate is the
# founding use: output compression was the dominant steady-state cost of
# the SE pipelines (the single writer thread deflated ~100 MB/run while
# three cores idled).  Blocks compress concurrently pigz-style and are
# stitched, in order, into ONE valid gzip member: each block is an
# independent raw-deflate stream ended with Z_FULL_FLUSH (byte-aligned,
# empty-stored-block marker), and close() appends a final empty Z_FINISH
# block plus the crc32/isize trailer.  Same input bytes => same block
# boundaries => deterministic output.
_DEFLATE_BLOCK = 1 << 20
_shared_pool = None
_shared_pool_size = None
_shared_pool_lock = threading.Lock()


def set_worker_threads(n: int) -> None:
    """Size the shared host pool from ``-w`` (reference: N worker pthreads,
    src/seprocessor.cpp:160-180; here the host work that scales with workers
    is the GIL-releasing pool -- parallel deflate, record formatting, pack
    encoding).  Must run before the first shared_pool() call; later calls
    are ignored (the pool is process-wide)."""
    global _shared_pool_size
    with _shared_pool_lock:
        if _shared_pool is None:
            _shared_pool_size = max(2, min(32, int(n)))


def shared_pool():
    """Process-wide bounded ThreadPoolExecutor for GIL-releasing host work."""
    global _shared_pool
    if _shared_pool is None:
        with _shared_pool_lock:
            if _shared_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                n = _shared_pool_size or max(2, min(6, os.cpu_count() or 1))
                _shared_pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="fq_pool")
    return _shared_pool


def _deflate_block(block: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(block) + co.flush(zlib.Z_FULL_FLUSH)


_GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"  # mtime 0, OS unix


class OutputWriter:
    """Streaming FASTQ output, gzip when the filename ends with .gz.

    Mirrors the reference Writer (src/writer.cpp:30-60): compression level
    from options, 1 MiB buffering.  The gzip stream is produced by the
    shared parallel deflate pool above; the reference serializes deflate on
    each WriterThread (src/writerthread.cpp) which left it output-bound.
    """

    def __init__(self, path: str, compression: int = 3):
        self.path = path
        self._gz = path.endswith(".gz")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(path, "wb", buffering=1 << 20)
        if self._gz:
            self._level = compression
            self._crc = 0
            self._size = 0
            self._pending = deque()       # ordered block futures
            self._fh.write(_GZIP_HEADER)

    def _submit(self, block: bytes) -> None:
        self._crc = zlib.crc32(block, self._crc)
        self._size += len(block)
        self._pending.append(
            shared_pool().submit(_deflate_block, block, self._level))
        # opportunistic in-order drain; hard-bound the in-flight window
        while self._pending and self._pending[0].done():
            self._fh.write(self._pending.popleft().result())
        while len(self._pending) > 32:
            self._fh.write(self._pending.popleft().result())

    def write(self, data: bytes) -> None:
        """Append ``data``; in gzip mode every call is a deflate-block
        boundary (callers write once per pack), so a pack's compressed bytes
        depend only on the pack's own content -- the multi-host part writers
        reproduce them independently per rank and rank 0 concatenates into a
        stream byte-identical to the single-process run (dist/multihost.py)."""
        if not data:
            return
        if not self._gz:
            self._fh.write(data)
            return
        view = memoryview(data)
        for lo in range(0, len(data), _DEFLATE_BLOCK):
            self._submit(bytes(view[lo:lo + _DEFLATE_BLOCK]))

    def close(self) -> None:
        if self._fh is None:
            return
        if self._gz:
            while self._pending:
                self._fh.write(self._pending.popleft().result())
            # final empty Z_FINISH block terminates the member
            self._fh.write(zlib.compressobj(
                self._level, zlib.DEFLATED, -15).flush(zlib.Z_FINISH))
            self._fh.write(struct.pack("<II", self._crc & 0xFFFFFFFF,
                                       self._size & 0xFFFFFFFF))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncWriter:
    """OutputWriter wrapped in a writer thread: gzip compression (zlib
    releases the GIL) and file writes overlap pipeline compute, replacing the
    reference's per-file WriterThread ring buffers (src/writerthread.cpp)."""

    _SENTINEL = object()

    def __init__(self, path: str, compression: int = 3, max_queue: int = 16):
        import queue
        import threading

        self._inner = OutputWriter(path, compression)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def path(self) -> str:
        return self._inner.path

    def _loop(self) -> None:
        from ..host.tracing import stage
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            try:
                # thread-side total: deflate + file write across all writers
                with stage("gzip_out"):
                    self._inner.write(item)
            except BaseException as e:  # surfaced on next write/close
                self._exc = e
                return

    def write(self, data: bytes) -> None:
        import queue
        if self._exc:
            raise self._exc
        if not data:
            return
        while True:
            try:
                self._q.put(data, timeout=0.5)
                return
            except queue.Full:
                # a dead writer thread leaves the queue full forever
                if self._exc:
                    raise self._exc
                if not self._thread.is_alive():
                    raise RuntimeError(
                        f"writer thread for {self.path} died")

    def close(self) -> None:
        import queue
        while self._thread.is_alive() and not self._exc:
            try:
                self._q.put(self._SENTINEL, timeout=0.2)
                break
            except queue.Full:
                continue
        self._thread.join()
        if self._exc:
            raise self._exc
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_iter(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue --
    overlaps input decompression/parsing with downstream processing."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()
    box = {}
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:
            box["exc"] = e
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass
            put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                if "exc" in box:
                    raise box["exc"]
                return
            yield item
    finally:
        # abandoned consumer (early return / exception downstream): unblock
        # the worker, let it close the source, and join it
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)


def format_record(name: bytes, seq: bytes, strand: bytes, qual: bytes,
                  tag: Optional[bytes] = None) -> bytes:
    """4-line FASTQ serialization (reference: read.h:166-176)."""
    if tag is not None:
        name = name + b" " + tag
    return b"%s\n%s\n%s\n%s\n" % (name, seq, strand, qual)


def format_array_records(select: np.ndarray,
                         names_buf: bytes, name_off: np.ndarray, name_len: np.ndarray,
                         strands_buf: bytes, strand_off: np.ndarray, strand_len: np.ndarray,
                         seq: np.ndarray, qual: np.ndarray,
                         start: np.ndarray, out_len: np.ndarray,
                         tags: Optional[Tuple[bytes, np.ndarray, np.ndarray]] = None) -> bytes:
    """Materialize selected records from raw arrays (native when available)."""
    if not select.any():
        return b""
    if native.get_lib() is not None:
        return native.format_records(select, names_buf, name_off, name_len,
                                     strands_buf, strand_off, strand_len,
                                     seq, qual, start, out_len, tags)
    parts = []
    for i in np.flatnonzero(select):
        tag = b""
        if tags is not None and tags[2][i]:
            tag = b" " + tags[0][tags[1][i]: tags[1][i] + tags[2][i]]
        s = int(start[i])
        n = int(out_len[i])
        name = names_buf[name_off[i]: name_off[i] + name_len[i]]
        strand = strands_buf[strand_off[i]: strand_off[i] + strand_len[i]]
        parts.append(b"%s%s\n%s\n%s\n%s\n" % (
            name, tag, seq[i, s : s + n].tobytes(), strand,
            qual[i, s : s + n].tobytes()))
    return b"".join(parts)


def format_plane_array_records(select: np.ndarray,
                               names_buf: bytes, name_off: np.ndarray, name_len: np.ndarray,
                               strands_buf: bytes, strand_off: np.ndarray, strand_len: np.ndarray,
                               planes, plane_id: np.ndarray, row_idx: np.ndarray,
                               start: np.ndarray, out_len: np.ndarray,
                               tags: Optional[Tuple[bytes, np.ndarray, np.ndarray]] = None) -> bytes:
    """Materialize records whose content rows come from one of up to three
    (seq, qual) matrix planes (native when available) -- the PE merged/failed
    stream interleaves without a host-side [kn, max_width] copy."""
    if not select.any():
        return b""
    if native.get_lib() is not None:
        return native.format_plane_records(
            select, names_buf, name_off, name_len,
            strands_buf, strand_off, strand_len,
            planes, plane_id, row_idx, start, out_len, tags)
    parts = []
    for i in np.flatnonzero(select):
        s_mat, q_mat = planes[int(plane_id[i])]
        r = int(row_idx[i])
        tag = b""
        if tags is not None and tags[2][i]:
            tag = b" " + tags[0][tags[1][i]: tags[1][i] + tags[2][i]]
        s = int(start[i])
        n = int(out_len[i])
        name = names_buf[name_off[i]: name_off[i] + name_len[i]]
        strand = strands_buf[strand_off[i]: strand_off[i] + strand_len[i]]
        parts.append(b"%s%s\n%s\n%s\n%s\n" % (
            name, tag, s_mat[r, s : s + n].tobytes(), strand,
            q_mat[r, s : s + n].tobytes()))
    return b"".join(parts)


def format_selected(pack: ReadPack, select: np.ndarray, start: np.ndarray,
                    out_len: np.ndarray,
                    seq: Optional[np.ndarray] = None,
                    qual: Optional[np.ndarray] = None,
                    tags: Optional[Tuple[bytes, np.ndarray, np.ndarray]] = None) -> bytes:
    """Materialize all selected records of a pack in one native call.

    ``seq``/``qual`` default to the pack matrices; pass device-corrected
    arrays (with start already applied) to emit modified content.
    """
    if not select.any():
        return b""
    nb, no, nl = pack.name_arrays()
    sb, so, sl = pack.strand_arrays()
    seq = pack.seq if seq is None else seq
    qual = pack.qual if qual is None else qual
    if native.get_lib() is not None:
        return native.format_records(select, nb, no, nl, sb, so, sl,
                                     seq, qual, start, out_len, tags)
    parts = []
    for i in np.flatnonzero(select):
        tag = None
        if tags is not None and tags[2][i]:
            tag = tags[0][tags[1][i]: tags[1][i] + tags[2][i]]
        s = int(start[i])
        n = int(out_len[i])
        parts.append(format_record(pack.name(i), seq[i, s : s + n].tobytes(),
                                   pack.strand(i), qual[i, s : s + n].tobytes(),
                                   tag))
    return b"".join(parts)
