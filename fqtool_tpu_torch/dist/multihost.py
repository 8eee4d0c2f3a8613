# Copy of fqtool_tpu/dist/multihost.py without _init_jax (the
# jax.distributed.initialize call): the TCP layer below carries every byte
# between ranks.
"""Multi-host data parallelism.

The reference's only scaling axis is the read axis (N worker pthreads over
read packs, reference: src/seprocessor.cpp:59-180); the multi-host equivalent
shards the *pack stream* across host processes:

* A TCP process group (rank 0 listens, every other rank connects) carries
  all traffic between ranks; each rank computes its own packs on its own
  torch device (ranks on one host share it), and the only cross-host
  traffic is the end-of-stream statistics reduction (histograms and sparse
  duplication entries, a few MB at most) and the pre-pass broadcast.
* The input stream is split into WRITE-UNIT-sized ownership quanta
  (pipeline/runner.py WRITE_UNIT, 16384 records): the parallel-ingest
  planner (dist/ingest.py) assigns each rank a contiguous unit range and the
  rank reads only ~1/world of each input's bytes; consecutive owned units
  are batched back into full-size device packs.  (Fallback for inputs the
  planner cannot prove strict: every rank advances the stream but
  skip-tokenizes foreign units, ownership strided mod world.)
* Each output stream is written as one per-host part file of unit-ordered
  records plus a (unit index, ...) manifest.  For .gz outputs every rank
  DEFLATES its own units during the run with the exact block framing the
  single-process OutputWriter uses (each write-unit is a block boundary), so
  rank 0 only concatenates compressed spans in global unit order and stamps
  the member trailer with a combined CRC -- the final bytes equal the
  single-process run exactly, with zero serial recompression (replacing the
  reference's mutex-serialized output ordering, seprocessor.cpp:356-380).
* Stats / FilterResult / duplication / insert-size accumulators are reduced
  to rank 0 over a TCP allgather (the duplication combine is associative:
  min-kmer wins, equal kmers add counts, earliest ``first_pos`` keeps the
  first-record GC -- see host/duplicate.py).
* Split output (`-s`/`-S`): ownership moves to the split pack quantum
  (rotation happens between packs), ranks deflate owned packs with the
  single-process per-pack framing, and rank 0 replays the rotation state
  machine over the gathered global (count, read_passed) sequence
  (pipeline/runner.py::replay_split_rotation) to route each pack's spans
  to the same numbered file via :meth:`MultihostContext.merge_split_stream`
  -- byte-identical split files at any world size.

Activation: set ``FQTOOL_TPU_COORDINATOR=host:port``, ``FQTOOL_TPU_NPROCS``
and ``FQTOOL_TPU_PROC_ID``.  The stat-reduction socket uses port+1 (override
with ``FQTOOL_TPU_REDUCE_PORT``).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import time
from typing import Iterator, List, Optional, Tuple

import zlib

import numpy as np

from ..io.fastq import (_DEFLATE_BLOCK, _GZIP_HEADER, FastqIOError,
                        OutputWriter, PackReader, _deflate_block,
                        _truncate_pack, iter_packs_paired, prefetch_iter,
                        shared_pool)


def _gf2_times_vec(mat: np.ndarray, vec: int) -> int:
    """GF(2) matrix x vector: XOR of mat rows selected by vec's bits."""
    bits = (vec >> np.arange(32, dtype=np.uint32)) & 1
    return int(np.bitwise_xor.reduce(np.where(bits.astype(bool), mat, 0)))


def _gf2_square(mat: np.ndarray) -> np.ndarray:
    """GF(2) matrix squaring, vectorized: out[n] = mat x mat[n]."""
    # bits[n, i] = bit i of mat[n]; out[n] = XOR_i bits[n,i] * mat[i]
    bits = ((mat[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
            ).astype(bool)
    return np.bitwise_xor.reduce(np.where(bits, mat[None, :], 0), axis=1)


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's crc32_combine: CRC of the concatenation A++B from crc(A),
    crc(B) and len(B), via GF(2) matrix exponentiation -- O(log len2).

    numpy bit-matrix formulation: each squaring is one [32, 32] masked-XOR
    reduction instead of 32 Python bit loops (the rank-0 merge combines one
    CRC per write unit; the pure-Python version cost ~3 ms per combine and
    dominated the end-of-stream merge at bench scale)."""
    if len2 == 0:
        return crc1
    if not _CRC_OPS:
        # operator ladder: _CRC_OPS[k] appends 2^k zero BYTES; built once
        # (64 squarings) and reused -- a combine is then just
        # popcount(len2) matrix-vector products
        op = np.array([0xEDB88320] + [1 << n for n in range(31)], np.uint32)
        op = _gf2_square(_gf2_square(op))  # 4 zero bits
        for _ in range(64):
            op = _gf2_square(op)           # 8, 16, 32, ... zero bits
            _CRC_OPS.append(op)
    k = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_times_vec(_CRC_OPS[k], crc1)
        len2 >>= 1
        k += 1
    return (crc1 ^ crc2) & 0xFFFFFFFF


_CRC_OPS: List[np.ndarray] = []

_ctx: Optional["MultihostContext"] = None
_inited = False


def active() -> Optional["MultihostContext"]:
    """The process's multihost context (constructed once from env), or None
    for single-process runs."""
    global _ctx, _inited
    if not _inited:
        _inited = True
        coord = os.environ.get("FQTOOL_TPU_COORDINATOR")
        world = int(os.environ.get("FQTOOL_TPU_NPROCS", "0") or 0)
        if coord and world > 1:
            rank = int(os.environ["FQTOOL_TPU_PROC_ID"])
            _ctx = MultihostContext(coord, world, rank)
    return _ctx


def _send(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("<Q", len(data)))
    sock.sendall(data)


def _recvn(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("multihost peer closed the connection")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def _recv(sock: socket.socket):
    (n,) = struct.unpack("<Q", _recvn(sock, 8))
    return pickle.loads(_recvn(sock, n))


class MultihostContext:
    def __init__(self, coordinator: str, world: int, rank: int):
        host, port = coordinator.rsplit(":", 1)
        self.world = world
        self.rank = rank
        self.host = host
        self.jax_port = int(port)
        self.reduce_port = int(os.environ.get("FQTOOL_TPU_REDUCE_PORT",
                                              self.jax_port + 1))
        self._conns: dict = {}
        self._sock: Optional[socket.socket] = None
        listener = None
        if rank == 0:
            listener = socket.create_server(("", self.reduce_port),
                                            backlog=world)
        self._connect(listener)

    def _connect(self, listener) -> None:
        # large worlds with slow interpreter/scheduler startup can legitimately
        # take longer than the 120s default to get every peer connected
        connect_timeout = float(os.environ.get("FQTOOL_TPU_CONNECT_TIMEOUT",
                                               "120"))
        if self.rank == 0:
            # bounded accept: a peer that dies before connecting (startup
            # crash, bad input on its rank) must fail this rank with the
            # clean ConnectionError path (main.py), not strand it in accept
            deadline = time.monotonic() + connect_timeout
            with listener:
                while len(self._conns) < self.world - 1:
                    listener.settimeout(max(0.1, deadline - time.monotonic()))
                    try:
                        conn, _ = listener.accept()
                    except (socket.timeout, TimeoutError):
                        missing = self.world - 1 - len(self._conns)
                        raise ConnectionError(
                            f"{missing} multihost peer(s) never connected "
                            f"within {connect_timeout:.0f}s (set "
                            "FQTOOL_TPU_CONNECT_TIMEOUT to extend)")
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    r = _recv(conn)
                    self._conns[r] = conn
            return
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.reduce_port), timeout=10)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        # the connect timeout must not persist: rank 0 legitimately takes
        # minutes between gather and broadcast (it merges every output
        # stream), and large gather sends can outlive 10s of kernel buffer
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send(self._sock, self.rank)

    # -- collectives ---------------------------------------------------
    def gather(self, obj) -> Optional[list]:
        """All ranks send; rank 0 returns the rank-ordered list, others None."""
        if self.rank == 0:
            out = [None] * self.world
            out[0] = obj
            for r, conn in self._conns.items():
                out[r] = _recv(conn)
            return out
        _send(self._sock, obj)
        return None

    def broadcast(self, obj=None):
        if self.rank == 0:
            for conn in self._conns.values():
                _send(conn, obj)
            return obj
        return _recv(self._sock)

    def barrier(self) -> None:
        self.gather(None)
        self.broadcast(None)

    # -- pack ownership ------------------------------------------------
    def owns(self, pack_idx: int) -> bool:
        return pack_idx % self.world == self.rank

    def iter_owned_se(self, path: str, unit_reads: int, phred64: bool,
                      batch_units: int = 1) -> Iterator[Tuple[int, object]]:
        """Yield ``(unit_idx, pack)`` covering this rank's owned write units.

        ``unit_reads`` is the write-unit quantum (pipeline/runner.py
        WRITE_UNIT) -- the ownership AND output-framing granularity; the
        planned path materializes up to ``batch_units`` consecutive owned
        units per yielded pack so device batches stay full-size."""
        from . import ingest
        plan = ingest.build_plan(self, [path], unit_reads)
        if plan is not None:
            yield from ingest.iter_planned_se(plan, self.rank, phred64,
                                              batch_units=batch_units)
            return
        # fallback: serial scan with ownership skips (strict 4-line FASTQ
        # could not be proven -- CR line endings, blank lines, stdin, or an
        # unsplittable gzip; semantics match the reference reader exactly).
        # Ownership is strided mod world, so units are yielded singly --
        # device batches shrink to one unit (correctness path, not fast path)
        rd = PackReader(path, unit_reads, phred64)
        gidx = 0
        while True:
            pack = rd.next_pack(skip=not self.owns(gidx))
            if pack is None:
                return
            if self.owns(gidx):
                yield gidx, pack
            gidx += 1

    def iter_owned_pe(self, path1: str, path2: str, interleaved: bool,
                      unit_reads: int, phred64: bool, batch_units: int = 1):
        """PE analog of :meth:`iter_owned_se`: yields
        ``(unit_idx, pack1, pack2)`` at write-unit ownership granularity,
        batching consecutive owned units on the planned path."""
        from . import ingest
        if interleaved:
            plan = ingest.build_plan(self, [path1], unit_reads,
                                     rec_per_unit=2)
            if plan is not None:
                yield from ingest.iter_planned_interleaved(
                    plan, self.rank, phred64, batch_units=batch_units)
                return
        else:
            plan = ingest.build_plan(self, [path1, path2], unit_reads)
            if plan is not None:
                yield from ingest.iter_planned_pe(
                    plan, self.rank, phred64, batch_units=batch_units)
                return
        if interleaved:
            # interleaved input is one stream: every rank parses every pack
            # (no per-side skip path exists), ownership only filters -- the
            # input stage does not scale with hosts in this mode
            it = iter_packs_paired(path1, path2, True, unit_reads, phred64)
            for gidx, (p1, p2) in enumerate(it):
                if self.owns(gidx):
                    yield gidx, p1, p2
            return
        # one decode thread per side, mirroring iter_packs_paired: R1 and R2
        # gzip inflation + tokenization run in parallel (zlib releases the
        # GIL); ownership skips still avoid matrix builds for foreign packs
        def side(path):
            rd = PackReader(path, unit_reads, phred64)

            def gen():
                g = 0
                try:
                    while True:
                        p = rd.next_pack(skip=not self.owns(g))
                        if p is None:
                            return
                        yield p
                        g += 1
                finally:
                    rd.close()
            return prefetch_iter(gen(), depth=2)

        it1, it2 = side(path1), side(path2)
        gidx = 0
        try:
            while True:
                p1 = next(it1, None)
                p2 = next(it2, None)
                if p1 is None or p2 is None:
                    return
                n = min(p1.count, p2.count)
                if n == 0:
                    return
                mismatch = p1.count != p2.count
                if self.owns(gidx):
                    if mismatch:
                        yield (gidx, _truncate_pack(p1, n),
                               _truncate_pack(p2, n))
                        return  # shorter stream exhausted (fqreader.cpp:254-267)
                    yield gidx, p1, p2
                elif mismatch:
                    return
                gidx += 1
        finally:
            it1.close()
            it2.close()

    # -- output parts ----------------------------------------------------
    def part_writer(self, final_path: str,
                    compression: int = 3) -> "PartStreamWriter":
        return PartStreamWriter(final_path, self.rank, compression)

    def merge_stream(self, final_path: str, compression: int,
                     indexes_by_rank: List[list]) -> None:
        """Rank 0: concatenate all hosts' part files in global write-unit
        order -- final bytes identical to the single-process run.

        For .gz streams the parts already hold each unit's deflate blocks in
        the single-process framing (every write-unit is a block boundary,
        io/fastq.py::OutputWriter.write), so the merge is pure byte copying
        plus one combined CRC -- the serial recompression tail the round-2
        design had is gone.  Raw streams concatenate as before."""
        gz = final_path.endswith(".gz")
        paths = [_part_path(final_path, r) for r in range(self.world)]
        entries = sorted(
            (pidx, r, entry)
            for r, idx in enumerate(indexes_by_rank) for pidx, *entry in idx)
        handles: dict = {}

        def handle(r):
            h = handles.get(r)
            if h is None:
                if not os.path.exists(paths[r]):
                    raise FastqIOError(
                        f"multihost merge: missing part file {paths[r]} "
                        "(all ranks must write to a shared filesystem)")
                h = handles[r] = open(paths[r], "rb")
            return h

        try:
            if gz:
                crc = 0
                size = 0
                d = os.path.dirname(os.path.abspath(final_path))
                os.makedirs(d, exist_ok=True)
                with open(final_path, "wb", buffering=1 << 20) as out:
                    out.write(_GZIP_HEADER)
                    for _pidx, r, (comp_len, pcrc, raw_len) in entries:
                        out.write(handle(r).read(comp_len))
                        crc = _crc32_combine(crc, pcrc, raw_len)
                        size += raw_len
                    out.write(zlib.compressobj(
                        compression, zlib.DEFLATED, -15).flush(zlib.Z_FINISH))
                    out.write(struct.pack("<II", crc & 0xFFFFFFFF,
                                          size & 0xFFFFFFFF))
            else:
                with OutputWriter(final_path, compression) as w:
                    for _pidx, r, (ln,) in entries:
                        w.write(handle(r).read(ln))
        finally:
            for h in handles.values():
                h.close()
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)


    def merge_split_stream(self, final_path: str, compression: int,
                           indexes_by_rank: List[list], assign: List[int],
                           nfiles: int, name_fn) -> None:
        """Rank 0: route per-pack spans into numbered split files.

        ``assign[pack_idx]`` is the split-file number from
        pipeline/runner.py::replay_split_rotation (monotone non-decreasing,
        so iterating files in order walks every rank's part file strictly
        forward); ``name_fn(k)`` names file ``k``.  Every file 0..nfiles-1
        is created -- files with no packs come out empty, matching
        SplitWriter's open/close and the --split_file_number fill
        (reference: src/threadconfig.cpp:107-137)."""
        gz = final_path.endswith(".gz")
        paths = [_part_path(final_path, r) for r in range(self.world)]
        entries = sorted(
            (pidx, r, entry)
            for r, idx in enumerate(indexes_by_rank) for pidx, *entry in idx)
        handles: dict = {}

        def handle(r):
            h = handles.get(r)
            if h is None:
                if not os.path.exists(paths[r]):
                    raise FastqIOError(
                        f"multihost merge: missing part file {paths[r]} "
                        "(all ranks must write to a shared filesystem)")
                h = handles[r] = open(paths[r], "rb")
            return h

        try:
            pos = 0
            for k in range(nfiles):
                path = name_fn(k)
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
                with open(path, "wb", buffering=1 << 20) as out:
                    if gz:
                        out.write(_GZIP_HEADER)
                        crc = 0
                        size = 0
                        while pos < len(entries) and \
                                assign[entries[pos][0]] == k:
                            _pidx, r, (comp_len, pcrc, raw_len) = entries[pos]
                            out.write(handle(r).read(comp_len))
                            crc = _crc32_combine(crc, pcrc, raw_len)
                            size += raw_len
                            pos += 1
                        out.write(zlib.compressobj(
                            compression, zlib.DEFLATED, -15).flush(zlib.Z_FINISH))
                        out.write(struct.pack("<II", crc & 0xFFFFFFFF,
                                              size & 0xFFFFFFFF))
                    else:
                        while pos < len(entries) and \
                                assign[entries[pos][0]] == k:
                            _pidx, r, (ln,) = entries[pos]
                            out.write(handle(r).read(ln))
                            pos += 1
        finally:
            for h in handles.values():
                h.close()
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)


def drain_stream_errors() -> list:
    """Malformed-input messages this rank's planned-ingest materializer saw
    (for the end-of-stream gather payload)."""
    from . import ingest
    return ingest.drain_stream_errors()


def surface_stream_errors(gathered, key: str = "errs") -> None:
    """Rank 0: re-print peers' malformed-input messages so the error cannot
    scroll past in one worker's log while rank 0 exits clean (ADVICE r4)."""
    for rnk, pl in enumerate(gathered):
        if rnk and isinstance(pl, dict) and pl.get(key):
            for m in pl[key]:
                sys.stderr.write(f"[multihost rank {rnk}] {m}\n")


def _part_path(final_path: str, rank: int) -> str:
    return f"{final_path}.mh{rank}.part"


class PartStreamWriter:
    """Per-host part file for one output stream, used by the rank-0 merge.

    .gz streams: each pack's records are deflated HERE, during the run, on
    the shared pool, with the single-process block framing (BS-sized
    Z_FULL_FLUSH blocks per pack write); the manifest carries
    ``(pack, compressed_len, crc32, raw_len)`` so the merge is pure
    concatenation.  Raw streams store records as-is with ``(pack, len)``."""

    def __init__(self, final_path: str, rank: int, compression: int = 3):
        self.final_path = final_path
        self.part_path = _part_path(final_path, rank)
        self.compress = final_path.endswith(".gz")
        self.level = compression
        d = os.path.dirname(os.path.abspath(self.part_path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(self.part_path, "wb", buffering=1 << 20)
        self.index: List[tuple] = []
        self._pending: List[tuple] = []  # (pack_idx, crc, raw_len, [futures])

    def _drain(self, block: bool) -> None:
        while self._pending and (block or self._pending[0][3][-1].done()):
            pidx, crc, raw_len, futs = self._pending.pop(0)
            comp = b"".join(f.result() for f in futs)
            self._fh.write(comp)
            self.index.append((pidx, len(comp), crc, raw_len))

    def write(self, pack_idx: int, data: bytes) -> None:
        if not data:
            return
        if not self.compress:
            self._fh.write(data)
            self.index.append((pack_idx, len(data)))
            return
        view = memoryview(data)
        futs = [shared_pool().submit(_deflate_block,
                                     bytes(view[lo:lo + _DEFLATE_BLOCK]),
                                     self.level)
                for lo in range(0, len(data), _DEFLATE_BLOCK)]
        self._pending.append((pack_idx, zlib.crc32(data), len(data), futs))
        self._drain(block=False)

    def close(self) -> None:
        self._drain(block=True)
        self._fh.close()
