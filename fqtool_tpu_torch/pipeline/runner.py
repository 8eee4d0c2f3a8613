"""Host-side processing runtime: the single-end runner and the helpers both
runners share.

Copied from ``fqtool_tpu/pipeline/runner.py`` (which imports JAX at module
level): the failed-stream tag catalog, the chunk-size buckets, the pack and
write-unit framing, the packed-transport encoding of the prefetch thread
(``encode_packs``, ``resolve_enc``), the pipelined drain of dispatched
chunks, the cross-pack overlap switch (``submit_and_emit``), the device
split switch (``maybe_enable_sharding``), the index
filter, the split-output writer, the split rotation replay and the log line,
and ``SingleEndRunner`` whose fold, ORA sampling (deferred in multi-host
runs), adapter/polyG/polyX accounting, failed stream, multi-host runs
(``_run_mh``, ``_run_mh_split``; dist/multihost.py) and reports are
unchanged.  Its
dispatch uploads each chunk, on the raw, packed or 5-bit transport, and runs
the port's ``se_pipeline`` on one torch device or split across several
(dist/sharding.py), with no padded rows.  Output record order is always
input order (the reference run with one worker thread).
"""

from __future__ import annotations

import os
import sys
import time
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from ..config.options import Options
from ..dist.sharding import dispatch_on
from ..host import report_json
from ..host.duplicate import DuplicateTable
from ..host.filterresult import FilterResultAccumulator
from ..host.profile import device_profile
from ..host.stats import StatsAccumulator
from ..host.tracing import stage
from ..host.umi import process_umi
from ..io.fastq import (AsyncWriter, OutputWriter, ReadPack,
                        format_selected, prefetch_iter)
from ..ops.filters import FAILED_TYPES
from .se import se_pipeline, se_pipeline_packed, se_pipeline_packed5

# tag catalog for failed-stream suffixes: one buffer + per-code offsets
_TAG_BUF = b"".join(t.encode() for t in FAILED_TYPES)
_TAG_LEN = np.array([len(t) for t in FAILED_TYPES], np.int32)
_TAG_OFF = np.zeros(len(FAILED_TYPES), np.int64)
np.cumsum(_TAG_LEN[:-1], out=_TAG_OFF[1:])


def failed_tags(results: np.ndarray):
    """(buf, off, len) tag triple for format_selected from result codes."""
    return _TAG_BUF, _TAG_OFF[results], _TAG_LEN[results]


# chunks dispatched on each transport ("raw", "b8", "b5") since the last
# reset; read by the tests and chip_smoke.py
transport_chunks: Counter = Counter()


def encode_packs(it, device="cuda"):
    """Generator stage run inside the prefetch thread: attach the packed
    transport encoding (ops/packed.py) to every ReadPack flowing through,
    when the link probe to ``device`` enables packing (host/linkprobe.py).
    The encode pass is independent of the host prep (UMI rewrites names
    only; the index filter reads names only), so it overlaps the previous
    pack's fold.

    The resolved ``pack.enc`` is a mode tuple: ``("b5", packed, dict32)``
    when FQTOOL_TPU_PACKED5 is not 0 and the pack's (base, qual) alphabet
    fits the 5-bit dictionary transport (ops/packed.py::encode5_host), else
    ``("b8", enc)``; None when the content is unencodable."""
    from ..host.linkprobe import use_packed
    from ..io.fastq import shared_pool
    from ..ops.packed import encode5_host, encode_host

    b5_ok = os.environ.get("FQTOOL_TPU_PACKED5", "1") == "1"

    def enc_one(p):
        with stage("pack_encode"):
            enc = encode_host(p.seq, p.qual)
            if enc is None:
                return None
            if b5_ok:
                e5 = encode5_host(enc)
                if e5 is not None:
                    return ("b5",) + e5
            return ("b8", enc)

    it = iter(it)
    while True:
        # thread-side stage totals: tokenize = gunzip+parse+pack build,
        # pack_encode = packed-transport LUT pass (both overlap the main loop)
        with stage("tokenize"):
            item = next(it, None)
        if item is None:
            return
        if use_packed(device):
            packs = (item,) if isinstance(item, ReadPack) else item
            for p in packs:
                if isinstance(p, ReadPack):
                    # encode on the shared pool: overlaps the next pack's
                    # tokenize; the dispatcher resolves the future
                    p.enc = shared_pool().submit(enc_one, p)
        yield item


def resolve_enc(pack) -> None:
    """Materialize a pack's in-flight transport encoding (see encode_packs)."""
    if pack.enc is not None and hasattr(pack.enc, "result"):
        pack.enc = pack.enc.result()


def maybe_enable_sharding(devices: List[torch.device]) -> List[torch.device]:
    """The devices a run's chunks are split across: all of ``devices`` when
    there are two or more (disable with FQTOOL_TPU_SHARD=0), else the first.
    Local devices only: in multi-host runs each host computes its own packs
    on its own devices and only statistics cross hosts
    (dist/multihost.py)."""
    if os.environ.get("FQTOOL_TPU_SHARD", "1") == "0" or len(devices) < 2:
        return list(devices[:1])
    loginfo(f"data-parallel over {len(devices)} devices")
    return list(devices)


def submit_and_emit(items, submit, emit) -> None:
    """``emit(submit(item))`` for each item in order.  With
    FQTOOL_TPU_PACK_OVERLAP=1 (opt-in, as in fqtool_tpu) item k+1 is
    submitted before item k is emitted, so its chunks run on the device while
    the host fetches and folds item k; the chunks of one item are dispatched
    before the first is fetched either way."""
    overlap = os.environ.get("FQTOOL_TPU_PACK_OVERLAP", "0") == "1"
    in_flight = None
    for item in items:
        submitted = submit(item)
        if not overlap:
            emit(submitted)
            continue
        if in_flight is not None:
            emit(in_flight)
        in_flight = submitted
    if in_flight is not None:
        emit(in_flight)


def drain_pipelined(pending):
    """Iterate dispatched chunks ``(..., call)`` yielding ``(..., out)`` with
    chunk k+1's device->host fetch running in a background thread while the
    caller folds chunk k."""
    if len(pending) <= 1:
        for item in pending:
            yield item[:-1] + (item[-1].get(),)
        return
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(pending[0][-1].get)
        for k, item in enumerate(pending):
            out = fut.result()
            if k + 1 < len(pending):
                fut = ex.submit(pending[k + 1][-1].get)
            yield item[:-1] + (out,)
    finally:
        # join the in-flight fetch even on error/abandonment: the
        # non-daemon worker would otherwise block interpreter exit
        ex.shutdown(wait=True)


# Fixed device batch sizes: a pack's chunks all use one of these row counts
# (fqtool_tpu sizes its compiled programs by them; kept so that the chunk
# boundaries, and with them the output framing, are the same here)
SE_CHUNK = int(os.environ.get("FQTOOL_TPU_SE_CHUNK", "65536"))
_BUCKETS = (256, 2048, 8192, 16384, 32768)
# Write unit: the input-record quantum at which output streams are
# deflate-framed (each unit an independent run of deflate blocks) and, in
# multi-host runs, the quantum of pack ownership, as in fqtool_tpu, so the
# gzip bytes agree with its runs and with any world size
WRITE_UNIT = int(os.environ.get("FQTOOL_TPU_WRITE_UNIT", "16384"))


def main_pack_reads(opt) -> int:
    """Main-pass pack framing for SE runs: FQTOOL_TPU_SE_PACK_CHUNKS (default
    2) whole device chunks when split is off, so the device computes chunk
    k+1 while the host fetches and folds chunk k (pack size only shows in
    the output through split-file rotation).  Shared with main.py's
    head-cache activation so the pre-pass reader and the main pass agree on
    framing (io/headcache.py)."""
    pack_chunks = max(1, int(os.environ.get("FQTOOL_TPU_SE_PACK_CHUNKS", "2")))
    return (opt.buf_size.max_reads_in_pack if opt.split.enabled
            else SE_CHUNK * pack_chunks)


def main_write_unit(opt) -> int:
    """Records per write unit for SE runs: WRITE_UNIT when the pack framing
    is unit-aligned, else the whole pack."""
    pack_reads = main_pack_reads(opt)
    return WRITE_UNIT if pack_reads % WRITE_UNIT == 0 else pack_reads


def unit_bounds_for(count: int, unit: int) -> List[int]:
    """Row offsets [0, unit, 2*unit, ..., count] splitting a pack whose first
    row sits on a unit boundary."""
    bounds = list(range(0, count, unit))
    bounds.append(count)
    return bounds


def chunk_rows(pack_total: int, cap: int) -> int:
    """Device batch size for a pack of ``pack_total`` rows: ``cap`` for packs
    larger than every bucket, else the smallest bucket that holds them."""
    for b in _BUCKETS:
        if pack_total <= b and b <= cap:
            return b
    return cap


def prefetched(packs):
    """``packs`` read one ahead in a prefetch thread (io/fastq.py), with each
    wait of the main loop for the next item timed as stage ``input_wait``."""
    it = prefetch_iter(packs)
    while True:
        with stage("input_wait"):
            item = next(it, None)
        if item is None:
            return
        yield item


def loginfo(msg: str) -> None:
    sys.stderr.write(time.strftime("[%H:%M:%S] ") + msg + "\n")


def index_filter_matches(opt, pack, blacklist) -> np.ndarray:
    """Vectorized per-read blacklist match of firstIndex()
    (reference: src/filter.cpp:213-232)."""
    from ..host.names import (first_index_batch, index_match_batch,
                                       name_matrix)

    nb, no, nl = pack.name_arrays()
    mat = name_matrix(nb, no, nl)
    s, t = first_index_batch(mat, nl)
    return index_match_batch(blacklist, mat, s, t, opt.index_filter.threshold)


def split_file_name(opt: Options, base: str, k: int) -> str:
    """Numbered split-file path ``<k+1 zero-padded>.<basename>``
    (reference: src/threadconfig.cpp:88-105)."""
    num = str(k + 1)
    if opt.split.digits > 0:
        num = num.zfill(opt.split.digits)
    d = os.path.dirname(base)
    return os.path.join(d, num + "." + os.path.basename(base)) if d \
        else num + "." + os.path.basename(base)


def replay_split_rotation(opt: Options, counts: List[tuple]):
    """Replay :class:`SplitWriter`'s rotation state machine over the global
    pack sequence without any output bytes.

    ``counts`` is the ordered per-pack ``(input_count, read_passed)`` list;
    returns ``(assign, nfiles)`` where ``assign[i]`` is the split-file
    number pack ``i``'s records land in and ``nfiles`` includes the empty
    files --split_file_number fills at close (threadconfig.cpp:107-137).
    Used by the multi-host merge: ranks report their owned packs' counts and
    rank 0 routes each pack's pre-deflated spans to the same numbered file
    the single-process run would have written."""
    assign = []
    working = 0
    cur = 0
    for count, read_passed in counts:
        assign.append(working)
        cur += read_passed if opt.split.by_file_lines else count
        if cur >= opt.split.size:
            if opt.split.by_file_lines or working + 1 < opt.split.number:
                working += 1
                cur = 0
    nfiles = working + 1
    if opt.split.by_file_number:
        nfiles = max(nfiles, opt.split.number)
    return assign, nfiles


class SplitWriter:
    """Split-output writer emulating ThreadConfig's rotation for a single
    worker (reference: src/threadconfig.cpp:88-137).  Matches the reference
    byte-for-byte when it runs with one worker thread."""

    def __init__(self, opt: Options, paired: bool):
        self.opt = opt
        self.paired = paired
        self.working_split = 0
        self.current_reads = 0
        self.w1: Optional[OutputWriter] = None
        self.w2: Optional[OutputWriter] = None
        self._open()

    def _name(self, base: str) -> str:
        return split_file_name(self.opt, base, self.working_split)

    def _open(self) -> None:
        if not self.opt.out1:
            return
        if self.w1:
            self.w1.close()
        if self.w2:
            self.w2.close()
        self.w1 = OutputWriter(self._name(self.opt.out1), self.opt.compression)
        self.w2 = (OutputWriter(self._name(self.opt.out2), self.opt.compression)
                   if self.paired and self.opt.out2 else None)

    def write(self, data1: bytes, data2: bytes = b"") -> None:
        if self.w1:
            self.w1.write(data1)
        if self.w2:
            self.w2.write(data2)

    def mark_processed(self, n: int) -> None:
        """reference: src/threadconfig.cpp:107-127.

        Our runner is always a single deterministic worker, so `-w` is a
        performance hint only: split rotation always follows the reference's
        one-worker behavior (sequential file numbering; with -s, excess reads
        accumulate in the last file since number % 1 == 0 never stops the
        worker).
        """
        self.current_reads += n
        opt = self.opt
        if self.current_reads >= opt.split.size:
            if opt.split.by_file_lines or self.working_split + 1 < opt.split.number:
                self.working_split += 1
                self._open()
                self.current_reads = 0

    def close(self) -> None:
        # write empty files to honor --split_file_number
        # (threadconfig.cpp:131-137)
        if self.opt.split.by_file_number:
            while self.working_split + 1 < self.opt.split.number:
                self.working_split += 1
                self._open()
                self.current_reads = 0
        if self.w1:
            self.w1.close()
        if self.w2:
            self.w2.close()


class SingleEndRunner:
    def __init__(self, opt: Options, devices=("cuda",)):
        self.opt = opt
        # the run's local devices, and those its chunks go to (the first, or
        # all of them once maybe_enable_sharding splits the chunks)
        self.local_devices = [torch.device(d) for d in devices]
        self.devices = self.local_devices[:1]
        self.params = opt.kernel_params(is_r2=False)
        self.pre_stats = self._make_stats()
        self.post_stats = self._make_stats()
        self.filter_result = FilterResultAccumulator(opt, paired=False)
        self.dup = (DuplicateTable(opt.duplicate.keylen, opt.duplicate.hist_size)
                    if opt.duplicate.enabled else None)
        self._pre_counter = 0
        self._post_counter = 0
        # multi-host: post-filter ORA sampling is deferred until the global
        # passing-prefix counts are known (host/ora_defer.py)
        self._ora_post_defer = None
        self._rows = 0  # device batch size, locked at the first pack
        # global stream index of the current pack's first record (multi-host
        # runs; None = single-host, dup table keeps its own local counter)
        self._record_base = None
        self.adapter_r1 = self._effective_adapter()

    def _make_stats(self) -> StatsAccumulator:
        opt = self.opt
        return StatsAccumulator(
            evaluated_seq_len=opt.est.seq_len1,
            kmer_len=opt.kmer.kmer_len if opt.kmer.enabled else 0,
            over_rep_sampling=opt.over_rep.sampling if opt.over_rep.enabled else 0,
            over_rep_seqs=opt.over_rep.over_rep_seq_count_r1,
        )

    def _effective_adapter(self) -> bytes:
        # SE trimming only uses an explicitly provided adapter
        # (seprocessor.cpp:321-323)
        if self.opt.adapter.enable_trimming and self.opt.adapter.adapter_seq_r1_provided:
            return self.opt.adapter.input_adapter_seq_r1.encode()
        return b""

    # ------------------------------------------------------------------
    def run(self) -> None:
        opt = self.opt
        from ..dist import multihost
        mh = multihost.active()
        if mh is not None:
            self._run_mh(mh)
            return
        self.devices = maybe_enable_sharding(self.local_devices)
        split = SplitWriter(opt, paired=False) if opt.split.enabled else None
        out_writer = (AsyncWriter(opt.out1, opt.compression)
                      if opt.out1 and not opt.split.enabled else None)
        failed_writer = (AsyncWriter(opt.failed_out, opt.compression)
                         if opt.failed_out else None)

        pack_reads = main_pack_reads(opt)
        unit = main_write_unit(opt)
        total = 0

        def emit(pack):
            nonlocal total
            if split is not None:
                # split rotation consumes whole packs
                outstr, failedstr, read_passed = self.complete_pack(pack)
                total += pack[0].count
                with stage("se_emit"):
                    split.write(outstr)
                    split.mark_processed(read_passed if opt.split.by_file_lines
                                         else pack[0].count)
                    if failed_writer is not None:
                        failed_writer.write(failedstr)
                return
            bounds = unit_bounds_for(pack[0].count, unit)
            outstrs, failedstrs, _ = self.complete_pack(pack, bounds)
            total += pack[0].count
            # the hand-off to the writers, a wait on a full queue included
            with stage("se_emit"):
                if out_writer is not None:
                    for s in outstrs:
                        out_writer.write(s)
                if failed_writer is not None:
                    for s in failedstrs:
                        failed_writer.write(s)

        from ..io.headcache import iter_packs_cached
        with device_profile(self.devices):
            submit_and_emit(prefetched(encode_packs(
                iter_packs_cached(opt.in1, pack_reads, opt.phred64),
                self.devices[0])), self.submit_pack, emit)
        loginfo(f"processed {total} reads")

        with stage("writer_close"):
            if split is not None:
                split.close()
            if out_writer is not None:
                out_writer.close()
            if failed_writer is not None:
                failed_writer.close()
        with stage("reports"):
            self.write_reports()

    def _run_mh(self, mh) -> None:
        """Multi-host run: process owned packs, write pack-indexed part
        files, reduce accumulators to rank 0, which merges the output streams
        and writes the reports (dist/multihost.py)."""
        from ..dist import multihost
        opt = self.opt
        if opt.split.enabled:
            self._run_mh_split(mh)
            return
        self.devices = maybe_enable_sharding(self.local_devices)
        writers = {}
        if opt.out1:
            writers["out1"] = mh.part_writer(opt.out1, opt.compression)
        if opt.failed_out:
            writers["failed"] = mh.part_writer(opt.failed_out, opt.compression)
        pack_reads = main_pack_reads(opt)
        unit = main_write_unit(opt)
        batch_units = max(1, pack_reads // unit)
        if opt.over_rep.enabled:
            from ..host.ora_defer import DeferredOraSampler
            self._ora_post_defer = DeferredOraSampler(
                opt.over_rep.sampling, self.post_stats)
        for u_lo, pack in prefetched(encode_packs(
                mh.iter_owned_se(opt.in1, unit, opt.phred64, batch_units),
                self.devices[0])):
            # ORA pre-sampling strides over the GLOBAL stream order; units
            # are fixed-size so the base index is unit_idx * unit.  (Post
            # sampling is deferred to the global replay below.)
            self._pre_counter = u_lo * unit
            self._record_base = u_lo * unit
            bounds = unit_bounds_for(pack.count, unit)
            outstrs, failedstrs, _ = self.complete_pack(
                self.submit_pack(pack), bounds)
            with stage("se_emit"):
                for j, (s, f) in enumerate(zip(outstrs, failedstrs)):
                    if "out1" in writers:
                        writers["out1"].write(u_lo + j, s)
                    if "failed" in writers:
                        writers["failed"].write(u_lo + j, f)
        with stage("writer_close"):
            for w in writers.values():
                w.close()
        loginfo(f"SE processing finished (rank {mh.rank}/{mh.world})")
        from ..host import tracing
        tracing.mark("stream_done")
        if self._ora_post_defer is not None:
            from ..host.ora_defer import exchange_and_replay
            exchange_and_replay(mh, [self._ora_post_defer])
        payload = dict(
            pre=self.pre_stats, post=self.post_stats, fr=self.filter_result,
            dup=None if self.dup is None else self.dup.payload(),
            errs=multihost.drain_stream_errors(),
            idx={name: w.index for name, w in writers.items()})
        gathered = mh.gather(payload)
        tracing.mark("gather_done")
        if mh.rank == 0:
            multihost.surface_stream_errors(gathered)
            self._merge_gathered(gathered)
            for name, w in writers.items():
                mh.merge_stream(w.final_path, opt.compression,
                                [pl["idx"].get(name, []) for pl in gathered])
            tracing.mark("merge_done")
            with stage("reports"):
                self.write_reports()
        mh.barrier()

    def _run_mh_split(self, mh) -> None:
        """Multi-host split (`-s`/`-S`) run.

        Ownership quantum = the split pack size (rotation happens between
        packs in the single-process path), each rank deflates its owned
        packs' output with the per-pack framing SplitWriter uses, and rank 0
        replays the rotation state machine over the gathered global
        ``(count, read_passed)`` sequence to route every pack's spans to the
        same numbered file -- bytes identical to the single-process run
        (reference rotation: src/threadconfig.cpp:88-137)."""
        from ..dist import multihost
        opt = self.opt
        self.devices = maybe_enable_sharding(self.local_devices)
        pack_reads = main_pack_reads(opt)
        w_split = mh.part_writer(opt.out1, opt.compression) if opt.out1 else None
        w_failed = (mh.part_writer(opt.failed_out, opt.compression)
                    if opt.failed_out else None)
        if opt.over_rep.enabled:
            from ..host.ora_defer import DeferredOraSampler
            self._ora_post_defer = DeferredOraSampler(
                opt.over_rep.sampling, self.post_stats)
        rotation = {}
        for gidx, pack in prefetched(encode_packs(
                mh.iter_owned_se(opt.in1, pack_reads, opt.phred64, 1),
                self.devices[0])):
            self._pre_counter = gidx * pack_reads
            self._record_base = gidx * pack_reads
            outstr, failedstr, read_passed = self.complete_pack(
                self.submit_pack(pack))
            rotation[gidx] = (pack.count, read_passed)
            with stage("se_emit"):
                if w_split is not None:
                    w_split.write(gidx, outstr)
                if w_failed is not None:
                    w_failed.write(gidx, failedstr)
        with stage("writer_close"):
            for w in (w_split, w_failed):
                if w is not None:
                    w.close()
        loginfo(f"SE split processing finished (rank {mh.rank}/{mh.world})")
        from ..host import tracing
        tracing.mark("stream_done")
        if self._ora_post_defer is not None:
            from ..host.ora_defer import exchange_and_replay
            exchange_and_replay(mh, [self._ora_post_defer])
        payload = dict(
            pre=self.pre_stats, post=self.post_stats, fr=self.filter_result,
            dup=None if self.dup is None else self.dup.payload(),
            rot=rotation,
            errs=multihost.drain_stream_errors(),
            idx={name: w.index for name, w in
                 (("out1", w_split), ("failed", w_failed)) if w is not None})
        gathered = mh.gather(payload)
        tracing.mark("gather_done")
        if mh.rank == 0:
            multihost.surface_stream_errors(gathered)
            self._merge_gathered(gathered)
            rot: dict = {}
            for pl in gathered:
                rot.update(pl["rot"])
            counts = [rot[i] for i in sorted(rot)]
            assign, nfiles = replay_split_rotation(opt, counts)
            if w_split is not None:
                mh.merge_split_stream(
                    opt.out1, opt.compression,
                    [pl["idx"].get("out1", []) for pl in gathered],
                    assign, nfiles,
                    lambda k: split_file_name(opt, opt.out1, k))
            if w_failed is not None:
                mh.merge_stream(
                    opt.failed_out, opt.compression,
                    [pl["idx"].get("failed", []) for pl in gathered])
            tracing.mark("merge_done")
            with stage("reports"):
                self.write_reports()
        mh.barrier()

    def _merge_gathered(self, gathered) -> None:
        """Rank 0: fold the other ranks' accumulators into this runner's."""
        for pl in gathered[1:]:
            self.pre_stats.merge(pl["pre"])
            self.post_stats.merge(pl["post"])
            self.filter_result.merge(pl["fr"])
            if self.dup is not None and pl["dup"] is not None:
                self.dup.merge_payload(pl["dup"])

    # ------------------------------------------------------------------
    def submit_pack(self, pack: ReadPack):
        """Host prep (index filter, UMI) + dispatch of every device chunk;
        returns a handle for :meth:`complete_pack`."""
        opt = self.opt
        B = pack.count
        with stage("se_prep"):
            resolve_enc(pack)
            keep = np.ones(B, bool)
            if opt.index_filter.enabled:
                keep = ~index_filter_matches(opt, pack, opt.index_filter.blacklist1)
            start0, _ = process_umi(opt, pack)

        with stage("se_dispatch"):
            return self._dispatch(pack, start0, keep)

    def _dispatch(self, pack, start0, keep):
        opt = self.opt
        B = pack.count
        # the chunk size of fqtool_tpu's runner, locked at the first pack, so
        # that chunks agree with its runs
        if not self._rows:
            self._rows = chunk_rows(B, SE_CHUNK)
        rows = self._rows
        kw = dict(p=self.params, adapter_r1=self.adapter_r1,
                  use_start0=bool(opt.umi.enabled),
                  with_kmer=bool(opt.kmer.enabled))
        # packed transport: the encoding is attached to the pack by
        # encode_packs in the prefetch thread (link-probe gated); None when
        # packing is off or the content is unencodable
        enc = pack.enc
        mode = "raw" if enc is None else enc[0]
        pending = []  # one (rows, handle) per chunk, for drain_pipelined
        lo = 0
        while lo < B:
            hi = min(lo + rows, B)
            rest = (pack.lens[lo:hi], start0[lo:hi], keep[lo:hi])
            if mode == "b5":
                call = dispatch_on(self.devices, se_pipeline_packed5,
                                   (enc[1][lo:hi],) + rest, aux=(enc[2],),
                                   enc_width=pack.seq.shape[1], **kw)
            elif mode == "b8":
                call = dispatch_on(self.devices, se_pipeline_packed,
                                   (enc[1][lo:hi],) + rest, **kw)
            else:
                call = dispatch_on(self.devices, se_pipeline,
                                   (pack.seq[lo:hi], pack.qual[lo:hi]) + rest,
                                   **kw)
            transport_chunks[mode] += 1
            pending.append((hi - lo, call))
            lo = hi
        return pack, start0, keep, pending

    def _drain_chunks(self, pending) -> dict:
        """Collect dispatched chunk outputs; fold stats/dup, concatenate the
        per-read arrays."""
        merged: dict = {}
        base = self._record_base
        drain = drain_pipelined(pending)
        while True:
            with stage("se_device_wait"):
                item = next(drain, None)
            if item is None:
                break
            n, out = item
            with stage("se_fold"):
                with stage("se_fold_stats"):
                    self.pre_stats.add_batch(out.pop("pre"))
                    self.post_stats.add_batch(out.pop("post"))
                    if "pre_kmer" in out:
                        self.pre_stats.add_kmer(out.pop("pre_kmer"))
                    if "post_kmer" in out:
                        self.post_stats.add_kmer(out.pop("post_kmer"))
                if self.dup is not None:
                    with stage("se_fold_dup"):
                        d = out.pop("dup")
                        self.dup.add_batch(d.key, d.kmer_hi, d.kmer_lo, d.gc,
                                           d.valid, key_hi=d.key_hi, base=base)
            if base is not None:
                base += n
            for k, v in out.items():
                merged.setdefault(k, []).append(v)
        return {k: (np.concatenate(v) if len(v) > 1 else v[0])
                for k, v in merged.items()}

    def complete_pack(self, submitted, unit_bounds: Optional[List[int]] = None):
        """Drain a submitted pack and build its output strings.

        ``unit_bounds=None``: outstr/failedstr are single byte strings (the
        whole pack).  With bounds (row offsets, see :func:`unit_bounds_for`)
        they are per-write-unit LISTS -- each unit's bytes are written as an
        independent deflate framing (see WRITE_UNIT)."""
        pack, start0, keep, pending = submitted
        out = self._drain_chunks(pending)
        with stage("se_fold"):
            return self._fold(pack, start0, keep, out, unit_bounds)

    def _fold(self, pack, start0, keep, out, unit_bounds):
        """Report accumulators, ORA sampling and the output records of one
        drained pack."""
        opt = self.opt
        result = np.asarray(out["result"])
        passed = np.asarray(out["passed"])
        front = np.asarray(out["front"])
        rlen = np.asarray(out["rlen"])
        dropped = np.asarray(out["dropped"])
        select_pass = passed & keep
        with stage("se_fold_count"):
            self._count(pack, keep, out, front, result, select_pass, rlen)

        # output strings ------------------------------------------------
        def per_unit(select, *fmt_args, **fmt_kw):
            if unit_bounds is None:
                return format_selected(pack, select, *fmt_args, **fmt_kw)
            units = []
            for lo, hi in zip(unit_bounds, unit_bounds[1:]):
                m = np.zeros_like(select)
                m[lo:hi] = select[lo:hi]
                units.append(format_selected(pack, m, *fmt_args, **fmt_kw))
            return units

        with stage("se_fold_route"):
            outstr = per_unit(select_pass, front, rlen)
            failedstr = b"" if unit_bounds is None else \
                [b""] * (len(unit_bounds) - 1)
            if opt.failed_out:
                # the reference trims reads IN PLACE (trimAndCut returns the
                # same object, filter.cpp:186-188), so the failed stream
                # carries the fully trimmed read -- except for dropped reads
                # (trimAndCut returned NULL before mutating), which stay at
                # their post-UMI original content (seprocessor.cpp:346-348)
                select_fail = keep & ~passed
                f_start = np.where(dropped, start0, front).astype(np.int32)
                f_len = np.where(dropped, np.asarray(pack.lens) - start0,
                                 rlen).astype(np.int32)
                failedstr = per_unit(select_fail, f_start, f_len,
                                     tags=failed_tags(result))
        return outstr, failedstr, int(select_pass.sum())

    def _count(self, pack, keep, out, front, result, select_pass, rlen) -> None:
        """The report's counters of one drained pack: filter results, polyG,
        polyX and adapter trims, ORA sampling."""
        opt = self.opt
        B = pack.count

        # filter-fate counters: index-filtered reads never count
        # (seprocessor.cpp:304-307)
        self.filter_result.add_filter_results(result[keep], n_each=1)

        # polyG / polyX trim events ------------------------------------
        if "polyg_trimmed" in out:
            m = np.asarray(out["polyg_trimmed"]) & keep
            self.filter_result.add_polyx_trimmed(
                np.full(B, 3), np.asarray(out["polyg_trim_len"]), m)
        if "polyx_trimmed" in out:
            m = np.asarray(out["polyx_trimmed"]) & keep
            self.filter_result.add_polyx_trimmed(
                np.asarray(out["polyx_base"]), np.asarray(out["polyx_trim_len"]), m)

        # adapter trim events (bulk np.unique counting, host/accounting.py)
        if "adapter_found" in out:
            from ..host.accounting import span_counts, suffix_counts
            found = np.asarray(out["adapter_found"]) & keep
            pos = np.asarray(out["adapter_pos"]).astype(np.int64)
            before = np.asarray(out["len_after_polyg"]).astype(np.int64)
            idx = np.flatnonzero(found)
            p = pos[idx]
            neg, posi = idx[p < 0], idx[p >= 0]
            counts = suffix_counts(self.adapter_r1, -pos[neg])
            counts += span_counts(pack.seq, posi, front[posi] + pos[posi],
                                  before[posi] - pos[posi])
            self.filter_result.add_adapter_trimmed_bulk(counts, is_r2=False)

        if not opt.over_rep.enabled:
            return
        # ORA sampling: every sampling-th read in stream order
        # (stats.cpp:246-248); only the selected rows touch Python
        sampling = opt.over_rep.sampling
        for i in range(-self._pre_counter % sampling, B, sampling):
            self.pre_stats.add_over_rep_read(
                pack.seq[i, : pack.lens[i]].tobytes())
        self._pre_counter += B
        passing = np.flatnonzero(select_pass)
        if self._ora_post_defer is not None:
            # multi-host: the global passing prefix is unknown until end
            # of stream -- spool the passing sequences and replay later
            # (host/ora_defer.py)
            from ..host.ora_defer import ragged_gather
            self._ora_post_defer.add_interval(
                self._record_base,
                ragged_gather(pack.seq, passing, front[passing],
                              rlen[passing]),
                rlen[passing])
        else:
            for k in range(-self._post_counter % sampling,
                           len(passing), sampling):
                i = passing[k]
                s, n = int(front[i]), int(rlen[i])
                self.post_stats.add_over_rep_read(
                    pack.seq[i, s : s + n].tobytes())
            self._post_counter += len(passing)

    # ------------------------------------------------------------------
    def write_reports(self) -> None:
        opt = self.opt
        dup_hist = dup_gc = None
        dup_rate = 0.0
        if self.dup is not None:
            dup_hist, dup_gc, dup_rate = self.dup.stat_all()
        report = report_json.build_report(
            opt, self.filter_result, self.pre_stats, self.post_stats,
            dup_hist=dup_hist, dup_mean_gc=dup_gc, dup_rate=dup_rate)
        report_json.write_report(opt.json_file, report)
        from ..host import report_html
        report_html.write_report(opt, self.filter_result, self.pre_stats,
                                 self.post_stats, None, None,
                                 dup_hist, dup_gc, dup_rate, None, 0)
