"""Pair-end host runtime.

Counterpart of ``fqtool_tpu/pipeline/pe_runner.py``: drives the port's
``pe_pipeline`` over pair packs on one torch device and reproduces the output
routing of ``PairEndProcessor::processPairEnd`` (reference:
src/peprocessor.cpp:261-508).  ``complete_pack``, the fold, the routing
(merge, correction patches, adapter and polyG/polyX accounting), the record
formatters, the multi-host runs (``_run_mh``, ``_run_mh_split``, deferred ORA
sampling and global record numbering; dist/multihost.py) and
``write_reports`` are copied from the JAX runner.  ``submit_pack`` slices each
pack into the same device chunks as the JAX runner, uploads them and
dispatches the pipeline, so records, split files and gzip framing match the
JAX CLI byte for byte.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.options import Options
from ..host import report_json
from ..host.duplicate import DuplicateTable
from ..host.filterresult import FilterResultAccumulator
from ..host.stats import StatsAccumulator
from ..host.tracing import stage
from ..host.umi import process_umi
from ..io.fastq import (AsyncWriter, ReadPack, format_array_records,
                        format_plane_array_records)
from ..ops.filters import PASS_FILTER
from .pe import pe_pipeline_call
from .runner import (_TAG_BUF, _TAG_LEN, _TAG_OFF, SplitWriter, chunk_rows,
                     drain_pipelined, index_filter_matches, loginfo, prefetched)

# extended tag catalog: the fail-reason names plus the PE mate-fail tag
_XTAG_BUF = _TAG_BUF + b"paired_read_is_failing"
_PAIRED_OFF = len(_TAG_BUF)
_PAIRED_LEN = len(b"paired_read_is_failing")

PE_CHUNK = int(os.environ.get("FQTOOL_TPU_PE_CHUNK", "16384"))


def main_pack_reads(opt) -> int:
    """Main-pass pack framing for PE runs: several device chunks per pack
    when split is off; all chunks of a pack are dispatched before the first
    result is fetched.  Shared with main.py's head-cache activation so the
    pre-pass reader and the main pass agree on framing (io/headcache.py)."""
    pack_chunks = max(1, int(os.environ.get("FQTOOL_TPU_PE_PACK_CHUNKS", "2")))
    return (opt.buf_size.max_reads_in_pack if opt.split.enabled
            else min(opt.buf_size.max_reads_in_pack,
                     PE_CHUNK * pack_chunks))


def main_write_unit(opt) -> int:
    """Pairs per write unit: the chunk size when the pack framing and the
    chunk-size buckets align with it (complete_pack's grouping must never
    see a chunk straddling a unit boundary); otherwise the whole pack."""
    pack_reads = main_pack_reads(opt)
    if pack_reads % PE_CHUNK == 0 and PE_CHUNK % 8192 == 0:
        return PE_CHUNK
    return pack_reads


def pipeline_args(opt: Options) -> dict:
    """The keyword arguments of ``pe_pipeline`` that the options decide: the
    by-sequence fallback's adapters (only those given explicitly,
    peprocessor.cpp:319-324), the UMI shift, k-mers, --discard_unmerged."""
    ad = opt.adapter
    return dict(
        adapter_r1=(ad.input_adapter_seq_r1.encode()
                    if ad.enable_trimming and ad.adapter_seq_r1_provided else b""),
        adapter_r2=(ad.input_adapter_seq_r2.encode()
                    if ad.enable_trimming and ad.adapter_seq_r2_provided else b""),
        use_start0=bool(opt.umi.enabled), with_kmer=bool(opt.kmer.enabled),
        discard_unmerged=bool(opt.merge_pe.discard_unmerged))


# complement LUT for host-side merged-read assembly
_COMP_LUT = np.full(256, ord("N"), np.uint8)
for _s, _d in ((65, 84), (97, 84), (84, 65), (116, 65),
               (67, 71), (99, 71), (71, 67), (103, 67)):
    _COMP_LUT[_s] = _d


def _apply_patches(mat_s: np.ndarray, mat_q: np.ndarray, pos: np.ndarray,
                   new_s: np.ndarray, new_q: np.ndarray, front: np.ndarray) -> None:
    """Apply sparse per-read correction patches in place (pos is in
    front-aligned coordinates; -1 slots unused)."""
    valid = pos >= 0
    if not valid.any():
        return
    n, k = pos.shape
    rows = np.broadcast_to(np.arange(n)[:, None], (n, k))[valid]
    cols = (front[:, None] + pos)[valid]
    mat_s[rows, cols] = new_s[valid]
    mat_q[rows, cols] = new_q[valid]


def _assemble_merged(mat1s, mat1q, mat2s, mat2q, front1, front2, rlen2,
                     ol, len1, len2, sel=None):
    """Host-side merged-read construction (overlapanalysis.cpp:74-104):
    merged = r1[0:len1] ++ revcomp(r2)[ol : ol+len2].  Native row-copy for
    the selected rows when available; numpy row gathers otherwise."""
    from ..io import native

    n = mat1s.shape[0]
    mlen = len1 + len2
    Wm = max(int(mlen.max(initial=1)), 1)
    if sel is not None:
        got = native.assemble_merged(mat1s, mat1q, mat2s, mat2q, sel,
                                     front1, front2, rlen2, ol, len1, len2, Wm)
        if got is not None:
            return got
    pos = np.arange(Wm, dtype=np.int32)[None, :]
    from1 = pos < len1[:, None]
    idx1 = np.clip(front1[:, None] + pos, 0, mat1s.shape[1] - 1)
    # second part: merged[i] = revcomp(r2)[ol + i - len1]
    #            = complement(r2[rlen2 - 1 - (ol + i - len1)])
    j2 = rlen2[:, None] - 1 - (ol[:, None] + pos - len1[:, None])
    idx2 = np.clip(front2[:, None] + j2, 0, mat2s.shape[1] - 1)
    part1_s = np.take_along_axis(mat1s, idx1, axis=1)
    part1_q = np.take_along_axis(mat1q, idx1, axis=1)
    part2_s = _COMP_LUT[np.take_along_axis(mat2s, idx2, axis=1)]
    part2_q = np.take_along_axis(mat2q, idx2, axis=1)
    return (np.where(from1, part1_s, part2_s).astype(np.uint8),
            np.where(from1, part1_q, part2_q).astype(np.uint8))


class PairEndRunner:
    def __init__(self, opt: Options, device="cuda"):
        self.opt = opt
        self.device = torch.device(device)
        self.p1 = opt.kernel_params(is_r2=False)
        self.p2 = opt.kernel_params(is_r2=True)
        self.pre1 = self._make_stats(False)
        self.pre2 = self._make_stats(True)
        self.post1 = self._make_stats(False)
        self.post2 = self._make_stats(True)
        self.filter_result = FilterResultAccumulator(opt, paired=True)
        self.dup = (DuplicateTable(opt.duplicate.keylen, opt.duplicate.hist_size)
                    if opt.duplicate.enabled else None)
        self.insert_hist = np.zeros(opt.insert_size_max + 1, np.int64)
        self._pre_counter = 0
        self._post1_counter = 0
        self._post2_counter = 0
        # multi-host: post-filter ORA sampling deferred until global passing
        # prefixes are known (host/ora_defer.py)
        self._ora_post1_defer = None
        self._ora_post2_defer = None
        self._rows = 0  # device batch size, locked at the first pack
        # global stream index of the current pack's first pair (multi-host
        # runs; None = single-host, dup table keeps its own local counter)
        self._record_base = None
        self.args = pipeline_args(opt)
        self.adapter_r1 = self.args["adapter_r1"]
        self.adapter_r2 = self.args["adapter_r2"]

    def _make_stats(self, is_r2: bool) -> StatsAccumulator:
        opt = self.opt
        return StatsAccumulator(
            evaluated_seq_len=opt.est.seq_len2 if is_r2 else opt.est.seq_len1,
            kmer_len=opt.kmer.kmer_len if opt.kmer.enabled else 0,
            over_rep_sampling=opt.over_rep.sampling if opt.over_rep.enabled else 0,
            over_rep_seqs=(opt.over_rep.over_rep_seq_count_r2 if is_r2
                           else opt.over_rep.over_rep_seq_count_r1),
        )

    # ------------------------------------------------------------------
    def run(self) -> None:
        opt = self.opt
        from ..dist import multihost
        mh = multihost.active()
        if mh is not None:
            self._run_mh(mh)
            return
        split = SplitWriter(opt, paired=True) if opt.split.enabled else None
        w_out1 = (AsyncWriter(opt.out1, opt.compression)
                  if opt.out1 and not opt.split.enabled else None)
        w_out2 = (AsyncWriter(opt.out2, opt.compression)
                  if opt.out2 and not opt.split.enabled else None)
        w_unpaired1 = AsyncWriter(opt.unpaired1, opt.compression) if opt.unpaired1 else None
        w_unpaired2 = None
        if opt.unpaired2 and opt.unpaired2 != opt.unpaired1:
            w_unpaired2 = AsyncWriter(opt.unpaired2, opt.compression)
        w_merged = (AsyncWriter(opt.merge_pe.out, opt.compression)
                    if opt.merge_pe.enabled and opt.merge_pe.out else None)
        w_failed = AsyncWriter(opt.failed_out, opt.compression) if opt.failed_out else None

        pack_reads = main_pack_reads(opt)
        unit = main_write_unit(opt)
        total = 0

        def emit(submitted):
            nonlocal total
            if split is not None:
                # split rotation consumes whole packs
                r = self.complete_pack(submitted,
                                       has_unpaired1=w_unpaired1 is not None,
                                       want_failed=w_failed is not None)
                total += submitted[0].count
                split.write(r["out1"], r["out2"])
                split.mark_processed(
                    r["read_passed"] if opt.split.by_file_lines
                    else submitted[0].count)
                for w, k in ((w_unpaired1, "unpaired1"),
                             (w_unpaired2, "unpaired2"),
                             (w_merged, "merged"), (w_failed, "failed")):
                    if w is not None:
                        w.write(r[k])
                return
            r = self.complete_pack(submitted,
                                   has_unpaired1=w_unpaired1 is not None,
                                   want_failed=w_failed is not None,
                                   unit_reads=unit)
            total += submitted[0].count
            # pair output requires BOTH writers (peprocessor.cpp:469-475):
            # with only -o and no -O, passing pairs go nowhere
            if w_out1 is not None and w_out2 is not None:
                for s in r["out1"]:
                    w_out1.write(s)
                for s in r["out2"]:
                    w_out2.write(s)
            for w, k in ((w_unpaired1, "unpaired1"), (w_unpaired2, "unpaired2"),
                         (w_merged, "merged"), (w_failed, "failed")):
                if w is not None:
                    for s in r[k]:
                        w.write(s)

        from ..io.headcache import iter_packs_paired_cached
        for pack1, pack2 in prefetched(iter_packs_paired_cached(
                opt.in1, opt.in2, opt.interleaved_input, pack_reads, opt.phred64)):
            emit(self.submit_pack(pack1, pack2))
        loginfo(f"processed {total} read pairs")

        with stage("writer_close"):
            for w in (split, w_out1, w_out2, w_unpaired1, w_unpaired2,
                      w_merged, w_failed):
                if w is not None:
                    w.close()
        self.write_reports()

    def _run_mh(self, mh) -> None:
        """Multi-host run: process owned pair packs, write pack-indexed part
        files per output stream, reduce accumulators to rank 0, which merges
        the streams and writes the reports (dist/multihost.py)."""
        from ..dist import multihost
        opt = self.opt
        if opt.split.enabled:
            self._run_mh_split(mh)
            return
        # out1's stream exists whenever -o is given (an empty file when -O is
        # missing, peprocessor.cpp:54-61); pair routing still needs BOTH
        # (peprocessor.cpp:469-475)
        route_pairs = bool(opt.out1 and opt.out2)
        streams = [("out1", opt.out1),
                   ("out2", opt.out2 if route_pairs else None),
                   ("unpaired1", opt.unpaired1),
                   ("unpaired2", opt.unpaired2
                    if opt.unpaired2 and opt.unpaired2 != opt.unpaired1 else None),
                   ("merged", opt.merge_pe.out
                    if opt.merge_pe.enabled and opt.merge_pe.out else None),
                   ("failed", opt.failed_out)]
        writers = {name: mh.part_writer(path, opt.compression)
                   for name, path in streams if path}
        pack_reads = main_pack_reads(opt)
        unit = main_write_unit(opt)
        batch_units = max(1, pack_reads // unit)
        self._make_ora_defer(opt)
        for u_lo, pack1, pack2 in prefetched(mh.iter_owned_pe(
                opt.in1, opt.in2, opt.interleaved_input,
                unit, opt.phred64, batch_units)):
            self._pre_counter = u_lo * unit
            self._record_base = u_lo * unit
            r = self.complete_pack(self.submit_pack(pack1, pack2),
                                   has_unpaired1=opt.unpaired1 != "",
                                   want_failed=opt.failed_out != "",
                                   unit_reads=unit)
            for name, w in writers.items():
                if name in ("out1", "out2") and not route_pairs:
                    continue
                for j, s in enumerate(r[name]):
                    w.write(u_lo + j, s)
        with stage("writer_close"):
            for w in writers.values():
                w.close()
        loginfo(f"PE processing finished (rank {mh.rank}/{mh.world})")
        from ..host import tracing
        tracing.mark("stream_done")
        self._replay_ora_defer(mh)
        payload = dict(
            pre1=self.pre1, pre2=self.pre2, post1=self.post1, post2=self.post2,
            fr=self.filter_result, insert_hist=self.insert_hist,
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
            self.write_reports()
        mh.barrier()

    def _run_mh_split(self, mh) -> None:
        """Multi-host split (`-s`/`-S`) PE run: per-pack ownership and
        output framing, rank-0 rotation replay routing out1/out2 spans to
        numbered files; the non-split streams (unpaired/merged/failed) merge
        as single streams with the same per-pack framing the single-process
        split path writes them with (see SingleEndRunner._run_mh_split)."""
        from ..dist import multihost
        from .runner import replay_split_rotation, split_file_name
        opt = self.opt
        pack_reads = main_pack_reads(opt)
        split_streams = [("out1", opt.out1), ("out2", opt.out2)]
        plain_streams = [
            ("unpaired1", opt.unpaired1),
            ("unpaired2", opt.unpaired2
             if opt.unpaired2 and opt.unpaired2 != opt.unpaired1 else None),
            ("merged", opt.merge_pe.out
             if opt.merge_pe.enabled and opt.merge_pe.out else None),
            ("failed", opt.failed_out)]
        writers = {name: mh.part_writer(path, opt.compression)
                   for name, path in split_streams + plain_streams if path}
        self._make_ora_defer(opt)
        rotation = {}
        for gidx, pack1, pack2 in prefetched(mh.iter_owned_pe(
                opt.in1, opt.in2, opt.interleaved_input,
                pack_reads, opt.phred64, 1)):
            self._pre_counter = gidx * pack_reads
            self._record_base = gidx * pack_reads
            r = self.complete_pack(self.submit_pack(pack1, pack2),
                                   has_unpaired1=opt.unpaired1 != "",
                                   want_failed=opt.failed_out != "")
            rotation[gidx] = (pack1.count, r["read_passed"])
            for name, w in writers.items():
                w.write(gidx, r[name])
        with stage("writer_close"):
            for w in writers.values():
                w.close()
        loginfo(f"PE split processing finished (rank {mh.rank}/{mh.world})")
        from ..host import tracing
        tracing.mark("stream_done")
        self._replay_ora_defer(mh)
        payload = dict(
            pre1=self.pre1, pre2=self.pre2, post1=self.post1, post2=self.post2,
            fr=self.filter_result, insert_hist=self.insert_hist,
            dup=None if self.dup is None else self.dup.payload(),
            rot=rotation,
            errs=multihost.drain_stream_errors(),
            idx={name: w.index for name, w in writers.items()})
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
            for name, w in writers.items():
                idx = [pl["idx"].get(name, []) for pl in gathered]
                if name in ("out1", "out2"):
                    base = opt.out1 if name == "out1" else opt.out2
                    mh.merge_split_stream(
                        w.final_path, opt.compression, idx, assign, nfiles,
                        lambda k, b=base: split_file_name(opt, b, k))
                else:
                    mh.merge_stream(w.final_path, opt.compression, idx)
            tracing.mark("merge_done")
            self.write_reports()
        mh.barrier()

    def _merge_gathered(self, gathered) -> None:
        """Rank 0: fold the other ranks' accumulators into this runner's."""
        for pl in gathered[1:]:
            self.pre1.merge(pl["pre1"])
            self.pre2.merge(pl["pre2"])
            self.post1.merge(pl["post1"])
            self.post2.merge(pl["post2"])
            self.filter_result.merge(pl["fr"])
            self.insert_hist += pl["insert_hist"]
            if self.dup is not None and pl["dup"] is not None:
                self.dup.merge_payload(pl["dup"])

    def _make_ora_defer(self, opt) -> None:
        if opt.over_rep.enabled:
            from ..host.ora_defer import DeferredOraSampler
            self._ora_post1_defer = DeferredOraSampler(
                opt.over_rep.sampling, self.post1)
            self._ora_post2_defer = DeferredOraSampler(
                opt.over_rep.sampling, self.post2)

    def _replay_ora_defer(self, mh) -> None:
        if self._ora_post1_defer is not None:
            from ..host.ora_defer import exchange_and_replay
            exchange_and_replay(
                mh, [self._ora_post1_defer, self._ora_post2_defer])

    # ------------------------------------------------------------------
    def submit_pack(self, pack1: ReadPack, pack2: ReadPack):
        """Host prep (index filter, UMI offsets) + dispatch of every device
        chunk; returns a handle for :meth:`complete_pack`."""
        opt = self.opt
        B = pack1.count
        keep = np.ones(B, bool)
        if opt.index_filter.enabled:
            keep = ~(index_filter_matches(opt, pack1, opt.index_filter.blacklist1)
                     | index_filter_matches(opt, pack2, opt.index_filter.blacklist2))
        start1, start2 = process_umi(opt, pack1, pack2)

        if not self._rows:
            # the chunk size of fqtool_tpu's runner (its TPU working-set cap
            # included), so that chunks -- and the output framing -- agree
            width = max(pack1.width, pack2.width)
            cap = PE_CHUNK
            while cap > 256 and cap * width * 24 > (1 << 31):
                cap //= 2
            self._rows = chunk_rows(B, cap)
        rows = self._rows
        # dispatch every chunk, then fold in order: the device runs ahead on
        # later chunks while the host fetches/folds earlier ones
        pending = []
        lo = 0
        while lo < B:
            hi = min(lo + rows, B)
            n = hi - lo
            with stage("pe_dispatch"):
                call = pe_pipeline_call(
                    (pack1.seq[lo:hi], pack1.qual[lo:hi], pack1.lens[lo:hi],
                     pack2.seq[lo:hi], pack2.qual[lo:hi], pack2.lens[lo:hi],
                     start1[lo:hi], start2[lo:hi], keep[lo:hi]),
                    self.device, p=self.p1, p2=self.p2, **self.args)
                pending.append((lo, n, call))
            lo = hi
        return pack1, pack2, keep, start1, start2, pending

    def complete_pack(self, submitted, has_unpaired1: bool,
                      want_failed: bool,
                      unit_reads: Optional[int] = None) -> dict:
        """Drain a submitted pair pack and build its output strings.

        ``unit_reads=None``: each stream is one byte string (the whole
        pack).  With a unit size, each stream is a LIST of per-write-unit
        byte strings (unit j = input rows [j*unit, (j+1)*unit) of the pack),
        so single-process and multi-host gz framing agree (see
        pipeline/runner.py WRITE_UNIT).  Device chunks never straddle a unit
        boundary: the locked chunk size is <= PE_CHUNK and unit_reads is
        either a PE_CHUNK multiple or the whole pack."""
        pack1, pack2, keep, start1, start2, pending = submitted
        opt = self.opt
        streams = ("out1", "out2", "unpaired1", "unpaired2", "merged", "failed")
        chunks: List[Tuple[int, dict]] = []  # (row lo, per-stream segments)
        read_passed = 0
        merged_count = 0
        drain = drain_pipelined(pending)
        while True:
            with stage("pe_device_wait"):
                item = next(drain, None)
            if item is None:
                break
            lo, n, out = item
            parts: dict = {k: [] for k in streams}
            with stage("pe_fold"):
                rp, mc = self._fold_chunk(out, pack1, pack2, lo, n, keep, start1, start2,
                                      parts, has_unpaired1, want_failed)
            chunks.append((lo, parts))
            read_passed += rp
            merged_count += mc

        if opt.merge_pe.enabled:
            self.filter_result.add_merged_pairs(merged_count)

        def join(segs) -> bytes:
            return b"".join(x.result() if hasattr(x, "result") else x
                            for x in segs)

        if unit_reads is None:
            r = {k: join(s for _, parts in chunks for s in parts[k])
                 for k in streams}
        else:
            n_units = max(1, -(-pack1.count // unit_reads))
            r = {}
            for k in streams:
                units = [[] for _ in range(n_units)]
                for lo, parts in chunks:
                    units[lo // unit_reads].extend(parts[k])
                r[k] = [join(u) for u in units]
        return r | {"read_passed": read_passed}

    # ------------------------------------------------------------------
    def _fold_chunk(self, out, pack1, pack2, lo, n, keep, start1, start2,
                    parts, has_unpaired1, want_failed):
        opt = self.opt
        # stats --------------------------------------------------------
        self.pre1.add_batch(out["pre1"])
        self.pre2.add_batch(out["pre2"])
        for key, acc in (("pre1_kmer", self.pre1), ("pre2_kmer", self.pre2),
                         ("post1_kmer", self.post1), ("post2_kmer", self.post2),
                         ("postM_kmer", self.post1)):
            if key in out:
                acc.add_kmer(out[key])
        self.post1.add_batch(out["post1"])
        self.post2.add_batch(out["post2"])
        if "postM" in out:
            self.post1.add_batch(out["postM"])
        if self.dup is not None:
            d = out["dup"]
            valid = np.asarray(d.valid).copy()
            valid[n:] = False
            self.dup.add_batch(
                np.asarray(d.key), np.asarray(d.kmer_hi),
                np.asarray(d.kmer_lo), np.asarray(d.gc), valid,
                key_hi=None if d.key_hi is None else np.asarray(d.key_hi),
                base=None if self._record_base is None
                else self._record_base + lo)

        kchunk = keep[lo : lo + n]
        result1 = np.asarray(out["result1"])[:n]
        result2 = np.asarray(out["result2"])[:n]
        front1 = np.asarray(out["front1"])[:n]
        front2 = np.asarray(out["front2"])[:n]
        rlen1 = np.asarray(out["rlen1"])[:n]
        rlen2 = np.asarray(out["rlen2"])[:n]
        dropped1 = np.asarray(out["dropped1"])[:n]
        dropped2 = np.asarray(out["dropped2"])[:n]
        both = ~dropped1 & ~dropped2

        # content matrices: pack slices, patched in place with the sparse
        # correction diffs (device coordinates are front-aligned, so host
        # column = front + pos); base offsets stay in pack coordinates
        if "corr_pos1" in out:
            with stage("pe_fold_patch"):
                mat1s = pack1.seq[lo : lo + n].copy()
                mat1q = pack1.qual[lo : lo + n].copy()
                mat2s = pack2.seq[lo : lo + n].copy()
                mat2q = pack2.qual[lo : lo + n].copy()
                _apply_patches(mat1s, mat1q, np.asarray(out["corr_pos1"])[:n],
                               np.asarray(out["corr_seq1"])[:n],
                               np.asarray(out["corr_qual1"])[:n], front1)
                _apply_patches(mat2s, mat2q, np.asarray(out["corr_pos2"])[:n],
                               np.asarray(out["corr_seq2"])[:n],
                               np.asarray(out["corr_qual2"])[:n], front2)
        else:
            mat1s = pack1.seq[lo : lo + n]
            mat1q = pack1.qual[lo : lo + n]
            mat2s = pack2.seq[lo : lo + n]
            mat2q = pack2.qual[lo : lo + n]
        base1 = front1
        base2 = front2
        mats = (mat1s, mat1q, mat2s, mat2q)

        def content1(i, start, length):
            return mat1s[i, start : start + length].tobytes(), \
                mat1q[i, start : start + length].tobytes()

        def content2(i, start, length):
            return mat2s[i, start : start + length].tobytes(), \
                mat2q[i, start : start + length].tobytes()

        # insert size --------------------------------------------------
        if "isize" in out:
            isz = np.asarray(out["isize"])[:n]
            vmask = np.asarray(out["isize_valid"])[:n] & kchunk
            self.insert_hist += np.bincount(
                isz[vmask], minlength=len(self.insert_hist))

        # correction counters -----------------------------------------
        if "correction_matrix" in out:
            self.filter_result.add_correction(np.asarray(out["correction_matrix"]))
            c1 = np.asarray(out["corrected1"])[:n]
            c2 = np.asarray(out["corrected2"])[:n]
            # one per side with >=1 corrected base (basecorrector.cpp:62-68)
            self.filter_result.inc_corrected_reads(
                int(np.sum(c1 > 0) + np.sum(c2 > 0)))

        # polyG / polyX events ----------------------------------------
        for side in (1, 2):
            gk = f"polyg_trimmed{side}"
            if gk in out:
                m = np.asarray(out[gk])[:n] & kchunk
                self.filter_result.add_polyx_trimmed(
                    np.full(n, 3), np.asarray(out[f"polyg_trim_len{side}"])[:n], m)
            xk = f"polyx_trimmed{side}"
            if xk in out:
                m = np.asarray(out[xk])[:n] & kchunk
                self.filter_result.add_polyx_trimmed(
                    np.asarray(out[f"polyx_base{side}"])[:n],
                    np.asarray(out[f"polyx_trim_len{side}"])[:n], m)

        # adapter events (bulk np.unique counting, host/accounting.py) ---
        from ..host.accounting import span_counts, suffix_counts
        if "ov_trimmed" in out:
            ovm = np.asarray(out["ov_trimmed"])[:n] & kchunk
            lb1 = np.asarray(out["len1_before_ov_trim"])[:n].astype(np.int64)
            lb2 = np.asarray(out["len2_before_ov_trim"])[:n].astype(np.int64)
            la1 = np.asarray(out["len_after_adapter1"])[:n].astype(np.int64)
            rows = np.flatnonzero(ovm)
            ol = la1[rows]  # both trimmed to overlap length
            len_a1 = np.maximum(lb1[rows] - ol, 0)
            len_a2 = np.maximum(lb2[rows] - ol, 0)
            self.filter_result.add_adapter_trimmed_pairs_bulk(
                span_counts(mat1s, rows, base1[rows] + ol, len_a1),
                span_counts(mat2s, rows, base2[rows] + ol, len_a2),
                len(rows), int(len_a1.sum() + len_a2.sum()))
        for side, adapter in ((1, self.adapter_r1), (2, self.adapter_r2)):
            k = f"adapter_found{side}"
            if k in out:
                found = np.asarray(out[k])[:n] & kchunk
                pos = np.asarray(out[f"adapter_pos{side}"])[:n].astype(np.int64)
                # length before by-sequence trim == length before overlap trim
                # for non-ov-trimmed reads (the stage input length)
                lb = (np.asarray(out[f"len{side}_before_ov_trim"])[:n]
                      if f"len{side}_before_ov_trim" in out else
                      np.asarray(out[f"len_after_adapter{side}"])[:n]
                      ).astype(np.int64)
                mat = mat1s if side == 1 else mat2s
                basex = base1 if side == 1 else base2
                idx = np.flatnonzero(found)
                p = pos[idx]
                neg, posi = idx[p < 0], idx[p >= 0]
                counts = suffix_counts(adapter, -pos[neg])
                counts += span_counts(mat, posi, basex[posi] + pos[posi],
                                      lb[posi] - pos[posi])
                self.filter_result.add_adapter_trimmed_bulk(
                    counts, is_r2=(side == 2))

        # ORA pre sampling: every sampling-th pair in stream order; only the
        # selected rows touch Python (peprocessor.cpp:272-274)
        if opt.over_rep.enabled:
            sampling = opt.over_rep.sampling
            for i in range(-self._pre_counter % sampling, n, sampling):
                self.pre1.add_over_rep_read(
                    pack1.seq[lo + i, : pack1.lens[lo + i]].tobytes())
                self.pre2.add_over_rep_read(
                    pack2.seq[lo + i, : pack2.lens[lo + i]].tobytes())
            self._pre_counter += n

        # routing ------------------------------------------------------
        merge_on = opt.merge_pe.enabled
        discard_unmerged = opt.merge_pe.discard_unmerged
        if merge_on:
            mergeable = np.asarray(out["mergeable"])[:n]
            resultM = np.asarray(out["resultM"])[:n]
            m_rlen = np.asarray(out["merged_rlen"])[:n]
            m_len1 = np.asarray(out["merged_len1"])[:n]
            m_len2 = np.asarray(out["merged_len2"])[:n]
            # only rows actually written to the merged stream need content
            m_need = (both & mergeable & kchunk
                      & (resultM == PASS_FILTER))
            with stage("pe_fold_assemble"):
                m_seq, m_qual = _assemble_merged(
                    mat1s, mat1q, mat2s, mat2q, front1, front2, rlen2,
                    np.asarray(out["merged_ol"])[:n], m_len1, m_len2,
                    sel=m_need)

        sampling = opt.over_rep.sampling if opt.over_rep.enabled else 0
        read_passed = 0
        merged_count = 0
        fr = self.filter_result

        if not merge_on:
            # fast path: fully vectorized routing + native formatting
            return self._route_vectorized(
                mats, pack1, pack2, lo, n, kchunk, start1, start2,
                result1, result2, rlen1, rlen2, dropped1, dropped2,
                front1, front2, parts, has_unpaired1,
                want_failed, sampling), 0

        # vectorized merge routing: merged/unmerged records in pair order
        # via a 3-rows-per-pair interleave; non-processed pairs (a NULL
        # side, or unmergeable under --discard_unmerged) fall through to
        # the standard routing (peprocessor.cpp:350-428)
        m_proc = both & (mergeable | (not discard_unmerged))
        pass1v = ~dropped1 & (result1 == PASS_FILTER)
        pass2v = ~dropped2 & (result2 == PASS_FILTER)
        m_sel = both & mergeable & kchunk
        fr.add_filter_results(resultM[m_sel], n_each=2)
        m_written = m_sel & (resultM == PASS_FILTER)
        m_unm = both & ~mergeable & (not discard_unmerged) & kchunk
        fr.add_filter_results(result1[m_unm], n_each=1)
        fr.add_filter_results(result2[m_unm], n_each=1)
        merged_count = int(m_written.sum())
        read_passed = merged_count + int((m_unm & pass1v & pass2v).sum())

        # ORA post sampling over the merged stream in emit order: merged
        # reads and unmerged-kept r1 advance the post1 counter, unmerged-kept
        # r2 the post2 counter (peprocessor.cpp:361-379)
        idx1 = np.flatnonzero(m_written | (m_unm & pass1v))
        idx2 = np.flatnonzero(m_unm & pass2v)
        if sampling:
            if self._ora_post1_defer is not None:
                # multi-host: spool the merged-stream emit order (merged read
                # content or unmerged-kept r1) for the deferred global replay
                from ..host.ora_defer import place_segments, ragged_gather
                key = self._record_base + lo
                mmask = m_written[idx1]
                lens1 = np.where(mmask, m_rlen[idx1],
                                 rlen1[idx1]).astype(np.int64)
                flat1 = np.empty(int(lens1.sum()), np.uint8)
                offs = np.cumsum(lens1) - lens1
                im, iu = idx1[mmask], idx1[~mmask]
                place_segments(flat1, offs[mmask],
                               ragged_gather(m_seq, im,
                                             np.zeros(len(im), np.int64),
                                             m_rlen[im]),
                               m_rlen[im])
                place_segments(flat1, offs[~mmask],
                               ragged_gather(mat1s, iu, base1[iu], rlen1[iu]),
                               rlen1[iu])
                self._ora_post1_defer.add_interval(key, flat1, lens1)
                self._ora_post2_defer.add_interval(
                    key, ragged_gather(mat2s, idx2, base2[idx2], rlen2[idx2]),
                    rlen2[idx2])
            else:
                for k in range(-self._post1_counter % sampling, len(idx1),
                               sampling):
                    i = int(idx1[k])
                    if m_written[i]:
                        self.post1.add_over_rep_read(
                            m_seq[i, : m_rlen[i]].tobytes())
                    else:
                        self.post1.add_over_rep_read(
                            content1(i, base1[i], int(rlen1[i]))[0])
                for k in range(-self._post2_counter % sampling, len(idx2),
                               sampling):
                    i = int(idx2[k])
                    self.post2.add_over_rep_read(
                        content2(i, base2[i], int(rlen2[i]))[0])
        self._post1_counter += len(idx1)
        self._post2_counter += len(idx2)

        if m_written.any() or (m_unm & (pass1v | pass2v)).any():
            # format on the shared pool (native formatter releases the GIL):
            # overlaps the next chunk's fetch; every input is chunk-local or
            # immutable, and complete_pack resolves the future in order
            from ..io.fastq import shared_pool

            def fmt(args=(pack1, pack2, lo, n, m_written, m_unm & pass1v,
                          m_unm & pass2v, m_seq, m_qual, m_rlen, m_len1,
                          m_len2, mats, front1, front2, rlen1, rlen2)):
                with stage("pe_fold_format_merged"):
                    return self._format_merged_interleaved(*args)

            parts["merged"].append(shared_pool().submit(fmt))

        # in merge mode the fallthrough pairs never advance the post
        # counters (peprocessor.cpp:387-400 guard), hence sampling=0
        np_mask = kchunk & ~m_proc
        rp2 = self._route_vectorized(
            mats, pack1, pack2, lo, n, np_mask, start1, start2,
            result1, result2, rlen1, rlen2, dropped1, dropped2,
            front1, front2, parts, has_unpaired1,
            want_failed, 0)
        return read_passed + rp2, merged_count

    def _route_vectorized(self, mats, pack1, pack2, lo, n, kc, start1, start2,
                          result1, result2, rlen1, rlen2, dropped1, dropped2,
                          front1, front2, parts, has_unpaired1,
                          want_failed, sampling) -> int:
        """Vectorized non-merge routing (peprocessor.cpp:387-428) with native
        record formatting; returns read_passed."""
        fr = self.filter_result
        mat1s, mat1q, mat2s, mat2q = mats
        s1 = front1
        s2 = front2
        pass1 = ~dropped1 & (result1 == PASS_FILTER)
        pass2 = ~dropped2 & (result2 == PASS_FILTER)
        fr.add_filter_results(np.maximum(result1, result2)[kc], n_each=2)
        bothpass = kc & pass1 & pass2
        only1 = kc & pass1 & ~pass2
        only2 = kc & pass2 & ~pass1
        read_passed = int(bothpass.sum())

        nb1, no1, nl1 = pack1.name_arrays()
        sb1, so1, sl1 = pack1.strand_arrays()
        nb2, no2, nl2 = pack2.name_arrays()
        sb2, so2, sl2 = pack2.strand_arrays()
        no1c, nl1c = no1[lo : lo + n], nl1[lo : lo + n]
        so1c, sl1c = so1[lo : lo + n], sl1[lo : lo + n]
        no2c, nl2c = no2[lo : lo + n], nl2[lo : lo + n]
        so2c, sl2c = so2[lo : lo + n], sl2[lo : lo + n]

        if bothpass.any():
            parts["out1"].append(format_array_records(
                bothpass, nb1, no1c, nl1c, sb1, so1c, sl1c,
                mat1s, mat1q, s1, rlen1))
            parts["out2"].append(format_array_records(
                bothpass, nb2, no2c, nl2c, sb2, so2c, sl2c,
                mat2s, mat2q, s2, rlen2))
            if sampling:
                idx = np.flatnonzero(bothpass)
                if self._ora_post1_defer is not None:
                    from ..host.ora_defer import ragged_gather
                    key = self._record_base + lo
                    self._ora_post1_defer.add_interval(
                        key, ragged_gather(mat1s, idx, s1[idx], rlen1[idx]),
                        rlen1[idx])
                    self._ora_post2_defer.add_interval(
                        key, ragged_gather(mat2s, idx, s2[idx], rlen2[idx]),
                        rlen2[idx])
                else:
                    for k in range(-self._post1_counter % sampling, len(idx),
                                   sampling):
                        i = idx[k]
                        self.post1.add_over_rep_read(
                            mat1s[i, s1[i] : s1[i] + rlen1[i]].tobytes())
                    for k in range(-self._post2_counter % sampling, len(idx),
                                   sampling):
                        i = idx[k]
                        self.post2.add_over_rep_read(
                            mat2s[i, s2[i] : s2[i] + rlen2[i]].tobytes())
                self._post1_counter += len(idx)
                self._post2_counter += len(idx)

        if has_unpaired1:
            if only1.any():
                parts["unpaired1"].append(format_array_records(
                    only1, nb1, no1c, nl1c, sb1, so1c, sl1c,
                    mat1s, mat1q, s1, rlen1))
            if only2.any():
                parts["unpaired2"].append(format_array_records(
                    only2, nb2, no2c, nl2c, sb2, so2c, sl2c,
                    mat2s, mat2q, s2, rlen2))

        if want_failed and (only1.any() or only2.any()):
            parts["failed"].append(self._format_failed_interleaved(
                pack1, pack2, lo, n, only1, only2, has_unpaired1,
                result1, result2, rlen1, rlen2, dropped1, dropped2,
                start1, start2, s1, s2, mat1s, mat1q, mat2s, mat2q,
                nb1, no1c, nl1c, sb1, so1c, sl1c,
                nb2, no2c, nl2c, sb2, so2c, sl2c))
        return read_passed

    def _format_merged_interleaved(self, pack1, pack2, lo, n, selM, sel1, sel2,
                                   m_seq, m_qual, m_rlen, m_len1, m_len2,
                                   mats, base1, base2, rlen1, rlen2) -> bytes:
        """Merged-stream records in pair order: merged read OR the unmerged
        kept r1 then r2 (peprocessor.cpp:355-385), as one 3-rows-per-pair
        native plane-format call (content stays in the three source
        matrices; no interleaved copy)."""
        mat1s, mat1q, mat2s, mat2q = mats

        plane_id = np.tile(np.arange(3, dtype=np.uint8), n)
        row_idx = np.repeat(np.arange(n, dtype=np.int32), 3)

        starts = np.zeros(3 * n, np.int32)
        starts[1::3] = base1
        starts[2::3] = base2
        lens = np.empty(3 * n, np.int32)
        lens[0::3] = m_rlen
        lens[1::3] = rlen1
        lens[2::3] = rlen2

        # merged names: host-mangled for the selected pairs only, assembled
        # in bulk (ragged pieces + native span copy -- no per-read Python)
        idxs = np.flatnonzero(selM)
        mbuf_a, moff, mlens32 = _merged_names_bulk(
            pack1, lo + idxs, m_len1[idxs], m_len2[idxs])
        mbuf = mbuf_a.tobytes()
        mlens = mlens32.astype(np.int32)

        nb1, no1, nl1 = pack1.name_arrays()
        sb1, so1, sl1 = pack1.strand_arrays()
        nb2, no2, nl2 = pack2.name_arrays()
        sb2, so2, sl2 = pack2.strand_arrays()
        names_buf = mbuf + nb1 + nb2
        strands_buf = sb1 + sb2

        name_off = np.zeros(3 * n, np.int64)
        name_len = np.zeros(3 * n, np.int32)
        name_off[0::3][selM] = moff
        name_len[0::3][selM] = mlens
        name_off[1::3] = no1[lo : lo + n] + len(mbuf)
        name_len[1::3] = nl1[lo : lo + n]
        name_off[2::3] = no2[lo : lo + n] + len(mbuf) + len(nb1)
        name_len[2::3] = nl2[lo : lo + n]

        strand_off = np.zeros(3 * n, np.int64)
        strand_len = np.zeros(3 * n, np.int32)
        # merged reads use r1's strand (overlapanalysis.cpp:102)
        strand_off[0::3] = so1[lo : lo + n]
        strand_len[0::3] = sl1[lo : lo + n]
        strand_off[1::3] = so1[lo : lo + n]
        strand_len[1::3] = sl1[lo : lo + n]
        strand_off[2::3] = so2[lo : lo + n] + len(sb1)
        strand_len[2::3] = sl2[lo : lo + n]

        sel = np.zeros(3 * n, bool)
        sel[0::3] = selM
        sel[1::3] = sel1
        sel[2::3] = sel2

        return format_plane_array_records(
            sel, names_buf, name_off, name_len,
            strands_buf, strand_off, strand_len,
            [(m_seq, m_qual), (mat1s, mat1q), (mat2s, mat2q)],
            plane_id, row_idx, starts, lens)

    def _format_failed_interleaved(self, pack1, pack2, lo, n, only1, only2,
                                   has_up, result1, result2, rlen1, rlen2,
                                   dropped1, dropped2, start1, start2, s1, s2,
                                   mat1s, mat1q, mat2s, mat2q,
                                   nb1, no1c, nl1c, sb1, so1c, sl1c,
                                   nb2, no2c, nl2c, sb2, so2c, sl2c) -> bytes:
        """Failed-stream records in pair order (or1 line then or2 line,
        peprocessor.cpp:404-428) as one native plane-format call (content
        stays in the two source matrices; no interleaved copy)."""
        st1c = start1[lo : lo + n].astype(np.int32)
        st2c = start2[lo : lo + n].astype(np.int32)

        # row selections and tag codes
        r1_sel = (only1 & (not has_up)) | only2
        r2_sel = only1 | (only2 & (not has_up))
        # r1 tags: paired_read_is_failing | FAILED_TYPES[result2] (bug-compat,
        # peprocessor.cpp:420) | FAILED_TYPES[result1]
        tag_off1 = np.where(only1 & (not has_up), _PAIRED_OFF,
                            np.where(only2 & has_up, _TAG_OFF[result2],
                                     _TAG_OFF[result1])).astype(np.int64)
        tag_len1 = np.where(only1 & (not has_up), _PAIRED_LEN,
                            np.where(only2 & has_up, _TAG_LEN[result2],
                                     _TAG_LEN[result1])).astype(np.int32)
        tag_off2 = np.where(only1, _TAG_OFF[result2], _PAIRED_OFF).astype(np.int64)
        tag_len2 = np.where(only1, _TAG_LEN[result2], _PAIRED_LEN).astype(np.int32)

        plane_id = np.tile(np.arange(2, dtype=np.uint8), n)
        row_idx = np.repeat(np.arange(n, dtype=np.int32), 2)
        # dropped reads were never corrected (correction needs both sides
        # alive), so the pack-coordinate matrices already hold their original
        # post-UMI content; only the (start, len) spans differ below.

        starts = np.empty(2 * n, np.int32)
        lens = np.empty(2 * n, np.int32)
        starts[0::2] = np.where(dropped1, st1c, s1)
        lens[0::2] = np.where(dropped1,
                              np.asarray(pack1.lens[lo : lo + n]) - st1c, rlen1)
        starts[1::2] = np.where(dropped2, st2c, s2)
        lens[1::2] = np.where(dropped2,
                              np.asarray(pack2.lens[lo : lo + n]) - st2c, rlen2)

        names_buf = nb1 + nb2
        strands_buf = sb1 + sb2
        name_off = np.empty(2 * n, np.int64)
        name_len = np.empty(2 * n, np.int32)
        strand_off = np.empty(2 * n, np.int64)
        strand_len = np.empty(2 * n, np.int32)
        name_off[0::2] = no1c
        name_len[0::2] = nl1c
        name_off[1::2] = no2c + len(nb1)
        name_len[1::2] = nl2c
        strand_off[0::2] = so1c
        strand_len[0::2] = sl1c
        strand_off[1::2] = so2c + len(sb1)
        strand_len[1::2] = sl2c

        sel = np.empty(2 * n, bool)
        sel[0::2] = r1_sel
        sel[1::2] = r2_sel
        tag_off = np.empty(2 * n, np.int64)
        tag_len = np.empty(2 * n, np.int32)
        tag_off[0::2] = tag_off1
        tag_len[0::2] = tag_len1
        tag_off[1::2] = tag_off2
        tag_len[1::2] = tag_len2

        return format_plane_array_records(
            sel, names_buf, name_off, name_len,
            strands_buf, strand_off, strand_len,
            [(mat1s, mat1q), (mat2s, mat2q)],
            plane_id, row_idx, starts, lens,
            tags=(_XTAG_BUF, tag_off, tag_len))

    # ------------------------------------------------------------------
    def get_peak_insert_size(self) -> int:
        """reference: src/peprocessor.cpp:249-259 (first max wins)."""
        peak, max_count = 0, -1
        for i in range(self.opt.insert_size_max):
            if self.insert_hist[i] > max_count:
                peak = i
                max_count = int(self.insert_hist[i])
        return peak

    def write_reports(self) -> None:
        opt = self.opt
        dup_hist = dup_gc = None
        dup_rate = 0.0
        if self.dup is not None:
            dup_hist, dup_gc, dup_rate = self.dup.stat_all()
        peak = self.get_peak_insert_size()
        report = report_json.build_report(
            opt, self.filter_result, self.pre1, self.post1, self.pre2, self.post2,
            dup_hist=dup_hist, dup_mean_gc=dup_gc, dup_rate=dup_rate,
            insert_hist=self.insert_hist, insert_peak=peak)
        report_json.write_report(opt.json_file, report)
        from ..host import report_html
        report_html.write_report(opt, self.filter_result, self.pre1, self.post1,
                                 self.pre2, self.post2, dup_hist, dup_gc, dup_rate,
                                 self.insert_hist, peak)


def _ascii_ints(vals: np.ndarray, width: int = 7):
    """Decimal ASCII of non-negative ints, right-aligned in a [k, width]
    matrix; returns (matrix, per-row start, per-row digit count)."""
    vals = vals.astype(np.int64)
    mat = np.empty((len(vals), width), np.uint8)
    v = vals.copy()
    for c in range(width - 1, -1, -1):
        mat[:, c] = (v % 10) + 48
        v //= 10
    ndig = np.ones(len(vals), np.int64)
    t = 10
    for _ in range(width - 1):
        ndig += vals >= t
        t *= 10
    return mat, width - ndig, ndig


def _merged_names_bulk(pack, rows: np.ndarray, len1: np.ndarray,
                       len2: np.ndarray):
    """Vectorized ``fqtool_tpu.pipeline.pe_runner._merged_name`` (the
    reference's naming, overlapanalysis.cpp:94-101) over the selected rows: ragged pieces
    assembled with the native span copy -- no per-read Python.  Returns
    (flat uint8 buffer, per-row offsets int64, per-row lengths int64),
    replicating the scalar's slice semantics exactly (pos == 0 slices
    ``name[:-1]``; a name with no space keeps only the tag)."""
    from ..host.names import RaggedBuilder, name_matrix

    k = len(rows)
    if k == 0:
        z64 = np.zeros(0, np.int64)
        return np.zeros(0, np.uint8), z64, z64
    nb, no_all, nl_all = pack.name_arrays()
    no = no_all[rows].astype(np.int64)
    nl = nl_all[rows].astype(np.int64)
    mat = name_matrix(nb, no, nl)
    W = mat.shape[1]
    space = (mat == 32) & (np.arange(W)[None, :] < nl[:, None])
    has = space.any(axis=1)
    pos = np.argmax(space, axis=1).astype(np.int64)
    pre_len = np.where(has, np.where(pos >= 1, pos - 1,
                                     np.maximum(nl - 1, 0)), 0)
    post_len = np.where(has, nl - pos, 0)

    ones = np.ones(k, bool)
    nb_flat = np.frombuffer(nb, np.uint8)
    b = RaggedBuilder(k)
    b.add(nb_flat, no, pre_len)
    b.add_const(b"_merged_", ones)
    d1, s1, n1 = _ascii_ints(np.asarray(len1))
    b.add_matrix(d1, s1, n1)
    b.add_const(b"_", ones)
    d2, s2, n2 = _ascii_ints(np.asarray(len2))
    b.add_matrix(d2, s2, n2)
    b.add(nb_flat, no + pos, post_len)
    return b.build()
