#!/usr/bin/env python3
"""Smoke run of fqtool_tpu_torch on one CUDA card (no JAX anywhere).

Phases, each of which stops the run with a nonzero exit on failure:

1. the card's name and power limit (nvidia-smi), and whether the native
   FASTQ core (io/native.py) loaded or the host runs its pure-Python path;
2. build the CUDA kernels from csrc/overlap.cu and csrc/stats.cu with nvcc;
3. the kernel against its plain PyTorch version, both on the card, output
   for output (exact: all outputs are integers), over several shapes and
   parameters and the edge cases of ``tests/torch_pairs.py`` (lowercase and
   non-ACGTN bytes, unpadded widths, lengths 0-3, diff limits 0 and 60,
   windows across word boundaries); then, per 16384 x 151 chunk, the
   kernel's device-only time (torch.profiler, ``overlap_kernel`` summed over
   20 launches), the wrapper's and the plain version's CUDA-event times, and
   the bound: bytes at 3.35 TB/s against the byte compares this input needs
   at four per 32-bit op;
4. the paired-end main path pe_qualtrim: 1,000,000 synthetic 2x151 bp
   pairs through ``fqtool_tpu_torch.main`` on cuda with ``-q -f 3 -t 2`` and
   every output stream; the kernel's launch counter must cover every chunk,
   and every chunk must cross in one copy of a page-locked arena
   (``pipeline/device.py::staged``: page-locked uploads = uploads = parts x
   the chunks the runners dispatched, checked in every main-path run of the
   later phases too).
   The run is traced with torch.profiler (device activity only), which
   gives the card's busy time against the run's wall and the kernels that
   fill it, beside the host stage split;
5. the first 50,000 of those pairs once on cuda and once on the CPU (plain
   versions): records byte-identical, reports equal under compare_json;
6. the paired-end ops (duplication keys, the swapped polyG, base
   correction and pair merging fed by the overlap analysis, and
   ``pe_pipeline`` with every stage, without and with the merge) on the
   card against the same ops on the CPU, exact, at 16,384 pairs of 151 bp
   and at widths 40 and 300; then each timed per 16,384 x 151 chunk (CUDA
   events; torch.profiler busy ms and activity count);
7. the paired-end main paths pe_merge_corr (``-m --merge_output -c``, with
   the unpaired and failed streams) and pe_full (``-q --kmer --kmer_length 6
   -d -a --detect_pe_adapter``) on 1,000,000 pairs whose reads run past the
   insert into the TruSeq adapters, each traced as phase 4; the overlap
   kernel must launch twice a chunk with the merge and once without;
8. the first 50,000 of those pairs once on cuda and once on the CPU for
   eight argv sets (both configurations, the paired-end sets of
   tests/test_golden_random.py, --discard_unmerged, per-read UMI with split
   output whose files rotate in both mates, and interleaved input alone and
   with -q -c -a): every output file byte-identical, reports equal;
9. the single-end ops (polyG, polyX, adapter trimming, k-mers, duplication
   keys) on the card against the same ops on the CPU, exact, at 65,536
   reads of 151 bp and at widths 40 and 300; then every single-end
   pipeline op and the whole ``se_pipeline`` timed per 65,536 x 151 chunk
   with CUDA events;
10. the single-end main path: 2,000,000 synthetic 151 bp reads with
   se_qualtrim (``-q -f 3 -t 2``) and 1,000,000 with every single-end
   stage, each traced as phase 4;
11. the first 50,000 of those reads once on cuda and once on the CPU for
   four argv sets: every output file byte-identical, reports equal; the
   split run reads packs of 500, so records reach every split file;
12. multi-host runs on the card (dist/multihost.py), every rank a
   subprocess of this script (``--rank-main -- <argv>``) on cuda, all ranks
   sharing the one card: the first 50,000 pairs of phase 7 with ``-s
   --split_file_number 4 --max_item_in_pack 500 -q -c -d --ora`` as 2 ranks
   whose kernel library is removed first (so both build it at once) against
   a single-process cuda run; then pe_merge_corr and pe_full on phase 7's
   pairs as 2 ranks and se_qualtrim on phase 10's reads as 4 ranks. Every
   output file must be byte-identical to the single-process run's, the
   reports equal, and the ranks' overlap kernel launches must sum to calls x
   chunks. Prints each run's wall, rate, every rank's
   ``FQTOOL_TPU_TIMING_JSON`` marks, stage split and busy ms on the card.
13. the device split (dist/sharding.py) with ``FQTOOL_TPU_TORCH_DEVICE=
   cuda:0,cuda:0``: pe_merge_corr on phase 7's pairs, traced as phase 4,
   every output byte-identical to phase 7's run and the reports equal, the
   overlap kernel launched for both parts of both calls of every chunk, its
   pairs/s beside phase 7's; se_all on phase 11's reads against a one-device
   run; ``entry("cuda")`` against ``entry("cpu")``; ``dryrun(2)`` over
   cuda:0 twice;
14. the switches: a 16 MiB upload's MB/s from pageable and from
   page-locked memory; pe_full on phase 8's pairs and se_all with ``--ora``
   on 150,000 of phase 10's reads (two packs) under
   ``FQTOOL_TPU_PACK_OVERLAP=1`` and ``FQTOOL_TPU_HEADCACHE=0``: each
   byte-identical to the default run, every chunk through a page-locked
   arena; then a ``FQTOOL_TPU_PROFILE_DIR`` run that must leave its trace.

The second-to-last line is the kernel table as JSON (the overlap kernel's
launches summed over the paired-end main paths, the paired-end ranks of
phase 12, phase 13's split run and phase 14's pe_full runs), the last line
``{"ok": true, "device": {...}}``.  Run
from the repository root: ``python3 chip_smoke.py`` (``--pairs``/``--subset``
/``--reads`` shrink the main-path phases).
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

os.environ.setdefault("FQTOOL_TPU_TRACE", "1")  # host stage split, phase 4

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from fqtool_tpu_torch import entry as port_entry  # noqa: E402
from fqtool_tpu_torch.host import native, tracing  # noqa: E402
from fqtool_tpu_torch.main import main as cli_main  # noqa: E402
from fqtool_tpu_torch.ops import adapter as se_adapter  # noqa: E402
from fqtool_tpu_torch.ops import common as se_common  # noqa: E402
from fqtool_tpu_torch.ops import correct as pe_correct  # noqa: E402
from fqtool_tpu_torch.ops import dup as se_dup  # noqa: E402
from fqtool_tpu_torch.ops import filters as se_filters  # noqa: E402
from fqtool_tpu_torch.ops import merge as pe_merge  # noqa: E402
from fqtool_tpu_torch.ops import overlap, overlap_cuda, overlap_select  # noqa: E402
from fqtool_tpu_torch.ops import polyx as se_polyx  # noqa: E402
from fqtool_tpu_torch.ops import qualcut as se_qualcut  # noqa: E402
from fqtool_tpu_torch.ops import stats as se_stats  # noqa: E402
from fqtool_tpu_torch.ops import stats_cuda  # noqa: E402
from fqtool_tpu_torch.pipeline import pe as pe_pipe  # noqa: E402
from fqtool_tpu_torch.pipeline import pe_runner, runner  # noqa: E402
from fqtool_tpu_torch.pipeline import se as se_pipe  # noqa: E402
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy, staged  # noqa: E402
from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args  # noqa: E402
from tests.oracle import compare_json, diff_fastq, read_fastq  # noqa: E402
from tests.torch_pairs import (ADAPTER_R1, ADAPTER_R2,  # noqa: E402
                               OVERLAP_EDGE_CASES, _options, edge_pairs,
                               kernel_params_se, make_pairs, planted_pairs,
                               write_pairs)
from tests.torch_reads import ADAPTER, make_reads, write_reads  # noqa: E402

PE_CHUNK = 16384
FLAGS = ["-q", "-f", "3", "-t", "2"]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    loaded = native.get_lib() is not None
    log(f"native FASTQ core libfastq_core.so loaded: {loaded}"
        + ("" if loaded else " (host runs the pure-Python path)"))


def phase_build() -> None:
    for wrapper in (overlap_cuda, stats_cuda):
        so = wrapper.library.path()
        cached = so.exists()
        t0 = time.perf_counter()
        wrapper.library.load()
        log(f"kernel build {so.name}: {time.perf_counter() - t0:.3f} s"
            + (" (library already built)" if cached else " (nvcc)"))
        for line in so.with_suffix(".log").read_text().splitlines():
            if "ptxas info" in line or "spill" in line:  # registers, spills
                log(line.strip())


def _case(B, L1, L2, seed, zero_frac=0.0):
    """Device planes at the main path's shapes: widths rounded up to 8 as the
    pack reader does, lengths mostly full, a fraction of rows at length 0."""
    s1, _, s2, _, _ = make_pairs(B, seed, max(L1, L2))
    rng = np.random.default_rng(seed + 1000)
    r1 = np.full(B, L1, np.int32)
    r2 = np.full(B, L2, np.int32)
    short = rng.random(B) < 0.2
    r1[short] = rng.integers(0, L1 + 1, short.sum())
    r2[short] = rng.integers(0, L2 + 1, short.sum())
    r1[rng.random(B) < zero_frac] = 0
    r2[rng.random(B) < zero_frac] = 0
    w1, w2 = -(-L1 // 8) * 8, -(-L2 // 8) * 8
    p1 = np.zeros((B, w1), np.uint8)
    p2 = np.zeros((B, w2), np.uint8)
    p1[:, :L1] = s1[:, :L1]
    p2[:, :L2] = s2[:, :L2]
    p1[np.arange(w1)[None, :] >= r1[:, None]] = 0
    p2[np.arange(w2)[None, :] >= r2[:, None]] = 0
    dev = torch.device("cuda")
    return tuple(torch.as_tensor(a).to(dev) for a in (p1, r1, p2, r2))


def _time_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_kernel(label: str, args, dl: int, req: int) -> int:
    """The kernel against the plain version on the card; max |err|."""
    got = overlap_cuda.analyze_cuda(*args, dl, req)
    torch.cuda.synchronize()
    ref = overlap.analyze(*args, dl, req)
    errs = {name: int((a.long() - b.long()).abs().max()) if a.numel() else 0
            for name, a, b in zip(ref._fields, got, ref)}
    hits = int(got.overlapped.sum())
    log(f"kernel vs plain {label} diff_limit={dl} require={req}: overlapped "
        f"{hits}/{args[0].shape[0]}, max |err| {errs} (tolerance 0: integer outputs)")
    if max(errs.values()):
        raise SystemExit(f"overlap kernel disagrees with the plain version: {errs}")
    return max(errs.values())


# peak rates of one H100 SXM: HBM bytes/s (data sheet), and int32 ALU ops/s
# (132 SMs x 64 INT32 lanes x 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _overlap_compares(r1, r2, res, require: int) -> int:
    """Byte compares that the reference scan order needs on this input: at
    every offset evaluated up to the first accepted one (all of both phases
    when none is), min(overlap, 50) bases; then the full diff at the chosen
    offset."""
    r1, r2 = r1.long()[:, None], r2.long()[:, None]
    off = res.offset.long()[:, None]
    found = res.overlapped[:, None]
    c1 = (r1 - require).clamp(min=0)
    c2 = (r2 - require).clamp(min=0)
    # offsets evaluated in each phase (an accepted offset 0 is phase 1's
    # unless phase 1 has no offsets)
    m1 = torch.where(found & (off >= 0) & (c1 > 0), off + 1, c1)
    m2 = torch.where(found, torch.where(off <= 0, -off + 1, 0), c2)
    m2 = torch.where(found & (off == 0) & (c1 > 0), 0, m2)
    k = torch.arange(int(max(r1.max(), r2.max(), 1)), device=r1.device)[None, :]
    n1 = (torch.minimum(r1 - k, r2).clamp(0, 50) * (k < m1)).sum()
    n2 = (torch.minimum(r1, r2 - k).clamp(0, 50) * (k < m2)).sum()
    return int(n1 + n2 + res.overlap_len.long().clamp(min=0).sum())


def _kernel_device_ms(fn, reps=20, kernel="overlap_kernel"):
    """Mean device time of the activities named ``kernel`` of ``reps`` calls
    of ``fn`` (torch.profiler), or None when the profiler saw fewer than one
    such activity per call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / reps / 1e3 if len(us) == reps else None


def phase_kernel() -> dict:
    cases = [(PE_CHUNK, 151, 151, 5, 30, 0.0), (PE_CHUNK, 151, 100, 5, 30, 0.0),
             (4096, 40, 40, 5, 30, 0.0), (1024, 500, 300, 5, 30, 0.0),
             (4096, 151, 151, 5, 30, 0.3)]
    cases += [(4096, 151, 151, d, r, 0.05)
              for d in (0, 1, 5, 10) for r in (10, 30, 60)]
    max_err = 0
    for k, (B, L1, L2, dl, req, zf) in enumerate(cases):
        args = _case(B, L1, L2, seed=100 + k, zero_frac=zf)
        max_err = max(max_err, _check_kernel(
            f"B={B} L={L1}/{L2} zero_rows={zf}", args, dl, req))
    for k, (L1, L2, dl, req, garbage) in enumerate(OVERLAP_EDGE_CASES):
        args = tuple(torch.as_tensor(a).cuda() for a in
                     edge_pairs(4096, L1, L2, seed=200 + k, garbage=garbage))
        max_err = max(max_err, _check_kernel(
            f"edge B=4096 L={L1}/{L2} unpadded, past-length bytes "
            f"{'random' if garbage else 'zero'}", args, dl, req))

    s1, r1, s2, r2 = args = _case(PE_CHUNK, 151, 151, seed=7)
    kern = lambda: overlap_cuda.analyze_cuda(*args, 5, 30)  # noqa: E731
    plain = lambda: overlap.analyze(*args, 5, 30)  # noqa: E731
    # plain, kernel, kernel, plain inside one call on one card; the CUDA-event
    # times first, since launches are slower once the profiler has run
    t_plain = [_time_ms(plain)]
    t_kern = [_time_ms(kern) for _ in range(2)]
    t_plain.append(_time_ms(plain))
    t_dev = [_kernel_device_ms(kern) for _ in range(2)]
    ms, plain_ms = min(t_kern), min(t_plain)
    device_ms = None if None in t_dev else min(t_dev)
    log(f"per 16384x151 chunk (planes {s1.shape[1]} wide): wrapper {t_kern} ms "
        f"(CUDA events, 20 calls), kernel device-only {t_dev} ms (torch.profiler, "
        f"overlap_kernel over 20 launches), plain {t_plain} ms")

    res = overlap.analyze(*args, 5, 30)
    B = s1.shape[0]
    nbytes = s1.numel() + s2.numel() + 4 * (r1.numel() + r2.numel()) + 13 * B
    compares = _overlap_compares(r1, r2, res, 30)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = compares / 4 / INT32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    share = (f"{bound_ms / device_ms:.4f} of the device-only time"
             if device_ms else "device-only time not measured")
    log(f"overlap bound per chunk: {nbytes} bytes at 3.35 TB/s = {t_bytes * 1e3:.3f} us; "
        f"{compares} byte compares ({compares / B:.1f} a pair, four per 32-bit op) "
        f"at {INT32_OPS_PER_S / 1e12:.2f} T int32 ops/s = {t_ops * 1e3:.3f} us; "
        f"bound by {bound_by}, {bound_ms * 1e3:.3f} us = {share}")
    return {"name": "overlap_analyze", "route": "cuda",
            "source": "fqtool_tpu_torch/csrc/overlap.cu",
            "replaces": "fqtool_tpu/ops/pallas_overlap2.py:89",
            "max_abs_err": max_err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _stats_case(B: int, L: int, seed: int):
    """A plane as the pipeline hands it to ``stat_batch``: ACGTN bases,
    qualities '#'-'J', lengths L - 1 (a 151-base read in a 152-wide plane, a
    302-base merged read in a 304-wide one) on eight rows of ten and 0 to L
    on the rest, 90 % of the rows selected."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (B, L))]
    qual = rng.integers(35, 75, (B, L)).astype(np.uint8)
    rlen = np.where(rng.random(B) < 0.8, L - 1,
                    rng.integers(0, L + 1, B)).astype(np.int32)
    seq[np.arange(L)[None, :] >= rlen[:, None]] = 0
    qual[np.arange(L)[None, :] >= rlen[:, None]] = 0
    dev = torch.device("cuda")
    return tuple(torch.as_tensor(a).to(dev)
                 for a in (seq, qual, rlen, rng.random(B) < 0.9))


def phase_stats_kernel() -> dict:
    """The stats kernel through ``stat_batch`` against ``stat_batch_plain``,
    both on the card, every field exact, at a chunk's 16,384 x 152 planes and
    its 16,384 x 304 merged plane; per call the wrapper's CUDA-event time,
    the kernel's device-only time and the plain op's event time, and the
    bound: the bytes it moves at 3.35 TB/s.  Returns the kernel's entry of
    the kernels line (the 152-wide figures; the 304-wide ones under
    ``merged_304``)."""
    figures = {}
    for L in (152, 304):
        args = _stats_case(PE_CHUNK, L, seed=L)
        for select in (args[3], None):
            got = se_stats.stat_batch(*args[:3], select)
            ref = se_stats.stat_batch_plain(*args[:3], select)
            bad = [name for name, a, b in zip(ref._fields, got, ref)
                   if a.dtype != b.dtype or not torch.equal(a, b)]
            if bad:
                raise SystemExit(f"stats kernel disagrees with the plain op at "
                                 f"{PE_CHUNK} x {L} (select "
                                 f"{'given' if select is not None else 'none'}): {bad}")
        log(f"stats kernel vs plain {PE_CHUNK} x {L}, select given and none: every "
            "field equal (tolerance 0: integer outputs)")
        kern = lambda: se_stats.stat_batch(*args)  # noqa: E731
        plain = lambda: se_stats.stat_batch_plain(*args)  # noqa: E731
        # CUDA-event times first, since launches are slower once the profiler
        # has run
        t_plain = [_time_ms(plain)]
        t_kern = [_time_ms(kern) for _ in range(2)]
        t_plain.append(_time_ms(plain))
        t_dev = [_kernel_device_ms(kern, kernel="stat_batch_kernel") for _ in range(2)]
        device_ms = None if None in t_dev else min(t_dev)
        B = PE_CHUNK
        nbytes = 2 * B * L + 4 * B + B + 4 * (34 * L + 2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        share = (f"{bound_ms / device_ms:.4f} of the device-only time"
                 if device_ms else "device-only time not measured")
        log(f"stats per {B} x {L} plane: stat_batch {t_kern} ms (CUDA events, 20 "
            f"calls), kernel device-only {t_dev} ms (torch.profiler, "
            f"stat_batch_kernel over 20 launches), plain {t_plain} ms; bound "
            f"{nbytes} bytes at 3.35 TB/s = {bound_ms * 1e3:.3f} us = {share}")
        figures[L] = {"ms": min(t_kern), "device_ms": device_ms,
                      "plain_ms": min(t_plain), "bound_ms": bound_ms}
    return {"name": "stat_batch", "route": "cuda",
            "source": "fqtool_tpu_torch/csrc/stats.cu", "replaces": None,
            "max_abs_err": 0, **figures[152], "bound_by": "bytes",
            "library_ms": None, "merged_304": figures[304]}


# chunks the runners hand to dispatch_on since the last _reset_launches
DISPATCHED = Counter()


def _counted(dispatch_on):
    def counted(devices, body, arrays, **kw):
        DISPATCHED["chunks"] += 1
        return dispatch_on(devices, body, arrays, **kw)
    return counted


def _count_chunks() -> None:
    """Count every chunk both runners dispatch in ``DISPATCHED``."""
    runner.dispatch_on = _counted(runner.dispatch_on)
    pe_runner.dispatch_on = _counted(pe_runner.dispatch_on)


def _reset_launches() -> None:
    """Zero both kernels' launch counters, the count of dispatched chunks
    and the arena's ``device.staged`` before a main-path run."""
    overlap_cuda.launches = 0
    stats_cuda.launches = 0
    DISPATCHED.clear()
    staged.clear()


STATS_LAUNCHES = []  # the stats kernel's launches of each checked run


def _check_stats_launches(tag: str, per_chunk: int, launches=None, chunks=None,
                          parts: int = 1) -> None:
    """One stats kernel launch per ``stat_batch`` call: ``per_chunk`` a chunk
    on each of ``parts`` devices over the chunks dispatched since
    ``_reset_launches`` (or the given launches and chunks of ranks)."""
    if launches is None:
        launches = stats_cuda.launches
        chunks = DISPATCHED["chunks"]
    log(f"{tag}: stats kernel launches {launches} for {chunks} chunks "
        f"({per_chunk} a chunk{f' on each of {parts} devices' if parts > 1 else ''})")
    if not chunks or launches != per_chunk * parts * chunks:
        raise SystemExit(f"{tag}: {launches} stats kernel launches for {chunks} "
                         f"chunks, {per_chunk * parts} a chunk expected")
    STATS_LAUNCHES.append(launches)


def _check_staged(tag: str, parts: int = 1, counts=None, chunks=None) -> None:
    """Every upload of the chunks dispatched since ``_reset_launches`` (or
    the given ``counts`` and chunks of ranks) through a page-locked arena:
    ``pinned`` = ``chunks`` = ``parts`` a dispatched chunk."""
    if counts is None:
        counts = staged
        chunks = DISPATCHED["chunks"]
    want = parts * chunks
    log(f"{tag}: arena uploads {counts.get('chunks', 0)}, page-locked "
        f"{counts.get('pinned', 0)}, {counts.get('bytes', 0)} bytes for {chunks} chunks")
    if not chunks or counts.get("chunks", 0) != want or counts.get("pinned", 0) != want:
        raise SystemExit(f"{tag}: arena counts {dict(counts)} for {chunks} chunks, "
                         f"{want} page-locked uploads expected")


def _run_cli(work: Path, r1: Path, r2: Path, device: str, tag: str) -> dict:
    out = {k: work / f"{tag}_{k}.fq.gz"
           for k in ("o1", "o2", "up1", "up2", "failed")}
    argv = ["-i", str(r1), "-I", str(r2), "-o", str(out["o1"]), "-O", str(out["o2"]),
            *FLAGS, "--unpaired_read1", str(out["up1"]),
            "--unpaired_read2", str(out["up2"]), "--failed_out", str(out["failed"]),
            "-J", str(work / f"{tag}.json"), "-H", str(work / f"{tag}.html")]
    os.environ["FQTOOL_TPU_TORCH_DEVICE"] = device
    rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"fqtool_tpu_torch.main returned {rc} on {device}")
    out["json"] = work / f"{tag}.json"
    return out


def _device_busy(prof) -> tuple:
    """Busy ms of the card in a profiled run (the union of its kernel and
    copy intervals) and the six names that took the most device time."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return busy_us / 1e3, top


def _traced(tag: str, run):
    """Run ``run()`` under torch.profiler (device activity only) with the
    host stage trace reset; print the host stage split, the card's busy ms
    against the wall, the idle share and the six names that took the most
    device time.  Returns (wall seconds, what ``run`` returned)."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"{tag} host stage split: " + json.dumps(tracing.snapshot(), sort_keys=True))
    busy_ms, top = _device_busy(prof)
    if busy_ms > 0:
        log(f"{tag} on the card (torch.profiler): {busy_ms:.3f} ms busy of "
            f"{wall * 1e3:.3f} ms wall, idle share {1 - busy_ms / (wall * 1e3):.4f}; "
            "top device time (ms): "
            + json.dumps([[n, round(ms, 3)] for n, ms in top]))
    else:
        log(f"{tag} on the card: device time not measured "
            "(torch.profiler recorded no device activity)")
    return wall, result


def phase_main(work: Path, pairs: int) -> tuple:
    r1, r2 = work / "r1.fq", work / "r2.fq"
    t0 = time.perf_counter()
    write_pairs(r1, r2, pairs, seed=2024)
    log(f"generated {pairs} pairs of 2x151 bp in {time.perf_counter() - t0:.3f} s")
    _reset_launches()
    wall, out = _traced("pe_qualtrim",
                        lambda: _run_cli(work, r1, r2, "cuda", "cuda_full"))
    launches = overlap_cuda.launches
    _check_stats_launches("pe_qualtrim", 4)
    _check_staged("pe_qualtrim")
    chunks = -(-pairs // PE_CHUNK)
    rep = json.loads(out["json"].read_text())
    ins = rep["InsertSize"]
    log(f"pe_qualtrim main path: {pairs} pairs in {wall:.3f} s = {pairs / wall:.1f} "
        f"pairs/s; overlap kernel launches {launches} for {chunks} chunks; "
        f"insert-size peak {ins['Peak']}, unknown {ins['Unknown']}")
    if launches < chunks:
        raise SystemExit(f"the main path launched the overlap kernel {launches} "
                         f"times for {chunks} chunks")
    before = rep["Summary"]["BeforeFiltering"]["TotalReads"]
    if before != 2 * pairs or sum(ins["Histogram"]) + ins["Unknown"] != pairs:
        raise SystemExit(f"report counts {before} reads and "
                         f"{sum(ins['Histogram']) + ins['Unknown']} insert sizes "
                         f"for {pairs} pairs")
    return r1, r2, launches


def phase_subset(work: Path, r1: Path, r2: Path, subset: int) -> None:
    s1, s2 = work / "s1.fq", work / "s2.fq"
    for src, dst in ((r1, s1), (r2, s2)):
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.writelines(itertools.islice(f, 4 * subset))
    gpu = _run_cli(work, s1, s2, "cuda", "sub_cuda")
    t0 = time.perf_counter()
    cpu = _run_cli(work, s1, s2, "cpu", "sub_cpu")
    log(f"subset of {subset} pairs on the CPU (plain versions): "
        f"{time.perf_counter() - t0:.3f} s")
    for k in ("o1", "o2", "up1", "up2", "failed"):
        a, b = read_fastq(gpu[k]), read_fastq(cpu[k])
        d = diff_fastq(a, b)
        if d:
            raise SystemExit(f"{k}: cuda and cpu records differ: {d}")
        log(f"subset {k}: {len(a)} records identical on cuda and cpu")
    d = compare_json(json.loads(gpu["json"].read_text()),
                     json.loads(cpu["json"].read_text()))
    if d:
        raise SystemExit(f"cuda and cpu reports differ: {d[:10]}")
    log("subset reports equal under compare_json")

# ---------------------------------------------------------------------------
# paired-end correction, merge, adapters and the paired-end forms of the
# single-end stages
AD_PE = ["--adapter_of_read1", ADAPTER_R1.decode(),
         "--adapter_of_read2", ADAPTER_R2.decode()]
MERGE = ["-m", "--merge_output", "merged.fq.gz"]
PE_OUTS = ["--unpaired_read1", "up1.fq.gz", "--unpaired_read2", "up2.fq.gz",
           "--failed_out", "failed.fq.gz"]
# bench.py's two paired-end configurations beyond quality trimming
PE_MERGE_CORR = MERGE + ["-c"]
PE_FULL = ["-q", "--kmer", "--kmer_length", "6", "-d", "-a", "--detect_pe_adapter"]
# every paired-end stage, with and without the merge, for pe_pipeline
PE_EVERY = ["-q", "-g", "-x", "-c", "-a", *AD_PE, "-d", "--kmer", "--kmer_length",
            "6", "-u", "--umi_location", "6", "--umi_length", "8"]
# the 50 k-pair cuda-vs-cpu subsets: name -> (flags, interleaved input);
# interleaved input takes no -O and -m needs -I (config/cli.py:201-205), and
# -a needs its sequences there (the PE adapter scan would open the absent -I)
PE_SUBSETS = {
    "pe_merge_corr": (PE_MERGE_CORR + PE_OUTS, False),
    "pe_full": (PE_FULL, False),
    "pe_random_all": (["-q", "-a", "-c", "-g"] + PE_OUTS, False),
    "pe_random_merge": (MERGE + ["-c", "-x"], False),
    "pe_discard_unmerged": (MERGE + ["--discard_unmerged", "-c"], False),
    # per-read UMI (both mates shift), packs of 500 so that split files rotate
    "pe_umi_split": (["-u", "--umi_location", "6", "--umi_length", "8", "-s",
                      "--split_file_number", "4", "--max_item_in_pack", "500"], False),
    "pe_interleaved": (PE_OUTS, True),
    "pe_interleaved_corr_adapter": (["-q", "-c", "-a", *AD_PE] + PE_OUTS, True),
}


def _pe_params(flags):
    """(p, p2, pipeline keywords) of a paired-end argv, as PairEndRunner
    derives them."""
    opt = _options(["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq",
                    *flags])
    return (opt.kernel_params(is_r2=False), opt.kernel_params(is_r2=True),
            pipeline_args(opt))


def _pe_case(B, L1, L2, seed) -> dict:
    """Paired-end planes of ``planted_pairs`` (planted overlaps, inserts
    shorter and longer than a read, Q2 substitutions, rows at lengths 0-3)
    with UMI offsets within each length and an index-filter mask, as CPU
    tensors."""
    s1, q1, r1, s2, q2, r2 = planted_pairs(seed, B, L1, L2)
    rng = np.random.default_rng(seed + 1000)
    st1 = np.minimum(rng.integers(0, 9, B), r1).astype(np.int32)
    st2 = np.minimum(rng.integers(0, 9, B), r2).astype(np.int32)
    return {k: torch.as_tensor(v) for k, v in dict(
        s1=s1, q1=q1, r1=r1, s2=s2, q2=q2, r2=r2, st1=st1, st2=st2,
        keep=rng.random(B) < 0.95).items()}


def _ov(t):
    return overlap_select.analyze(t["s1"], t["r1"], t["s2"], t["r2"], 5, 30)


def _pipeline(flags):
    p, p2, kw = _pe_params(flags)
    return lambda t: pe_pipe.pe_pipeline(
        t["s1"], t["q1"], t["r1"], t["s2"], t["q2"], t["r2"], t["st1"], t["st2"],
        t["keep"], p=p, p2=p2, **kw)


# the paired-end ops held cuda against cpu: name -> f(planes)
PE_OPS = {
    "dup_keys_pe[12]": lambda t: se_dup.dup_keys_pe(t["s1"], t["r1"], t["s2"],
                                                    t["r2"], 12),
    "dup_keys_pe[17]": lambda t: se_dup.dup_keys_pe(t["s1"], t["r1"], t["s2"],
                                                    t["r2"], 17),
    # -g's defaults with the paired-end argument swap (pipeline/pe.py stage 5)
    "trim_polyg[PE argument swap]": lambda t: se_polyx.trim_polyg(
        t["s1"], t["r1"], compare_req=1, max_mismatch=10, each=10),
    "correct_by_overlap": lambda t: pe_correct.correct_by_overlap(
        t["s1"], t["q1"], t["r1"], t["s2"], t["q2"], t["r2"], _ov(t), t["keep"]),
    "merge_pairs": lambda t: pe_merge.merge_pairs(
        t["s1"], t["q1"], t["r1"], t["s2"], t["q2"], t["r2"], _ov(t)),
    "pe_pipeline[every stage]": _pipeline(PE_EVERY),
    "pe_pipeline[every stage, merge]": _pipeline(PE_EVERY + MERGE),
}


def _flat(x) -> list:
    """(name, tensor or None) of an op's output: a dict key by key, a
    NamedTuple field by field."""
    if isinstance(x, dict):
        return [(f"{k}.{n}", v) for k in sorted(x) for n, v in _flat(x[k])]
    if isinstance(x, tuple):
        return [(f, v) for f, v in zip(x._fields, x)]
    return [("", x)]


def phase_pe_ops(dev: str = "cuda") -> None:
    cases = [(PE_CHUNK, 151, 151), (PE_CHUNK // 4, 40, 40), (PE_CHUNK // 8, 300, 300)]
    for k, (B, L1, L2) in enumerate(cases):
        cpu = _pe_case(B, L1, L2, seed=500 + k)
        gpu = {n: v.to(dev) for n, v in cpu.items()}
        for name, fn in PE_OPS.items():
            got, ref = _flat(fn(gpu)), _flat(fn(cpu))
            torch.cuda.synchronize()
            if [n for n, _ in got] != [n for n, _ in ref]:
                raise SystemExit(f"{name}: outputs differ in names between devices")
            for (field, a), (_, b) in zip(got, ref):
                if (a is None) != (b is None):
                    raise SystemExit(f"{name}.{field}: None on one device only")
                if a is None:
                    continue
                a, b = a.cpu().numpy(), b.numpy()
                err = (int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                       if a.size and a.shape == b.shape else 0)
                if a.dtype != b.dtype or a.shape != b.shape or err:
                    raise SystemExit(
                        f"{name}.{field} B={B} L={L1}/{L2}: cuda {a.dtype}{a.shape} "
                        f"vs cpu {b.dtype}{b.shape}, max |err| {err}")
        log(f"paired-end ops cuda vs cpu B={B} L={L1}/{L2}: {len(PE_OPS)} ops "
            "equal, every output (tolerance 0: integer outputs)")

    t = {n: v.to(dev) for n, v in _pe_case(PE_CHUNK, 151, 151, seed=600).items()}
    timed = {"overlap_select.analyze": _ov, **PE_OPS,
             "pe_pipeline[pe_merge_corr]": _pipeline(PE_MERGE_CORR),
             "pe_pipeline[pe_full]": _pipeline(PE_FULL)}
    ms = {name: round(_time_ms(lambda: fn(t)), 4) for name, fn in timed.items()}
    log("paired-end op ms per 16384 x 151 chunk (CUDA events, 20 launches): "
        + json.dumps(ms))
    log("paired-end op device ms and device activities (kernels, copies) per "
        "16384 x 151 chunk (torch.profiler, one call): "
        + json.dumps({name: _device_ms(lambda: fn(t)) for name, fn in timed.items()}))


def _run_pe_cli(work: Path, tag: str, inputs, flags, device: str) -> Path:
    """Run the port's paired-end CLI in ``work/tag`` on ``inputs`` (two
    files, or one interleaved file); returns that directory."""
    d = work / tag
    d.mkdir()
    if len(inputs) == 2:
        argv = ["-i", str(inputs[0]), "-I", str(inputs[1]), "-o", "o1.fq.gz",
                "-O", "o2.fq.gz"]
    else:
        argv = ["-i", str(inputs[0]), "--in_fq_interleaved", "-o", "o1.fq.gz"]
    argv += [*flags, "-J", "report.json", "-H", "report.html"]
    os.environ["FQTOOL_TPU_TORCH_DEVICE"] = device
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc = cli_main(argv)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise SystemExit(f"fqtool_tpu_torch.main {' '.join(argv)} returned {rc} "
                         f"on {device}")
    return d


def phase_pe_main(work: Path, pairs: int) -> tuple:
    """pe_merge_corr and pe_full on the same pairs, whose reads run past the
    insert into the TruSeq adapters; returns the inputs, the overlap
    kernel's launches of both runs and each run's pairs/s."""
    r1, r2 = work / "a1.fq", work / "a2.fq"
    t0 = time.perf_counter()
    write_pairs(r1, r2, pairs, seed=2026, adapters=True)
    log(f"generated {pairs} pairs of 2x151 bp with adapters past the insert in "
        f"{time.perf_counter() - t0:.3f} s")
    chunks = -(-pairs // PE_CHUNK)
    total = 0
    rates = {}
    for tag, flags, calls, stat_calls in (
            ("pe_merge_corr", PE_MERGE_CORR + PE_OUTS, 2, 5), ("pe_full", PE_FULL, 1, 4)):
        _reset_launches()
        wall, d = _traced(tag, lambda: _run_pe_cli(work, tag, (r1, r2), flags, "cuda"))
        launches = overlap_cuda.launches
        _check_stats_launches(tag, stat_calls)
        _check_staged(tag)
        total += launches
        rates[tag] = pairs / wall
        rep = json.loads((d / "report.json").read_text())
        log(f"{tag} main path: {pairs} pairs in {wall:.3f} s = {pairs / wall:.1f} "
            f"pairs/s ({' '.join(flags)}); overlap kernel launches {launches} for "
            f"{chunks} chunks")
        if launches != calls * chunks:
            raise SystemExit(f"{tag}: {launches} overlap kernel launches, "
                             f"{calls * chunks} expected ({calls} a chunk)")
        before = rep["Summary"]["BeforeFiltering"]["TotalReads"]
        if before != 2 * pairs:
            raise SystemExit(f"{tag}: report counts {before} reads for {pairs} pairs")
        if tag == "pe_merge_corr":
            with gzip.open(d / "merged.fq.gz", "rb") as f:
                merged = f.read().count(b"_merged_")
            corrected = rep["FilterResult"]["CorrectedBases"]
            log(f"{tag}: {merged} merged pairs, {corrected} corrected bases in "
                f"{rep['FilterResult']['CorrectedReads']} reads")
            if not (merged > 0 and corrected > 0):
                raise SystemExit(f"{tag}: merged {merged} pairs and corrected "
                                 f"{corrected} bases")
        else:
            ad = rep.get("AdapterTrim") or {}
            log(f"{tag}: pre-pass detected read1 adapter "
                f"{ad.get('Read1AdapterSequence')!r}, read2 adapter "
                f"{ad.get('Read2AdapterSequence')!r}; adapter-trimmed reads "
                f"{ad.get('AdapterTrimmedReads')}")
            kmers = rep["Read1BeforeFiltering"].get("KmerCount")
            if not (ad and rep.get("Duplication")
                    and sum(rep["Duplication"]["Histogram"]) > 0 and kmers):
                raise SystemExit(f"{tag}: AdapterTrim, Duplication or k-mer "
                                 "section empty")
    return r1, r2, total, rates


def _interleave(s1: Path, s2: Path, dst: Path) -> Path:
    """One FASTQ file holding read1 then read2 of each pair."""
    with open(s1, "rb") as f1, open(s2, "rb") as f2, open(dst, "wb") as g:
        for rec1, rec2 in zip(itertools.zip_longest(*[f1] * 4),
                              itertools.zip_longest(*[f2] * 4)):
            g.writelines(rec1 + rec2)
    return dst


def phase_pe_subsets(work: Path, r1: Path, r2: Path, subset: int) -> None:
    s1, s2 = _head(r1, work / "as1.fq", subset), _head(r2, work / "as2.fq", subset)
    inter = _interleave(s1, s2, work / "as_inter.fq")
    for tag, (flags, interleaved) in PE_SUBSETS.items():
        inputs = (inter,) if interleaved else (s1, s2)
        gpu = _run_pe_cli(work, f"sub_{tag}_cuda", inputs, flags, "cuda")
        t0 = time.perf_counter()
        cpu = _run_pe_cli(work, f"sub_{tag}_cpu", inputs, flags, "cpu")
        secs = time.perf_counter() - t0
        names = sorted(p.name for p in gpu.glob("*.fq.gz"))
        if names != sorted(p.name for p in cpu.glob("*.fq.gz")):
            raise SystemExit(f"{tag}: cuda and cpu wrote different files")
        counts, filled = [], {}
        for name in names:
            a, b = read_fastq(gpu / name), read_fastq(cpu / name)
            d = diff_fastq(a, b)
            if d:
                raise SystemExit(f"{tag} {name}: cuda and cpu records differ: {d}")
            counts.append(f"{name} {len(a)}")
            mate = name.rsplit(".", 3)[-3]  # o1 / o2 of a split file
            filled[mate] = filled.get(mate, 0) + bool(a)
        if "-s" in flags and not (filled.get("o1", 0) >= 2 and filled.get("o2", 0) >= 2):
            raise SystemExit(f"{tag}: records reached {filled} split files: the "
                             "rotation between files went unchecked")
        d = compare_json(json.loads((gpu / "report.json").read_text()),
                         json.loads((cpu / "report.json").read_text()))
        if d:
            raise SystemExit(f"{tag}: cuda and cpu reports differ: {d[:10]}")
        log(f"subset {tag} ({subset} pairs{', interleaved' if interleaved else ''}; "
            f"CPU run {secs:.3f} s): records identical on cuda and cpu "
            f"({', '.join(counts)}); reports equal")


SE_CHUNK = 65536
SE_QUALTRIM = ["-q", "-f", "3", "-t", "2"]
SE_ALL = ["-q", "-g", "-x", "-a", "--adapter_of_read1", ADAPTER.decode(), "-d",
          "--kmer", "--kmer_length", "6"]
SE_SUBSETS = {
    "se_qualtrim": SE_QUALTRIM + ["--failed_out", "failed.fq.gz"],
    "se_polygx": ["-g", "-x"],
    "se_adapter": ["-a", "--adapter_of_read1", ADAPTER.decode()],
    # packs of 500 reads, so that the four split files rotate and all hold
    # records
    "se_umi_split": ["-q", "-d", "--kmer", "--kmer_length", "6", "-u",
                     "--umi_location", "3", "--umi_length", "8", "-s",
                     "--split_file_number", "4", "--max_item_in_pack", "500",
                     "--failed_out", "failed.fq.gz"],
}


def _se_case(B, L, seed, zero_frac=0.0):
    """Single-end planes at the main path's shapes: width rounded up to 8 as
    the pack reader does, lengths mostly full, a fraction of rows at length 0,
    and a selection mask; as (seq, qual, rlen, select) tensors on the CPU."""
    seq, qual, _ = make_reads(B, seed, L)
    rng = np.random.default_rng(seed + 1000)
    rlen = np.full(B, L, np.int32)
    short = rng.random(B) < 0.2
    rlen[short] = rng.integers(0, L + 1, short.sum())
    rlen[rng.random(B) < zero_frac] = 0
    w = -(-L // 8) * 8
    s = np.zeros((B, w), np.uint8)
    q = np.zeros((B, w), np.uint8)
    s[:, :L] = seq
    q[:, :L] = qual
    pad = np.arange(w)[None, :] >= rlen[:, None]
    s[pad] = 0
    q[pad] = 0
    return tuple(torch.as_tensor(a) for a in (s, q, rlen, rng.random(B) < 0.8))


# the single-end ops held cuda against cpu: name -> f(seq, qual, rlen, select)
SE_OPS = {
    "trim_polyg": lambda s, q, r, m: se_polyx.trim_polyg(s, r, 10, 5, 8),
    "trim_polyx[default ATCGN]":
        lambda s, q, r, m: se_polyx.trim_polyx(s, r, "ATCGN", 10, 5, 8),
    "trim_polyx[ACGTN]": lambda s, q, r, m: se_polyx.trim_polyx(s, r, "ACGTN", 10, 5, 8),
    "trim_polyx[G]": lambda s, q, r, m: se_polyx.trim_polyx(s, r, "G", 10, 5, 8),
    "trim_by_sequence[33]": lambda s, q, r, m: se_adapter.trim_by_sequence(s, r, ADAPTER),
    "trim_by_sequence[12]":
        lambda s, q, r, m: se_adapter.trim_by_sequence(s, r, ADAPTER[:12]),
    "trim_by_sequence[7]":
        lambda s, q, r, m: se_adapter.trim_by_sequence(s, r, ADAPTER[:7]),
    "kmer_counts[6]": lambda s, q, r, m: se_stats.kmer_counts(s, r, 6, m),
    "dup_keys_se[12]": lambda s, q, r, m: se_dup.dup_keys_se(s, r, 12),
    "dup_keys_se[17]": lambda s, q, r, m: se_dup.dup_keys_se(s, r, 17),
}


def _outputs(x) -> list:
    return list(x) if isinstance(x, tuple) else [x]


def phase_se_ops(dev: str = "cuda") -> None:
    cases = [(SE_CHUNK, 151, 0.0), (SE_CHUNK, 151, 0.3), (SE_CHUNK // 4, 40, 0.0),
             (SE_CHUNK // 8, 300, 0.0)]
    for k, (B, L, zf) in enumerate(cases):
        cpu = _se_case(B, L, seed=300 + k, zero_frac=zf)
        gpu = tuple(t.to(dev) for t in cpu)
        for name, fn in SE_OPS.items():
            got, ref = _outputs(fn(*gpu)), _outputs(fn(*cpu))
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                if (a is None) != (b is None):
                    raise SystemExit(f"{name}: an output is None on one device only")
                if a is None:
                    continue
                a, b = a.cpu().numpy(), b.numpy()
                err = (int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                       if a.size and a.shape == b.shape else 0)
                if a.dtype != b.dtype or a.shape != b.shape or err:
                    raise SystemExit(
                        f"{name} B={B} L={L} zero_rows={zf}: cuda {a.dtype}{a.shape} "
                        f"vs cpu {b.dtype}{b.shape}, max |err| {err}")
        log(f"single-end ops cuda vs cpu B={B} L={L} zero_rows={zf}: "
            f"{len(SE_OPS)} ops equal (tolerance 0: integer outputs)")

    s, q, r, m = (t.to(dev) for t in _se_case(SE_CHUNK, 151, seed=400))
    p = kernel_params_se(*SE_QUALTRIM)
    p_all = kernel_params_se(*SE_ALL)
    tc = se_qualcut.trim_and_cut(s, q, r, p.front, p.tail, p)
    zeros = torch.zeros_like(r)
    umi8 = torch.full_like(r, 8)
    timed = dict(SE_OPS)
    timed.update({
        # the UMI shift of se_pipeline (one gather per plane), beside the
        # static slice that a uniform offset would allow
        "align[UMI 8, per row]": lambda s, q, r, m: se_common.align((s, q), umi8),
        "align_static[UMI 8]": lambda s, q, r, m: (
            se_common.align_static(s, 8), se_common.align_static(q, 8)),
        "stat_batch": lambda s, q, r, m: se_stats.stat_batch(s, q, r, m),
        "trim_and_cut[-f 3 -t 2]":
            lambda s, q, r, m: se_qualcut.trim_and_cut(s, q, r, p.front, p.tail, p),
        "pass_filter[-q]":
            lambda s, q, r, m: se_filters.pass_filter(s, q, tc.rlen, tc.dropped, p),
        "se_pipeline[se_qualtrim]": lambda s, q, r, m: se_pipe.se_pipeline(
            s, q, r, zeros, m, p=p),
        "se_pipeline[all stages]": lambda s, q, r, m: se_pipe.se_pipeline(
            s, q, r, zeros, m, p=p_all, adapter_r1=ADAPTER, with_kmer=True),
    })
    ms = {name: round(_time_ms(lambda: fn(s, q, r, m)), 4)
          for name, fn in timed.items()}
    log("single-end op ms per 65536 x 151 chunk (CUDA events, 20 launches): "
        + json.dumps(ms))
    log("single-end op device ms and device activities (kernels, copies) per "
        "65536 x 151 chunk (torch.profiler, one call): "
        + json.dumps({name: _device_ms(lambda: fn(s, q, r, m))
                      for name, fn in timed.items()}))


def _device_ms(fn):
    """[busy ms, activity count] of one traced call of ``fn`` on the card, or
    None when the profiler recorded no device activity: an op whose
    CUDA-event time is far above its busy time waits on its host launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms, _ = _device_busy(prof)
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return [round(busy_ms, 4), n] if n else None


def _run_se_cli(work: Path, fq: Path, flags, device: str, tag: str) -> Path:
    """Run the port's CLI in ``work/tag`` (split files land there too);
    returns that directory."""
    d = work / tag
    d.mkdir()
    argv = ["-i", str(fq), "-o", "out.fq.gz", *flags, "-J", "report.json",
            "-H", "report.html"]
    os.environ["FQTOOL_TPU_TORCH_DEVICE"] = device
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc = cli_main(argv)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise SystemExit(f"fqtool_tpu_torch.main {' '.join(flags)} returned {rc} "
                         f"on {device}")
    return d


def _head(src: Path, dst: Path, reads: int) -> Path:
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.writelines(itertools.islice(f, 4 * reads))
    return dst


def phase_se_main(work: Path, reads: int) -> Path:
    fq = work / "se.fq"
    t0 = time.perf_counter()
    write_reads(fq, reads, seed=2025)
    log(f"generated {reads} single-end reads of 151 bp in "
        f"{time.perf_counter() - t0:.3f} s")
    half = _head(fq, work / "se_half.fq", reads // 2)
    for tag, src, n, flags in (
            ("se_qualtrim", fq, reads, SE_QUALTRIM + ["--failed_out", "failed.fq.gz"]),
            ("se_all", half, reads // 2, SE_ALL + ["--failed_out", "failed.fq.gz"])):
        _reset_launches()
        wall, d = _traced(tag, lambda: _run_se_cli(work, src, flags, "cuda", tag))
        _check_stats_launches(tag, 2)
        _check_staged(tag)
        rep = json.loads((d / "report.json").read_text())
        log(f"{tag} main path: {n} reads in {wall:.3f} s = {n / wall:.1f} reads/s "
            f"({' '.join(flags)})")
        before = rep["Summary"]["BeforeFiltering"]["TotalReads"]
        fr = rep["FilterResult"]
        if before != n or not 0 < fr["PassedFilterReads"] <= n:
            raise SystemExit(f"{tag}: report counts {before} reads and filter "
                             f"results {fr} for {n} reads")
        need = ["Read1AfterFiltering"]
        if tag == "se_all":
            need += ["AdapterTrim", "PolyxTrimming", "Duplication"]
            if not (rep["AdapterTrim"]["AdapterTrimmedReads"] > 0
                    and rep["PolyxTrimming"]["PolyxTrimmedReads"]["G"] > 0
                    and sum(rep["Duplication"]["Histogram"]) > 0):
                raise SystemExit(f"{tag}: adapter, polyG or duplication section "
                                 "counted nothing")
        missing = [k for k in need if not rep.get(k)]
        if missing:
            raise SystemExit(f"{tag}: report sections missing or empty: {missing}")
        log(f"{tag}: report counts {n} reads; filter results {json.dumps(fr)}")
    return fq


def phase_se_subset(work: Path, fq: Path, subset: int) -> None:
    sub = _head(fq, work / "se_sub.fq", subset)
    for tag, flags in SE_SUBSETS.items():
        gpu = _run_se_cli(work, sub, flags, "cuda", f"sub_{tag}_cuda")
        t0 = time.perf_counter()
        cpu = _run_se_cli(work, sub, flags, "cpu", f"sub_{tag}_cpu")
        secs = time.perf_counter() - t0
        names = sorted(p.name for p in gpu.glob("*.fq.gz"))
        if names != sorted(p.name for p in cpu.glob("*.fq.gz")):
            raise SystemExit(f"{tag}: cuda and cpu wrote different files")
        counts, filled = [], 0
        for name in names:
            a, b = read_fastq(gpu / name), read_fastq(cpu / name)
            d = diff_fastq(a, b)
            if d:
                raise SystemExit(f"{tag} {name}: cuda and cpu records differ: {d}")
            counts.append(f"{name} {len(a)}")
            filled += bool(a) and name != "failed.fq.gz"
        if "-s" in flags and filled < 2:
            raise SystemExit(f"{tag}: records reached {filled} split file(s): the "
                             "rotation between files went unchecked")
        d = compare_json(json.loads((gpu / "report.json").read_text()),
                         json.loads((cpu / "report.json").read_text()))
        if d:
            raise SystemExit(f"{tag}: cuda and cpu reports differ: {d[:10]}")
        log(f"subset {tag} ({subset} reads; CPU run {secs:.3f} s): records "
            f"identical on cuda and cpu ({', '.join(counts)}); reports equal")


# ---------------------------------------------------------------------------
# multi-host runs: ranks of one group, each a subprocess of this script
MH_SPLIT = ["-s", "--split_file_number", "4", "--max_item_in_pack", "500", "-q", "-c",
            "-d", "--ora"]


def rank_main(argv) -> int:
    """One rank of a multi-host run: the port's CLI under torch.profiler
    (device activity only); prints both kernels' launches, its chunks, host
    stage split and busy ms on the card as the last line of its output."""
    on_card = torch.device(os.environ["FQTOOL_TPU_TORCH_DEVICE"]).type == "cuda"
    act = torch.profiler.ProfilerActivity
    _count_chunks()
    _reset_launches()
    tracing.reset()
    with torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU]) as prof:
        rc = cli_main(argv)
        if on_card:
            torch.cuda.synchronize()
    busy_ms, _ = _device_busy(prof)
    print(json.dumps({"launches": overlap_cuda.launches,
                      "stats_launches": stats_cuda.launches,
                      "chunks": DISPATCHED["chunks"],
                      "staged": dict(staged), "busy_ms": busy_ms,
                      "stages": tracing.snapshot()}), flush=True)
    return rc


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(d: Path, argv, nprocs: int, device: str) -> tuple:
    """Run the port's CLI on ``argv`` as ``nprocs`` ranks of one group in
    ``d``; returns (each rank's last-line dict with its timing file's
    stamps under "timing", wall seconds from the first start to the last
    exit).  Every rank is stopped before this returns."""
    d.mkdir()
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(nprocs):
            env = dict(os.environ, FQTOOL_TPU_TORCH_DEVICE=device,
                       FQTOOL_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       FQTOOL_TPU_REDUCE_PORT=str(port),
                       FQTOOL_TPU_NPROCS=str(nprocs), FQTOOL_TPU_PROC_ID=str(rank),
                       FQTOOL_TPU_TIMING_JSON=str(d.parent / f"{d.name}.timing{rank}.json"))
            logs.append(open(d.parent / f"{d.name}.rank{rank}.err", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-main", "--",
                 *map(str, argv)], cwd=d, env=env, stdout=subprocess.PIPE,
                stderr=logs[-1], text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        err = (d.parent / f"{d.name}.rank{rank}.err").read_text()
        if p.returncode != 0:
            raise SystemExit(f"{d.name}: rank {rank} of {nprocs} exited "
                             f"{p.returncode}:\n{err[-3000:]}")
        r = json.loads(out.strip().splitlines()[-1])
        r["timing"] = json.loads((d.parent / f"{d.name}.timing{rank}.json").read_text())
        ranks.append(r)
    return ranks, wall


def _same_outputs(tag: str, single: Path, multi: Path) -> list:
    """Every output file of the multi-host run byte-identical to the
    single-process run's, the reports equal; returns the file names."""
    names = sorted(p.name for p in single.iterdir() if p.name.endswith((".fq", ".fq.gz")))
    got = sorted(p.name for p in multi.iterdir() if p.name.endswith((".fq", ".fq.gz")))
    if not names or names != got or list(multi.glob("*.part")):
        raise SystemExit(f"{tag}: files {got} (parts {list(multi.glob('*.part'))}), "
                         f"single-process run {names}")
    for name in names:
        if (single / name).read_bytes() != (multi / name).read_bytes():
            raise SystemExit(f"{tag}: {name} differs from the single-process run")
    d = compare_json(json.loads((multi / "report.json").read_text()),
                     json.loads((single / "report.json").read_text()))
    if d:
        raise SystemExit(f"{tag}: reports differ from the single-process run: {d[:10]}")
    return names


def _log_ranks(tag: str, n: int, unit: str, ranks, wall: float) -> None:
    """The run's wall and rate, and each rank's marks (seconds after its
    run began), stage split and busy ms."""
    t_begin = min(r["timing"]["t_run_begin"] for r in ranks)
    run_wall = max(r["timing"]["t_done"] for r in ranks) - t_begin
    busy = sum(r["busy_ms"] for r in ranks)
    log(f"{tag} as {len(ranks)} ranks: {n} {unit} in {run_wall:.3f} s from the "
        f"first rank's run start to the last rank's end = {n / run_wall:.1f} {unit}/s "
        f"({wall:.3f} s with process start-up); busy on the card {busy:.3f} ms summed "
        f"over ranks (idle share >= {1 - busy / (run_wall * 1e3):.4f})")
    for k, r in enumerate(ranks):
        t = r["timing"]
        marks = {m: round(v - t["t_run_begin"], 3)
                 for m, v in sorted(t["marks"].items(), key=lambda kv: kv[1])}
        marks["done"] = round(t["t_done"] - t["t_run_begin"], 3)
        top = sorted(r["stages"].items(), key=lambda kv: -kv[1]["seconds"])[:5]
        log(f"{tag} rank {k}: started {t['t_run_begin'] - t_begin:.3f} s after the "
            f"first; marks (s after its run began) {json.dumps(marks)}; overlap kernel "
            f"launches {r['launches']}; busy {r['busy_ms']:.3f} ms; top stages (s) "
            + json.dumps({name: v["seconds"] for name, v in top}))


def phase_multihost(work: Path, a1: Path, a2: Path, pairs: int, fq: Path, reads: int,
                    subset: int, device: str = "cuda") -> int:
    """Phase 12; returns the overlap kernel launches of the paired-end ranks."""
    total = 0
    s1, s2 = work / "as1.fq", work / "as2.fq"  # phase 8's first pairs
    single = _run_pe_cli(work, "mh_split_single", (s1, s2), MH_SPLIT, device)
    # cold start: both ranks build the kernel libraries at once
    for wrapper in (overlap_cuda, stats_cuda):
        shutil.rmtree(wrapper.library.path().parent, ignore_errors=True)
    runs = [("pe_split_ora", ["-i", s1, "-I", s2, "-o", "o1.fq.gz", "-O", "o2.fq.gz",
                              *MH_SPLIT], single, 2, subset, "pairs", 1,
             -(-subset // 500), 4),
            *((tag, ["-i", a1, "-I", a2, "-o", "o1.fq.gz", "-O", "o2.fq.gz", *flags],
               work / tag, 2, pairs, "pairs", calls, -(-pairs // PE_CHUNK), stat_calls)
              for tag, flags, calls, stat_calls in (
                  ("pe_merge_corr", PE_MERGE_CORR + PE_OUTS, 2, 5),
                  ("pe_full", PE_FULL, 1, 4))),
            ("se_qualtrim", ["-i", fq, "-o", "out.fq.gz", *SE_QUALTRIM,
                             "--failed_out", "failed.fq.gz"],
             work / "se_qualtrim", 4, reads, "reads", 0, 0, 2)]
    for tag, argv, ref, nprocs, n, unit, calls, chunks, stat_calls in runs:
        argv = [*argv, "-J", "report.json", "-H", "report.html"]
        ranks, wall = _run_ranks(work / f"mh_{tag}", argv, nprocs, device)
        _log_ranks(tag, n, unit, ranks, wall)
        names = _same_outputs(tag, ref, work / f"mh_{tag}")
        launches = sum(r["launches"] for r in ranks)
        log(f"{tag} as {nprocs} ranks: {len(names)} output files byte-identical to the "
            f"single-process run ({', '.join(names)}), reports equal; overlap kernel "
            f"launches {launches} for {chunks} chunks")
        if device == "cuda" and (launches != calls * chunks or
                                 (calls and not all(r["launches"] for r in ranks))):
            raise SystemExit(f"{tag}: the ranks launched the overlap kernel "
                             f"{[r['launches'] for r in ranks]} times, "
                             f"{calls * chunks} in all expected ({calls} a chunk)")
        if device == "cuda":
            if any(r["stats_launches"] != stat_calls * r["chunks"] for r in ranks):
                raise SystemExit(f"{tag}: the ranks launched the stats kernel "
                                 f"{[r['stats_launches'] for r in ranks]} times for "
                                 f"{[r['chunks'] for r in ranks]} chunks")
            _check_stats_launches(f"{tag} as {nprocs} ranks", stat_calls,
                                  sum(r["stats_launches"] for r in ranks),
                                  sum(r["chunks"] for r in ranks))
            _check_staged(f"{tag} as {nprocs} ranks",
                          counts=sum((Counter(r["staged"]) for r in ranks), Counter()),
                          chunks=sum(r["chunks"] for r in ranks))
        total += launches
    return total


# ---------------------------------------------------------------------------
# the device split and the switches
TWO_DEVICES = "cuda:0,cuda:0"
SE_ALL_FAILED = SE_ALL + ["--failed_out", "failed.fq.gz"]


def phase_devices(work: Path, a1: Path, a2: Path, pairs: int,
                  single_rate: float, dev: str = "cuda") -> int:
    """Phase 13; returns the overlap kernel launches of its pe_merge_corr
    run."""
    two = TWO_DEVICES if dev == "cuda" else f"{dev},{dev}"
    chunks = -(-pairs // PE_CHUNK)
    tag = "pe_merge_corr_x2"
    _reset_launches()
    wall, d = _traced(tag, lambda: _run_pe_cli(
        work, tag, (a1, a2), PE_MERGE_CORR + PE_OUTS, two))
    launches = overlap_cuda.launches
    if dev == "cuda":
        _check_stats_launches(tag, 5, parts=2)
        _check_staged(tag, parts=2)
    names = _same_outputs(tag, work / "pe_merge_corr", d)
    log(f"{tag} over {two}: {pairs} pairs in {wall:.3f} s = "
        f"{pairs / wall:.1f} pairs/s (phase 7 on one device, same call: "
        f"{single_rate:.1f} pairs/s); {len(names)} output files byte-identical to "
        f"phase 7's ({', '.join(names)}), reports equal; overlap kernel launches "
        f"{launches} for {chunks} chunks")
    if dev == "cuda" and launches != 2 * 2 * chunks:
        raise SystemExit(f"{tag}: {launches} overlap kernel launches, {4 * chunks} "
                         "expected (2 parts x 2 calls a chunk)")
    sub = work / "se_sub.fq"  # phase 11's reads
    d1 = _run_se_cli(work, sub, SE_ALL_FAILED, dev, "dev_se_all_one")
    _reset_launches()
    d2 = _run_se_cli(work, sub, SE_ALL_FAILED, two, "dev_se_all_x2")
    if dev == "cuda":
        _check_stats_launches("se_all_x2", 2, parts=2)
        _check_staged("se_all_x2", parts=2)
    names = _same_outputs("se_all_x2", d1, d2)
    log(f"se_all over {two} on phase 11's reads: {len(names)} output files "
        "byte-identical to the one-device run, reports equal")
    fn, args = port_entry.entry(dev)
    got = outputs_to_numpy(fn(*args))
    fn, args = port_entry.entry("cpu")
    port_entry.assert_same_outputs(f"entry() on {dev}", outputs_to_numpy(fn(*args)), got)
    log(f"entry(): the single-end step on {dev} equals its CPU run ({len(got)} "
        "outputs, tolerance 0)")
    port_entry.dryrun(2, two.split(","))
    return launches


# name -> the environment of a run that must equal the default run
SWITCHES = {
    "pack_overlap": {"FQTOOL_TPU_PACK_OVERLAP": "1"},
    "headcache_off": {"FQTOOL_TPU_HEADCACHE": "0"},
}


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` set in os.environ, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def upload_mbps(dev, pinned: bool, nbytes: int = 16 << 20, rounds: int = 5) -> float:
    """MB/s (MiB a second) of one ``nbytes``
    upload to ``dev`` from pageable or page-locked host memory: the fastest
    of ``rounds`` copies, each ending in a synchronize of the card."""
    host = torch.ones(nbytes, dtype=torch.uint8, pin_memory=pinned)
    on_dev = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    on_dev.copy_(host)  # warm the path (context, staging buffers, mappings)
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        on_dev.copy_(host, non_blocking=pinned)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return (nbytes / (1 << 20)) / best


def phase_switches(work: Path, fq: Path, subset: int, se_reads: int,
                   dev: str = "cuda") -> int:
    """Phase 14; returns the overlap kernel launches of its pe_full runs."""
    rates = "not measured (no card)"
    if torch.device(dev).type == "cuda":
        rates = (f"pageable {upload_mbps(dev, False):.1f} MB/s, page-locked "
                 f"{upload_mbps(dev, True):.1f} MB/s")
    log(f"16 MiB upload to {dev}, fastest of 5: {rates}")
    pairs = (work / "as1.fq", work / "as2.fq")  # phase 8's pairs
    head = _head(fq, work / "se_head.fq", se_reads)
    runs = {
        "pe_full": (subset, lambda d: _run_pe_cli(work, d, pairs, PE_FULL, dev)),
        "se_all_ora": (se_reads, lambda d: _run_se_cli(
            work, head, SE_ALL_FAILED + ["--ora"], dev, d)),
    }
    total = 0
    for tag, (n, run) in runs.items():
        calls, stat_calls = (1, 4) if tag == "pe_full" else (0, 2)
        chunks = -(-n // PE_CHUNK)
        for name, env in [("default", {})] + list(SWITCHES.items()):
            _reset_launches()
            t0 = time.perf_counter()
            d = _with_env(env, lambda: run(f"tr_{tag}_{name}"))
            secs = time.perf_counter() - t0
            launches = overlap_cuda.launches
            if dev == "cuda":
                _check_stats_launches(f"{tag} {name}", stat_calls)
                _check_staged(f"{tag} {name}")
            total += launches
            if name == "default":
                default = d
                names = sorted(p.name for p in d.glob("*.fq.gz"))
            else:
                names = _same_outputs(f"{tag} {name}", default, d)
            switches = " ".join(f"{k}={v}" for k, v in env.items()) or "no switch"
            log(f"{tag} {name} ({switches}; {n} records): {secs:.3f} s; "
                f"{DISPATCHED['chunks']} chunks; "
                f"overlap kernel launches {launches}; {len(names)} output files"
                + (" byte-identical to the default run, reports equal"
                   if name != "default" else ""))
            if dev == "cuda" and launches != calls * chunks:
                raise SystemExit(f"{tag} {name}: {launches} overlap kernel launches, "
                                 f"{calls * chunks} expected")
    prof = work / "profile"
    d = _with_env({"FQTOOL_TPU_PROFILE_DIR": str(prof)},
                  lambda: _run_se_cli(work, head, SE_ALL_FAILED + ["--ora"], dev,
                                      "tr_profile"))
    traces = sorted(prof.glob("fqtool_tpu_torch.*.trace.json"))
    if len(traces) != 1 or traces[0].stat().st_size == 0:
        raise SystemExit(f"FQTOOL_TPU_PROFILE_DIR left {traces}")
    _same_outputs("se_all_ora profile", work / "tr_se_all_ora_default", d)
    log(f"FQTOOL_TPU_PROFILE_DIR: {traces[0].name}, {traces[0].stat().st_size} bytes; "
        "outputs byte-identical to the default run")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--subset", type=int, default=50_000)
    ap.add_argument("--reads", type=int, default=2_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 1
    t_start = time.perf_counter()
    _count_chunks()
    phase_card()
    phase_build()
    entry = phase_kernel()
    stats_entry = phase_stats_kernel()
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        r1, r2, launches = phase_main(work, args.pairs)
        phase_subset(work, r1, r2, min(args.subset, args.pairs))
        phase_pe_ops()
        a1, a2, pe_launches, pe_rates = phase_pe_main(work, args.pairs)
        launches += pe_launches
        phase_pe_subsets(work, a1, a2, min(args.subset, args.pairs))
        phase_se_ops()
        fq = phase_se_main(work, args.reads)
        phase_se_subset(work, fq, min(args.subset, args.reads))
        launches += phase_multihost(work, a1, a2, args.pairs, fq, args.reads,
                                    min(args.subset, args.pairs))
        launches += phase_devices(work, a1, a2, args.pairs, pe_rates["pe_merge_corr"])
        launches += phase_switches(work, fq, min(args.subset, args.pairs),
                                   min(150_000, args.reads))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    entry["launches"] = launches
    stats_entry["launches"] = sum(STATS_LAUNCHES)
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, stats_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        sys.exit(rank_main(sys.argv[3:] if sys.argv[2:3] == ["--"] else sys.argv[2:]))
    sys.exit(main())
