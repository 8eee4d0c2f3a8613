"""Program entry point: ``python -m fqtool_tpu_torch.main``, same argv as
``python -m fqtool_tpu.main``.

CLI parse -> the multi-host process group, if configured (dist/multihost.py)
-> stdin spooling -> evaluation pre-passes (read length, read number for
split sizing, ORS, the paired-end adapter scan; reference:
src/main.cpp:128-143; once across a multi-host group, broadcast from rank 0)
-> the single-end or paired-end runner on one torch device.  The device comes
from ``FQTOOL_TPU_TORCH_DEVICE`` (default ``cuda``; every rank of a multi-host
run on one host shares it); asking for CUDA where there is none is an error,
never a silent run on the CPU.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from .config.cli import parse_args
from .config.options import Options, OptionError
from .host import evaluator
from .io.fastq import FastqIOError

from .pipeline.runner import loginfo


def device_from_env() -> str:
    """The torch device named by FQTOOL_TPU_TORCH_DEVICE (default cuda)."""
    import torch

    name = os.environ.get("FQTOOL_TPU_TORCH_DEVICE", "cuda")
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise OptionError(f"FQTOOL_TPU_TORCH_DEVICE={name}, but torch sees no "
                          "CUDA device")
    return name


def _spool_stdin(opt: Options) -> Optional[str]:
    """Spool /dev/stdin to a temp file so the pre-passes and the main pass
    can each open the input independently (the reference shares one stdin
    FILE* between them, fqreader.cpp:51-53).  Gzip is sniffed from the magic
    bytes.  Only the literal path "/dev/stdin" is recognized."""
    if opt.in1 != "/dev/stdin" and opt.in2 != "/dev/stdin":
        return None
    from .dist import multihost
    if multihost.active() is not None:
        # each rank has its own stdin; striping one stream across hosts
        # needs a shared file path
        raise OptionError("stdin input is not supported in multi-host runs")
    if opt.in1 == "/dev/stdin" and opt.in2 == "/dev/stdin":
        # one stream cannot carry two reads of a pair
        raise OptionError("-i and -I cannot both read from /dev/stdin")
    import shutil
    import tempfile

    src = sys.stdin.buffer
    head = src.read(2)
    suffix = ".fq.gz" if head == b"\x1f\x8b" else ".fq"
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    try:
        tmp.write(head)
        shutil.copyfileobj(src, tmp, 1 << 20)
        tmp.close()
    except BaseException:
        # ENOSPC / broken pipe mid-spool: don't leak the partial temp file
        tmp.close()
        os.unlink(tmp.name)
        raise
    if opt.in1 == "/dev/stdin":
        opt.in1 = tmp.name
    if opt.in2 == "/dev/stdin":
        opt.in2 = tmp.name
    return tmp.name


def _activate_headcache(opt: Options) -> None:
    """Cache the head packs the pre-passes consume, framed as the main pass
    reads them, so every input byte is inflated and tokenized once
    (io/headcache.py).  Skipped for multi-host runs (inputs go through the
    region planner, dist/ingest.py) and interleaved input (record-framed, not
    pack-framed), and only worth it when a pre-pass reads a substantial head
    (the ORS prefix, the PE adapter scan, the split-sizing record count)."""
    from .dist import multihost
    if multihost.active() is not None:
        return
    if opt.interleaved_input:
        return
    if not (opt.over_rep.enabled or opt.adapter.enable_detect_for_pe
            or opt.split.by_file_number):
        return
    from .io import headcache

    if opt.is_paired():
        from .pipeline.pe_runner import main_pack_reads
    else:
        from .pipeline.runner import main_pack_reads
    pack_reads = main_pack_reads(opt)
    headcache.activate(opt.in1, pack_reads, opt.phred64)
    if opt.in2:
        headcache.activate(opt.in2, pack_reads, opt.phred64)


def _prepass(opt: Options, skip_r2_detect: bool = False) -> None:
    """Evaluation pre-passes (main.cpp:128-143).  The read-number estimate
    is consumed only by -s split sizing (main.cpp:132-135).
    ``skip_r2_detect``: a multi-host peer is running the R2 adapter scan
    concurrently (_prepass_multihost)."""
    evaluator.evaluate_read_len(opt)
    if opt.split.by_file_number:
        evaluator.evaluate_read_num(opt)
        opt.split.size = max(opt.est.reads_num // max(opt.split.number, 1), 1)
        loginfo(f"total reds: {opt.est.reads_num} split size: {opt.split.size}")
    if opt.over_rep.enabled:
        evaluator.evaluate_over_rep_seqs(opt)
    if opt.adapter.enable_detect_for_pe:
        if skip_r2_detect:
            evaluator.evaluate_adapter_seq(opt, False)
            return
        # independent full-prefix scans of R1 and R2 (the reference runs
        # them back to back, main.cpp:141-142); each writes only its own
        # opt.adapter field and the scan path is matrix/native code that
        # releases the GIL, so two threads overlap cleanly
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as ex:
            f1 = ex.submit(evaluator.evaluate_adapter_seq, opt, False)
            f2 = ex.submit(evaluator.evaluate_adapter_seq, opt, True)
            f1.result()
            f2.result()


# every option field the pre-passes write -- the broadcast payload of the
# rank-0-only multihost prepass (anything missing here would silently
# diverge between ranks, so keep in sync with _prepass)
_PREPASS_FIELDS = (
    ("est", "seq_len1"), ("est", "seq_len2"), ("est", "reads_num"),
    ("est", "illumina_adapter"), ("split", "size"),
    ("over_rep", "over_rep_seq_count_r1"), ("over_rep", "over_rep_seq_count_r2"),
    ("adapter", "detected_adapter_seq_r1"), ("adapter", "detected_adapter_seq_r2"),
)


def _prepass_multihost(opt: Options, mh) -> None:
    """The pre-passes run once ACROSS the group (the reference runs them
    once before its worker threads start, main.cpp:128-143) and the handful
    of derived values is broadcast from rank 0.  The one splittable piece --
    PE adapter detection is two independent full-prefix scans of R1 and R2
    -- runs on ranks 0 and 1 concurrently; rank 0 merges rank 1's two fields
    in the gather before broadcasting."""
    from .host import tracing
    split_detect = opt.adapter.enable_detect_for_pe and mh.world >= 2
    if mh.rank == 0:
        _prepass(opt, skip_r2_detect=split_detect)
        part = None
    elif mh.rank == 1 and split_detect:
        evaluator.evaluate_adapter_seq(opt, True)
        part = {"adapter.detected_adapter_seq_r2":
                opt.adapter.detected_adapter_seq_r2,
                "est.illumina_adapter": opt.est.illumina_adapter}
    else:
        part = None
    gathered = mh.gather(part)
    if mh.rank == 0:
        if split_detect and gathered[1]:
            opt.adapter.detected_adapter_seq_r2 = \
                gathered[1]["adapter.detected_adapter_seq_r2"]
            opt.est.illumina_adapter = (opt.est.illumina_adapter
                                        or gathered[1]["est.illumina_adapter"])
        mh.broadcast({f"{s}.{f}": getattr(getattr(opt, s), f)
                      for s, f in _PREPASS_FIELDS})
    else:
        for key, val in mh.broadcast().items():
            s, f = key.split(".")
            setattr(getattr(opt, s), f, val)
    tracing.mark("prepass_broadcast_done")


def _run(opt: Options, device: str) -> None:
    from .dist import multihost
    from .host.tracing import stage
    from .io import headcache

    try:
        _activate_headcache(opt)
        mh = multihost.active()
        with stage("prepass"):
            if mh is not None:
                _prepass_multihost(opt, mh)
            else:
                _prepass(opt)
        # SE/PE dispatch (processor.cpp:10-19)
        if opt.is_paired():
            from .pipeline.pe_runner import PairEndRunner
            PairEndRunner(opt, device).run()
        else:
            from .pipeline.runner import SingleEndRunner
            SingleEndRunner(opt, device).run()
    finally:
        # drop any cache the pipeline did not drain: a stale entry would
        # alias a reused path in a later in-process run
        headcache.discard_all()


def run(opt: Options, device: str) -> None:
    from .dist import multihost
    from .io.fastq import set_worker_threads

    # -w sizes the shared host pool (deflate/format)
    set_worker_threads(opt.thread)
    # the multi-host process group, if configured, before any other work:
    # every rank connects to rank 0 here (FQTOOL_TPU_COORDINATOR, _NPROCS,
    # _PROC_ID)
    multihost.active()

    # wall-clock stamps around the run (pre-passes, main pass and merge
    # inside; interpreter and torch start-up outside) and the per-rank marks
    # of host/tracing.py, written to FQTOOL_TPU_TIMING_JSON when it is set
    timing_path = os.environ.get("FQTOOL_TPU_TIMING_JSON")
    t_run_begin = time.time()

    spooled = _spool_stdin(opt)
    try:
        _run(opt, device)
    finally:
        if spooled is not None:
            os.unlink(spooled)
        if timing_path:
            import json

            from .host import tracing
            with open(timing_path, "w") as f:
                json.dump({"t_run_begin": t_run_begin,
                           "t_done": time.time(),
                           "marks": tracing.marks()}, f)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        opt = parse_args(argv)
        device = device_from_env()
        loginfo(f"fqtool_tpu_torch on {device}")
        run(opt, device)
    except (OptionError, FastqIOError) as e:
        # reference: util::errorExit prints and exits -1 (util.h:303-306)
        sys.stderr.write(f"error: {e}\n")
        return 255
    except ConnectionError as e:
        # a multihost peer died (e.g. clean FastqIOError exit on its rank):
        # fail this rank cleanly instead of dumping a socket traceback
        sys.stderr.write(f"error: multihost peer failure: {e}\n")
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
