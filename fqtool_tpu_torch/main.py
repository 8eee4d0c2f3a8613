"""Program entry point: ``python -m fqtool_tpu_torch.main``, same argv as
``python -m fqtool_tpu.main``.

CLI parse -> refusal of multi-host runs -> stdin spooling -> evaluation
pre-passes (read length, read number for split sizing, ORS, the paired-end
adapter scan; reference: src/main.cpp:128-143) -> the single-end or
paired-end runner on one torch device.  The device comes from
``FQTOOL_TPU_TORCH_DEVICE`` (default ``cuda``); asking for CUDA where there is
none is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from .config.cli import parse_args
from .config.options import Options, OptionError
from .host import evaluator
from .io.fastq import FastqIOError

from .pipeline.runner import loginfo


def _refused() -> Optional[str]:
    """The run mode this package cannot run yet, or None: a multi-host run
    (the environment of ``fqtool_tpu``'s multi-host launcher)."""
    multi_host = bool(os.environ.get("FQTOOL_TPU_COORDINATOR")) and \
        int(os.environ.get("FQTOOL_TPU_NPROCS", "0") or 0) > 1
    return "multi-host runs (FQTOOL_TPU_COORDINATOR)" if multi_host else None


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
    (io/headcache.py).  Skipped for interleaved input (record-framed, not
    pack-framed), and only worth it when a pre-pass reads a substantial head
    (the ORS prefix, the PE adapter scan, the split-sizing record count)."""
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


def _prepass(opt: Options) -> None:
    """Evaluation pre-passes (main.cpp:128-143).  The read-number estimate
    is consumed only by -s split sizing (main.cpp:132-135)."""
    evaluator.evaluate_read_len(opt)
    if opt.split.by_file_number:
        evaluator.evaluate_read_num(opt)
        opt.split.size = max(opt.est.reads_num // max(opt.split.number, 1), 1)
        loginfo(f"total reds: {opt.est.reads_num} split size: {opt.split.size}")
    if opt.over_rep.enabled:
        evaluator.evaluate_over_rep_seqs(opt)
    if opt.adapter.enable_detect_for_pe:
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


def _run(opt: Options, device: str) -> None:
    from .host.tracing import stage
    from .io import headcache

    try:
        _activate_headcache(opt)
        with stage("prepass"):
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
    from .io.fastq import set_worker_threads

    # -w sizes the shared host pool (deflate/format)
    set_worker_threads(opt.thread)
    spooled = _spool_stdin(opt)
    try:
        _run(opt, device)
    finally:
        if spooled is not None:
            os.unlink(spooled)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        refused = _refused()
        if refused is not None:
            sys.stderr.write(f"not yet ported in fqtool_tpu_torch: {refused}\n")
            return 255
        opt = parse_args(argv)
        device = device_from_env()
        loginfo(f"fqtool_tpu_torch on {device}")
        run(opt, device)
    except (OptionError, FastqIOError) as e:
        # reference: util::errorExit prints and exits -1 (util.h:303-306)
        sys.stderr.write(f"error: {e}\n")
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
