#!/usr/bin/env python3
"""The port's CLI on one CUDA card, several checkouts timed in turns.

Each ``--checkout NAME=DIR`` (another checkout unpacked with ``git archive
<commit> | tar -x -C build/parent``; ``this=.`` for this one) runs
``fqtool_tpu_torch.main`` in a process of its own on the same generated
input, for each configuration, in the order A B ... B A in every round.  The
wall is taken inside the process, around ``main()`` and a final
``torch.cuda.synchronize()``: interpreter start-up, torch import and the
CUDA context stay outside it, and one small untimed run per checkout builds
its overlap kernel first.  Every run's output files must be byte-identical
to the first checkout's.  Prints the card (nvidia-smi), one line per run, and
a JSON line with the median rate of each checkout and configuration.  Run
from the repository root: ``python3 cli_ab.py --checkout parent=build/parent
--checkout this=.``
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from tests.torch_pairs import write_pairs  # noqa: E402
from tests.torch_reads import write_reads  # noqa: E402

# name -> (paired input, flags): bench.py's configurations of the main paths
CONFIGS = {
    "pe_merge_corr": (True, ["-m", "--merge_output", "merged.fq.gz", "-c",
                             "--unpaired_read1", "up1.fq.gz", "--unpaired_read2",
                             "up2.fq.gz", "--failed_out", "failed.fq.gz"]),
    "pe_full": (True, ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                       "--detect_pe_adapter"]),
    "se_qualtrim": (False, ["-q", "-f", "3", "-t", "2", "--failed_out",
                            "failed.fq.gz"]),
}

# one timed run: the checkout's CLI in this process, the wall around main()
_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from fqtool_tpu_torch.main import main
t0 = time.perf_counter()
rc = main(sys.argv[2:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
print(json.dumps({"rc": rc, "wall": time.perf_counter() - t0}))
"""


def run(checkout: Path, argv, workdir: Path, device: str) -> float:
    workdir.mkdir(parents=True)
    env = dict(os.environ, FQTOOL_TPU_TORCH_DEVICE=device)
    proc = subprocess.run([sys.executable, "-c", _RUN, str(checkout), *argv],
                          cwd=workdir, env=env, capture_output=True, text=True,
                          timeout=900)
    out = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout else {}
    if proc.returncode != 0 or out.get("rc") != 0:
        raise SystemExit(f"{checkout} {' '.join(argv)}: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    return out["wall"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", action="append", required=True,
                    help="NAME=DIR, at least two")
    ap.add_argument("--pairs", type=int, default=300_000)
    ap.add_argument("--reads", type=int, default=600_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--config", action="append", choices=list(CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="FQTOOL_TPU_TORCH_DEVICE of the runs (cpu to rehearse)")
    args = ap.parse_args()
    checkouts = dict(c.split("=", 1) for c in args.checkout)
    checkouts = {name: Path(d).resolve() for name, d in checkouts.items()}
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(), flush=True)
    work = ROOT / "build" / "cli_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        write_pairs(work / "r1.fq", work / "r2.fq", args.pairs, seed=2026,
                    adapters=True)
        write_reads(work / "r.fq", args.reads, seed=2025)
        write_pairs(work / "w1.fq", work / "w2.fq", 2000, seed=1)
        for name, d in checkouts.items():  # builds the checkout's kernel
            run(d, ["-i", str(work / "w1.fq"), "-I", str(work / "w2.fq"),
                    "-o", "o1.fq.gz", "-O", "o2.fq.gz"], work / f"warm_{name}",
                args.device)
        order = list(checkouts) + list(checkouts)[::-1]
        rates: dict = {}
        for cfg in args.config or list(CONFIGS):
            paired, flags = CONFIGS[cfg]
            n = args.pairs if paired else args.reads
            argv = (["-i", str(work / "r1.fq"), "-I", str(work / "r2.fq"),
                     "-o", "o1.fq.gz", "-O", "o2.fq.gz"] if paired else
                    ["-i", str(work / "r.fq"), "-o", "o1.fq.gz"]) + flags
            ref = None
            for rnd in range(args.rounds):
                for k, name in enumerate(order):
                    d = work / f"{cfg}_{rnd}_{k}_{name}"
                    wall = run(checkouts[name], argv, d, args.device)
                    files = {p.name: p.read_bytes() for p in d.glob("*.fq.gz")}
                    ref = ref or files
                    if files != ref:
                        raise SystemExit(f"{cfg}: {name}'s outputs differ from "
                                         f"{order[0]}'s")
                    rates.setdefault(cfg, {}).setdefault(name, []).append(n / wall)
                    print(f"{cfg} round {rnd} {name}: {n} in {wall:.3f} s = "
                          f"{n / wall:.1f} /s; outputs byte-identical", flush=True)
                    shutil.rmtree(d)
        print(json.dumps({cfg: {name: round(statistics.median(v), 1)
                                for name, v in by.items()}
                          for cfg, by in rates.items()}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
