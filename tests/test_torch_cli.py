"""``python -m fqtool_tpu_torch.main`` against ``python -m fqtool_tpu.main``.

Both CLIs run in-process on the same inputs with the same argv; every
output stream must hold the same records and the JSON reports must agree
under ``compare_json``.  The port runs on the CPU here
(``FQTOOL_TPU_TORCH_DEVICE=cpu``); asking for CUDA where there is none is
an error.  ``test_torch_se_cli.py`` covers the single-end options,
``test_torch_pe_cli*.py`` the paired-end stages, ``test_torch_multihost_*.py``
multi-host runs.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from .oracle import compare_json, diff_fastq, read_fastq
from .test_golden_random import gen_fastq
from .torch_pairs import write_pairs
from .torch_reads import ADAPTER, write_reads

REPO = Path(__file__).resolve().parent.parent
OUTS = ("o1.fq.gz", "o2.fq.gz", "up1.fq.gz", "up2.fq.gz", "failed.fq.gz")


def _argv(r1, r2, *flags):
    return ["-i", str(r1), "-I", str(r2), "-o", "o1.fq.gz", "-O", "o2.fq.gz",
            "--unpaired_read1", "up1.fq.gz", "--unpaired_read2", "up2.fq.gz",
            "--failed_out", "failed.fq.gz", *flags]


def _run(main, argv, workdir: Path) -> int:
    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def _run_both(tmp_path: Path, argv, monkeypatch, stdin: Path = None) -> dict:
    """Run both CLIs in ``tmp_path/jax`` and ``tmp_path/torch`` (``stdin``
    feeds /dev/stdin); returns each one's exit code, an argparse exit
    counting as its code."""
    from fqtool_tpu.main import main as jax_main
    from fqtool_tpu_torch.main import main as torch_main
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    rcs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        with open(stdin or os.devnull, "rb") as fh:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(fh))
            try:
                rcs[name] = _run(main, argv, tmp_path / name)
            except SystemExit as e:
                rcs[name] = e.code
    return rcs


def _compare(tmp_path: Path, argv, monkeypatch, stdin: Path = None):
    """Run both CLIs (``stdin`` feeds /dev/stdin) and compare every
    ``*.fq.gz`` output and the JSON reports; returns (report, output names,
    record count)."""
    rcs = _run_both(tmp_path, argv, monkeypatch, stdin)
    assert rcs == {"jax": 0, "torch": 0}, rcs
    return _compare_outputs(tmp_path)


def _compare_outputs(tmp_path: Path):
    """Compare the outputs of both runs of ``_run_both``; returns (report,
    output names, record count)."""
    outputs = sorted(p.name for p in (tmp_path / "jax").glob("*.fq.gz"))
    assert outputs == sorted(p.name for p in (tmp_path / "torch").glob("*.fq.gz"))
    n = 0
    for name in outputs:
        ours = read_fastq(tmp_path / "torch" / name)
        d = diff_fastq(ours, read_fastq(tmp_path / "jax" / name))
        assert not d, f"{name}: " + "\n".join(d)
        n += len(ours)
    with open(tmp_path / "torch" / "report.json") as f:
        ours = json.load(f)
    with open(tmp_path / "jax" / "report.json") as f:
        ref = json.load(f)
    diffs = compare_json(ours, ref)
    assert not diffs, "\n".join(diffs[:40])
    return ours, outputs, n


def test_cli_planted_overlaps(tmp_path, monkeypatch):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 3000, seed=11)
    rep, outputs, n = _compare(tmp_path, _argv(tmp_path / "r1.fq", tmp_path / "r2.fq",
                                               "-q", "-f", "3", "-t", "2"), monkeypatch)
    assert outputs == sorted(OUTS)
    assert rep["InsertSize"]["Unknown"] < 3000 and n > 5000


def test_cli_random_shapes(tmp_path, monkeypatch):
    gen_fastq(tmp_path / "r1.fq", 800, 4, paired_with=tmp_path / "r2.fq")
    _compare(tmp_path, _argv(tmp_path / "r1.fq", tmp_path / "r2.fq",
                             "-q", "--enable_cut_front", "--enable_cut_tail",
                             "-l", "--max_length", "140", "-y", "-F", "2"),
             monkeypatch)


def test_single_end_runs(tmp_path, monkeypatch):
    write_reads(tmp_path / "r.fq", 2000, seed=2)
    rep, _, _ = _compare(tmp_path, ["-i", str(tmp_path / "r.fq"), "-o", "o1.fq.gz",
                                 "-q", "-g", "-a", "--adapter_of_read1",
                                 ADAPTER.decode(), "--failed_out", "failed.fq.gz"],
                      monkeypatch)
    assert rep["Summary"]["BeforeFiltering"]["TotalReads"] == 2000
    assert rep["AdapterTrim"]["AdapterTrimmedReads"] > 0


def test_paired_end_stdin(tmp_path, monkeypatch):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 600, seed=4)
    rep, _, n = _compare(tmp_path, _argv("/dev/stdin", tmp_path / "r2.fq", "-q"),
                         monkeypatch, stdin=tmp_path / "r1.fq")
    assert rep["Summary"]["BeforeFiltering"]["TotalReads"] == 1200 and n > 0


def test_cuda_without_a_card_is_an_error(tmp_path, capsys, monkeypatch):
    import torch

    from fqtool_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a CUDA device")
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cuda")
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 10, seed=1)
    rc = _run(main, _argv(tmp_path / "r1.fq", tmp_path / "r2.fq", "-q"), tmp_path)
    assert rc != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "o1.fq.gz").exists()


def test_cuda_without_a_card_is_an_error_single_end(tmp_path, capsys, monkeypatch):
    import torch

    from fqtool_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a CUDA device")
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cuda")
    write_reads(tmp_path / "r.fq", 10, seed=1)
    rc = _run(main, ["-i", str(tmp_path / "r.fq"), "-o", "o.fq.gz", "-g"], tmp_path)
    assert rc != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "o.fq.gz").exists()


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a CUDA device")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
