"""Single-end ``python -m fqtool_tpu_torch.main`` against ``fqtool_tpu.main``.

Both CLIs run in-process on the same ``gen_fastq`` input (lengths from 1 to
163, N bases, polyG/polyA tails) with the same argv; every output file
(split files included) must hold the same records and the JSON reports must
agree under ``compare_json``.  The port runs on the CPU here
(``FQTOOL_TPU_TORCH_DEVICE=cpu``).
"""

from __future__ import annotations

import pytest

from .oracle import read_fastq
from .test_golden_random import gen_fastq
from .test_torch_cli import _compare
from .torch_reads import ADAPTER

AD = ADAPTER.decode()

# the single-end argv sets of test_golden_random.py, then the options that
# only single-end runs reach here: UMI from the index and from the read,
# split output by file count and by lines (packs small enough that the
# files rotate), and -a with no sequence
CASES = {
    "trims-filters-polygx": ["-q", "-f", "2", "-t", "1", "-l", "-y", "-g", "-x",
                             "--failed_out", "failed.fq.gz"],
    "cuts-adapter": ["-q", "--enable_cut_front", "--enable_cut_tail", "-a",
                     "--adapter_of_read1", AD],
    "cut-right-dup": ["-q", "--enable_cut_right", "-d"],
    "umi-index1": ["-u", "--umi_location", "1", "-q", "--failed_out", "failed.fq.gz"],
    "umi-read1-kmer": ["-u", "--umi_location", "3", "--umi_length", "8", "-g",
                       "--kmer", "--kmer_length", "5", "-d", "--dup_ana_key_len", "17"],
    "split-number": ["-s", "--split_file_number", "3", "-q", "-x", "--ora",
                     "--max_item_in_pack", "500"],
    "split-lines": ["-S", "--splie_file_line", "300", "-q", "-d",
                    "--max_item_in_pack", "250"],
    "adapter-without-sequence": ["-a", "-q", "-g"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_se_cli_matches_jax(tmp_path, monkeypatch, name):
    fq = tmp_path / "rand.fq"
    gen_fastq(fq, 1500, seed=len(name))
    rep, outputs, n = _compare(
        tmp_path, ["-i", str(fq), "-o", "out.fq.gz", *CASES[name]], monkeypatch)
    assert n > 0
    if name.startswith("split-"):
        filled = [o for o in outputs
                  if read_fastq(tmp_path / "torch" / o)]
        assert len(filled) > 1, outputs
    if name == "split-number":
        assert len(outputs) == 3 and len(filled) == 3, outputs


def test_se_cli_stdin(tmp_path, monkeypatch):
    fq = tmp_path / "rand.fq"
    gen_fastq(fq, 1000, seed=7)
    rep, _, n = _compare(tmp_path, ["-i", "/dev/stdin", "-o", "out.fq.gz", "-q",
                                    "-g", "--ora"], monkeypatch, stdin=fq)
    assert rep["Summary"]["BeforeFiltering"]["TotalReads"] == 1000 and n > 0
