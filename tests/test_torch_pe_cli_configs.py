"""Paired-end ``python -m fqtool_tpu_torch.main`` against ``fqtool_tpu.main``:
the bench.py configurations, the paired-end sets of ``test_golden_random.py``,
UMI, split output, interleaved input and stdin.

Both CLIs run in-process on the same input with the same argv; every output
file (split files included) must hold the same records and the JSON reports
must agree under ``compare_json``.  Inputs: planted-overlap pairs whose
reads run past their insert into the TruSeq adapters
(``tests/torch_pairs.py``), and ``gen_fastq``'s adversarial shapes for the
golden-random sets.
"""

from __future__ import annotations

import pytest

from .oracle import read_fastq
from .test_golden_random import gen_fastq
from .test_torch_cli import _argv, _compare, _compare_outputs, _run_both
from .torch_pairs import ADAPTER_R1, ADAPTER_R2, write_interleaved, write_pairs

MERGE = ["-m", "--merge_output", "merged.fq.gz"]
AD = ["--adapter_of_read1", ADAPTER_R1.decode(),
      "--adapter_of_read2", ADAPTER_R2.decode()]

CASES = {
    # bench.py's paired-end configurations
    "pe_merge_corr": MERGE + ["-c"],
    "pe_full": ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                "--detect_pe_adapter"],
    "discard-unmerged-corr": MERGE + ["--discard_unmerged", "-c"],
    # UMI from the index, from either read and from both reads
    "umi-index1": ["-u", "--umi_location", "1", "-q"],
    "umi-read1": ["-u", "--umi_location", "3", "--umi_length", "8", "-c", "-g"],
    "umi-read2": ["-u", "--umi_location", "4", "--umi_length", "6", "--kmer"] + MERGE,
    "umi-per-read": ["-u", "--umi_location", "6", "--umi_length", "8", "-a", "-x",
                     "-d"],
    # split output in packs small enough that the files rotate
    "split-number": ["-s", "--split_file_number", "4", "--max_item_in_pack", "250",
                     "-q", "-c", "--ora"],
    "split-lines": ["-S", "--splie_file_line", "1000", "--max_item_in_pack", "250",
                    "-a", "-d"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_pe_config_matches_jax(tmp_path, monkeypatch, name):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 1500, seed=len(name),
                adapters=True)
    rep, outputs, n = _compare(
        tmp_path, _argv(tmp_path / "r1.fq", tmp_path / "r2.fq", *CASES[name]),
        monkeypatch)
    assert n > 0
    if name.startswith("split-"):
        for mate in ("o1.fq.gz", "o2.fq.gz"):
            files = [o for o in outputs if o.endswith("." + mate)]
            filled = [o for o in files if read_fastq(tmp_path / "torch" / o)]
            assert len(filled) >= 2, files
    if "-m" in CASES[name]:
        assert read_fastq(tmp_path / "torch" / "merged.fq.gz")
    if "-c" in CASES[name]:
        assert rep["FilterResult"]["CorrectedBases"] > 0


# tests/test_golden_random.py:92-111, on its adversarial input
GOLDEN_RANDOM = {
    "pe-all": ["-q", "-a", "-c", "-g", "--unpaired_read1", "up1.fq.gz",
               "--unpaired_read2", "up2.fq.gz", "--failed_out", "failed.fq.gz"],
    "pe-merge": MERGE + ["-c", "-x"],
}


@pytest.mark.parametrize("name", list(GOLDEN_RANDOM))
def test_pe_golden_random_matches_jax(tmp_path, monkeypatch, name):
    gen_fastq(tmp_path / "rand1.fq", 2000, seed=4 if name == "pe-all" else 5,
              paired_with=tmp_path / "rand2.fq")
    _, _, n = _compare(tmp_path, [
        "-i", str(tmp_path / "rand1.fq"), "-I", str(tmp_path / "rand2.fq"),
        "-o", "o1.fq.gz", "-O", "o2.fq.gz", *GOLDEN_RANDOM[name]], monkeypatch)
    assert n > 0


# interleaved input takes no -O, and -m needs -I (config/cli.py:201-205):
# passing pairs go nowhere, unpaired and failed reads are written; -a needs
# its sequences here, since the PE adapter scan would open the absent -I
INTERLEAVED = {
    "alone": [],
    "qual-corr-adapter": ["-q", "-c", "-a", *AD],
    "merge": MERGE,
}


@pytest.mark.parametrize("name", list(INTERLEAVED))
def test_pe_interleaved_matches_jax(tmp_path, monkeypatch, name):
    write_interleaved(tmp_path / "inter.fq", 1500, seed=9, adapters=True)
    argv = ["-i", str(tmp_path / "inter.fq"), "--in_fq_interleaved",
            "-o", "o1.fq.gz", "--unpaired_read1", "up1.fq.gz",
            "--unpaired_read2", "up2.fq.gz", "--failed_out", "failed.fq.gz",
            *INTERLEAVED[name]]
    rcs = _run_both(tmp_path, argv, monkeypatch)
    assert rcs["torch"] == rcs["jax"], rcs
    if name == "merge":
        assert rcs["jax"] != 0
        return
    assert rcs["jax"] == 0
    rep, _, n = _compare_outputs(tmp_path)
    assert rep["Summary"]["BeforeFiltering"]["TotalReads"] == 3000
    if name != "alone":
        assert n > 0 and rep["FilterResult"]["CorrectedBases"] > 0


def test_pe_stdin_merge_matches_jax(tmp_path, monkeypatch):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 800, seed=12, adapters=True)
    rep, outputs, n = _compare(tmp_path, _argv("/dev/stdin", tmp_path / "r2.fq",
                                               *MERGE), monkeypatch,
                               stdin=tmp_path / "r1.fq")
    assert "merged.fq.gz" in outputs and n > 0
