"""Paired-end multi-host runs of the port (``dist/multihost.py``,
``dist/ingest.py``, ``PairEndRunner._run_mh*``, the rank-0 pre-pass with the
two adapter scans split over ranks 0 and 1) on the CPU, against the
paired-end cases of ``tests/test_multihost.py``.

Each case runs ``python -m fqtool_tpu_torch.main`` as 2 or 4 ranks
(subprocesses on 127.0.0.1, ``tests/torch_multihost.py``), every rank sending
its chunks through the overlap analysis, and holds (a) every output file
byte for byte equal to the port's single-process run under the same
environment and the reports equal, and (b) the records and the report equal
to ``fqtool_tpu.main`` run in this process on the same argv.  pe_full also
runs ``fqtool_tpu.main`` as 2 ranks: both packages' merged files are equal
byte for byte.  The inputs come from ``tests/torch_pairs.py``; half of the
pairs start as a pair of the other half does (``plant_mirrored_duplicates``),
so that the duplication report depends on every rank numbering its pairs by
their global index.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from .torch_multihost import (assert_ok, compare_runs, gzip_members, outputs,
                              plant_mirrored_duplicates, plant_repeats, run_jax_ranks)
from .torch_pairs import write_interleaved, write_pairs

PAIRS = 2500
PE_FULL = ["-q", "--kmer", "--kmer_length", "6", "-d", "-a", "--detect_pe_adapter",
           "--unpaired_read1", "up1.fq.gz", "--unpaired_read2", "up2.fq.gz"]
MERGE_CORR = ["-m", "--merge_output", "merged.fq.gz", "-c", "-d",
              "--failed_out", "failed.fq.gz"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("pe_inputs")
    write_pairs(d / "raw1.fq", d / "raw2.fq", PAIRS, seed=71, adapters=True)
    for m in (1, 2):
        plant_mirrored_duplicates(d / f"raw{m}.fq", d / f"r{m}.fq")
        gzip_members(d / f"r{m}.fq", d / f"r{m}_12.fq.gz", 12)
        plant_repeats(d / f"r{m}.fq", d / f"rep{m}.fq")
    write_interleaved(d / "inter.fq", PAIRS, seed=72, adapters=True)
    return d


def _pair(inputs: Path, name1="r1.fq", name2="r2.fq") -> list:
    return ["-i", inputs / name1, "-I", inputs / name2, "-o", "o1.fq.gz",
            "-O", "o2.fq.gz"]


def _inter(inputs: Path) -> list:
    return ["-i", inputs / "inter.fq", "--in_fq_interleaved", "-o", "o1.fq.gz"]


_refs: dict = {}  # argv -> the directory of its reference runs


def _compare(tmp_path: Path, argv, nprocs: int) -> tuple:
    return compare_runs(tmp_path, argv, nprocs, _refs)


def test_pe_merge_correction(inputs, tmp_path):
    """Merge + correction: the insert-size histogram, the duplication
    combine and the correction patches across 2 ranks."""
    names, n = _compare(tmp_path, _pair(inputs) + MERGE_CORR, 2)
    assert names == ["failed.fq.gz", "merged.fq.gz", "o1.fq.gz", "o2.fq.gz"]
    assert n > PAIRS


def test_pe_full_against_fqtool_tpu_ranks(inputs, tmp_path):
    """pe_full (adapter detection split over ranks 0 and 1, k-mers,
    duplication): the port's 2-rank files equal fqtool_tpu's own 2-rank
    files byte for byte."""
    argv = _pair(inputs) + PE_FULL
    names, _ = _compare(tmp_path, argv, 2)
    assert names == ["o1.fq.gz", "o2.fq.gz", "up1.fq.gz", "up2.fq.gz"]
    rep = json.loads((tmp_path / "mh2" / "report.json").read_text())
    assert rep["AdapterTrim"]["AdapterTrimmedReads"] > 0
    assert_ok(run_jax_ranks(argv, tmp_path / "jax_mh2", 2))
    assert outputs(tmp_path / "jax_mh2") == names
    for name in names:
        assert (tmp_path / "jax_mh2" / name).read_bytes() == \
            (tmp_path / "mh2" / name).read_bytes(), name


def test_pe_full_sparse_dup_table(inputs, tmp_path):
    """keylen 17 keeps the duplication table in its sparse map: the merge
    across ranks combines raw keys."""
    _compare(tmp_path, _pair(inputs) + PE_FULL + ["--dup_ana_key_len", "17"], 2)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_pe_planned_ingest_gz(inputs, tmp_path, nprocs):
    """Two multi-member gzip inputs: each rank inflates only its member
    range of both files (dist/ingest.py)."""
    _compare(tmp_path, _pair(inputs, "r1_12.fq.gz", "r2_12.fq.gz") + MERGE_CORR, nprocs)


def test_pe_planned_ingest_interleaved(inputs, tmp_path):
    """Interleaved input: each rank parses only its own spans."""
    names, _ = _compare(tmp_path, _inter(inputs) + [
        "-q", "-c", "--unpaired_read1", "up1.fq.gz", "--failed_out",
        "failed.fq.gz"], 2)
    assert "up1.fq.gz" in names


def test_pe_split(inputs, tmp_path):
    """`-S`: o1/o2 rotate in lockstep after the rank-0 replay; the unpaired
    and failed streams merge as single streams."""
    names, _ = _compare(tmp_path, _pair(inputs) + [
        "-q", "-S", "--splie_file_line", "600", "--max_item_in_pack", "250",
        "--unpaired_read1", "up1.fq.gz", "--failed_out", "failed.fq.gz"], 2)
    assert len([n for n in names if n.endswith(".o2.fq.gz")]) >= 3


def test_pe_split_interleaved(inputs, tmp_path):
    """`-s` on interleaved input: the planner's pair framing agrees with
    the split pack quantum."""
    names, _ = _compare(tmp_path, _inter(inputs) + [
        "-q", "-s", "--split_file_number", "4", "--max_item_in_pack", "300",
        "--unpaired_read1", "up1.fq.gz"], 2)
    assert len([n for n in names if n.endswith(".o1.fq.gz")]) == 4


def test_pe_ora_merge_world_size_invariant(inputs, tmp_path):
    """Merge-mode ORA: post1 samples the merged stream, merged reads and
    unmerged-kept read1 interleaved in emit order; the deferred replay gives
    the single-process sample at 2 ranks."""
    _compare(tmp_path, _pair(inputs, "rep1.fq", "rep2.fq") + [
        "-m", "--merge_output", "merged.fq.gz", "-c", "--ora",
        "--ora_sample", "3"], 2)
    rep = json.loads((tmp_path / "mh2" / "report.json").read_text())
    for sec in ("Read1BeforeFiltering", "MergedAndFiltered"):
        assert rep[sec]["OverrepresentedSequences"], sec
