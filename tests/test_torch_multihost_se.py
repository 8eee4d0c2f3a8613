"""Single-end multi-host runs of the port (``dist/multihost.py``,
``dist/ingest.py``, ``SingleEndRunner._run_mh*``, the rank-0 pre-pass) on
the CPU, against the cases of ``tests/test_multihost.py``.

Each case runs ``python -m fqtool_tpu_torch.main`` as 2, 3 or 4 ranks
(subprocesses on 127.0.0.1, ``tests/torch_multihost.py``) and holds (a)
every output file byte for byte equal to the port's single-process run under
the same environment and the reports equal, and (b) the records and the
report equal to ``fqtool_tpu.main`` run in this process on the same argv
(it reads its chunk sizes at import, so records are compared, not gzip
bytes).  The inputs come from ``tests/torch_reads.py``; half of the reads
start as a read of the other half does (``plant_mirrored_duplicates``), so
that the duplication report depends on every rank numbering its records by
their global index.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from .torch_multihost import (assert_ok, assert_same_bytes, assert_same_records,
                              compare_runs, gzip_members, plant_mirrored_duplicates,
                              plant_repeats, run_jax_in_process, run_port)
from .torch_reads import ADAPTER, write_reads

READS = 3000


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("se_inputs")
    write_reads(d / "raw.fq", READS, seed=61)
    plant_mirrored_duplicates(d / "raw.fq", d / "r.fq")
    gzip_members(d / "r.fq", d / "r12.fq.gz", 12)
    plant_repeats(d / "r.fq", d / "rep.fq")
    return d


_refs: dict = {}  # argv -> the directory of its reference runs


def _compare(tmp_path: Path, argv, nprocs: int) -> tuple:
    return compare_runs(tmp_path, argv, nprocs, _refs)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_se_quality_dup(inputs, tmp_path, nprocs):
    names, n = _compare(tmp_path, ["-i", inputs / "r.fq", "-o", "out.fq.gz", "-q",
                                   "-f", "3", "-t", "2", "-d",
                                   "--failed_out", "failed.fq.gz"], nprocs)
    assert names == ["failed.fq.gz", "out.fq.gz"] and n == READS


@pytest.mark.parametrize("nprocs", [2, 4])
def test_se_planned_ingest_gz(inputs, tmp_path, nprocs):
    """Multi-member gzip input: each rank inflates only its member range
    (dist/ingest.py), with every single-end stage on."""
    _, n = _compare(tmp_path, ["-i", inputs / "r12.fq.gz", "-o", "out.fq.gz", "-q",
                               "-g", "-x", "-a", "--adapter_of_read1",
                               ADAPTER.decode(), "-d", "--kmer",
                               "--failed_out", "failed.fq.gz"], nprocs)
    assert n == READS


def test_se_planned_ingest_plain(inputs, tmp_path):
    """Plain input splits at raw byte offsets, over 3 ranks."""
    _, n = _compare(tmp_path, ["-i", inputs / "r.fq", "-o", "out.fq.gz", "-q",
                               "-u", "--umi_location", "3", "--umi_length", "8"], 3)
    assert 0 < n <= READS


def test_se_split_by_lines(inputs, tmp_path):
    """`-S`: rank 0 replays the rotation over every pack's read_passed."""
    names, _ = _compare(tmp_path, ["-i", inputs / "r.fq", "-o", "out.fq.gz", "-q",
                                   "-S", "--splie_file_line", "700",
                                   "--max_item_in_pack", "250",
                                   "--failed_out", "failed.fq.gz"], 2)
    assert len([n for n in names if n.endswith(".out.fq.gz")]) >= 3


def test_se_split_by_file_number_fill(inputs, tmp_path):
    """`-s` with more files than the rotation reaches: rank 0 creates the
    trailing empty files as SplitWriter.close does; plain-text output."""
    names, _ = _compare(tmp_path, ["-i", inputs / "r.fq", "-o", "out.fq", "-q",
                                   "-s", "--split_file_number", "10",
                                   "--max_item_in_pack", "800"], 3)
    sizes = [(tmp_path / "mh3" / n).stat().st_size for n in names]
    assert len(names) == 10 and all(sizes[:4]) and not any(sizes[4:]), sizes


def test_se_ora_world_size_invariant(inputs, tmp_path):
    """Post-filter ORA sampling is deferred and replayed against the global
    passing prefix (host/ora_defer.py): the 2-rank report, ORA included,
    equals the single-process one."""
    _compare(tmp_path, ["-i", inputs / "rep.fq", "-o", "out.fq.gz", "-q", "--ora",
                        "--ora_sample", "7"], 2)
    rep = json.loads((tmp_path / "mh2" / "report.json").read_text())
    for sec in ("Read1BeforeFiltering", "Read1AfterFiltering"):
        assert rep[sec]["OverrepresentedSequences"], sec


def test_se_corrupt_input_fails_fast(inputs, tmp_path):
    """Corrupt gzip: every rank exits 255, quickly, never waiting on a dead
    peer: the rank that reads the damage with the gzip error, the others
    with it or with the peer's failure; the single-process run fails alike."""
    data = (inputs / "r12.fq.gz").read_bytes()
    bad = tmp_path / "bad.fq.gz"
    bad.write_bytes(data[: len(data) // 2] + b"GARBAGE"
                    + data[len(data) // 2: len(data) // 2 + 1000])
    argv = ["-i", bad, "-o", "out.fq.gz", "-q"]
    for nprocs in (1, 2):
        res = run_port(argv, tmp_path / f"mh{nprocs}", nprocs, timeout=120)
        for rank, (rc, err) in enumerate(res):
            assert rc == 255, f"rank {rank} rc={rc}:\n{err[-2000:]}"
            assert "gzip" in err.lower() or "multihost peer failure" in err, \
                err[-2000:]
        assert any("gzip" in err.lower() for _, err in res)


def test_se_malformed_tail_surfaces_on_rank0(tmp_path):
    """A trailing seq/qual length mismatch is reported on every rank,
    rank 0 included, and the runs still agree."""
    write_reads(tmp_path / "ok.fq", 256, seed=62)
    recs = (tmp_path / "ok.fq").read_bytes().split(b"\n")[:-1]
    recs[-1] = recs[-1][:-1]  # the last quality one byte short
    inp = tmp_path / "bad.fq"
    inp.write_bytes(b"\n".join(recs) + b"\n")
    argv = ["-i", inp, "-o", "out.fq.gz", "-q"]
    env = {"FQTOOL_TPU_WRITE_UNIT": "64"}  # the 256 records span both ranks
    res = run_port(argv, tmp_path / "mh2", 2, extra_env=env)
    assert_ok(res)
    msg = "base sequnce and quality sequence have different length"
    assert msg in res[1][1], "the owning rank did not report the malformed tail"
    assert msg in res[0][1], "rank 0 did not surface the error:\n" + res[0][1]
    assert_ok(run_port(argv, tmp_path / "single", extra_env=env))
    assert_same_bytes(tmp_path / "single", tmp_path / "mh2")
    run_jax_in_process(argv, tmp_path / "jax")
    assert_same_records(tmp_path / "mh2", tmp_path / "jax")


def test_se_stdin_refused(inputs, tmp_path):
    """Each rank has its own stdin: a multi-host run refuses /dev/stdin."""
    res = run_port(["-i", "/dev/stdin", "-o", "out.fq.gz", "-q"], tmp_path / "mh2", 2,
                   stdin=inputs / "r.fq", timeout=120)
    for rank, (rc, err) in enumerate(res):
        assert rc == 255, f"rank {rank} rc={rc}:\n{err[-2000:]}"
        assert "stdin input is not supported in multi-host runs" in err
    assert not (tmp_path / "mh2" / "out.fq.gz").exists()


@pytest.mark.parametrize("flags", [["-S", "--splie_file_line", "900"],
                                   ["-s", "--split_file_number", "6"],
                                   ["-s", "--split_file_number", "1"]],
                         ids=["by_lines", "by_number", "one_file"])
def test_replay_split_rotation_matches_split_writer(tmp_path, flags):
    """The rank-0 replay gives every pack the file SplitWriter writes it
    to, and as many files, on the same (count, read_passed) sequence."""
    from fqtool_tpu_torch.pipeline.runner import (SplitWriter,
                                                  replay_split_rotation)

    from .torch_pairs import _options
    opt = _options(["-i", "r.fq", "-o", str(tmp_path / "o.fq"), *flags])
    if opt.split.by_file_number:
        opt.split.size = 1000  # what the pre-pass sets from the read count
    rng = np.random.default_rng(63)
    counts = [(c, int(rng.integers(0, c + 1)))
              for c in rng.integers(1, 500, 40).tolist()]
    w = SplitWriter(opt, paired=False)
    expect = []
    for count, passed in counts:
        expect.append(w.working_split)
        w.write(b"@r\nA\n+\nI\n")
        w.mark_processed(passed if opt.split.by_file_lines else count)
    w.close()
    assign, nfiles = replay_split_rotation(opt, counts)
    assert assign == expect
    assert nfiles == len(list(tmp_path.glob("*.o.fq")))


def test_crc32_combine_is_the_crc_of_the_concatenation():
    from fqtool_tpu_torch.dist.multihost import _crc32_combine
    rng = np.random.default_rng(64)
    for la, lb in [(0, 0), (0, 7), (5, 0), (1, 1), (100, 3), (4097, 65537),
                   (1 << 20, 12345)]:
        a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
        assert _crc32_combine(zlib.crc32(a), zlib.crc32(b), lb) == zlib.crc32(a + b)
