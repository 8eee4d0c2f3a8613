"""The single-end cell's own files: the generator ``traffic/reads.py`` (its
law on a seeded sample, deterministic by seed), the two plain operations of
``reference/plain/`` against the program's (seeded reads and hand-made
edges), ``reference/se.py`` against the program's CPU run over several
chunks, and the control against the reference."""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import check
import run
from conftest import BENCH, ROOT
from reference import se as reference_se
from reference.plain import adapter as plain_adapter
from reference.plain import polyx as plain_polyx
from reference.records import records_differ
from traffic import reads as gen
from traffic.pairs import ADAPTER_R1

CELL = "se_fastp_default.chip75"
SEED = 2**33 + 7
READS = 20_000


def cell_files():
    w = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    return w, cfg, gen.law({k: v for k, v in w["traffic"].items()
                            if k != "generator"})


@pytest.fixture(scope="module")
def sample():
    _, _, law = cell_files()
    return law, gen.make(law, 60_000, SEED)


# ----------------------------------------------------------------------
# the generator's law

def test_read_length_and_fragment_law(sample):
    law, r = sample
    assert r.seq.shape == r.qual.shape == (r.count, 75)
    assert r.bases == r.count * 75
    f = r.frag
    assert f.min() >= law.fragment_min and f.max() <= law.fragment_max
    inside = f[(f > law.fragment_min) & (f < law.fragment_max)]
    assert abs(np.mean(inside) - law.fragment_mean) < 2.5
    assert abs(np.std(inside) - law.fragment_sd) < 0.06 * law.fragment_sd


def test_reads_past_the_fragment_read_adapter_index_p7_then_g(sample):
    law, r = sample
    short = r.frag < law.read_len
    # N(180, 60) below 75 bases: 4.0 %
    assert abs(short.mean() - 0.0401) < 0.005
    past = law.past_fragment() + b"G" * law.read_len
    assert past.startswith(ADAPTER_R1 + b"ATCACGAT" + gen.P7_REST)
    rows = np.flatnonzero(short & (r.dark == law.read_len))
    mism = total = 0
    for i in rows:
        k = int(r.frag[i])
        got = r.seq[i, k:].tobytes()
        mism += sum(a != b for a, b in zip(got, past))
        total += len(got)
    assert total > 50_000 and mism < 0.03 * total  # substitutions and N runs


def test_dark_share(sample):
    law, r = sample
    dark = r.dark < law.read_len
    assert abs(dark.mean() - law.dark_share) < 0.003
    assert r.dark[dark].min() >= law.dark_from
    rows = np.flatnonzero(dark)
    cols = np.arange(law.read_len)[None, :] >= r.dark[rows, None]
    tail = r.seq[rows][cols]
    assert np.mean(tail == ord("G")) > 0.98


def test_names_in_the_bcl2fastq_layout(sample):
    law, r = sample
    for line in r.names(np.array([0, 49, 123_456])):
        head, tail = line.tobytes().decode().split(" ")
        inst, run_id, flowcell, lane, tile, x, y = head[1:].split(":")
        assert head[0] == "@" and f"{inst}:{run_id}:{flowcell}" == law.name_head
        assert int(lane) == law.lane == 3
        assert len(tile) == 5 and len(x) == len(y) == 5
        assert tail == f"1:N:0:{law.index}"


def test_qualities_only_at_the_bin_levels(sample):
    law, r = sample
    assert set((np.unique(r.qual) - 33).tolist()) == set(law.qual_bins)


def test_same_seed_same_bytes_whatever_the_threads(tmp_path):
    _, _, law = cell_files()
    n = gen.BLOCK + 3000  # two blocks
    a = gen.make(law, n, 2**31 + 11, threads=1)
    b, written = gen.make_and_write(law, n, 2**31 + 11, str(tmp_path / "r1.fq.gz"),
                                    threads=3)
    c = gen.make(law, 3000, 2**31 + 12)
    for x, y in ((a.seq, b.seq), (a.qual, b.qual), (a.frag, b.frag), (a.dark, b.dark)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.seq[:3000], c.seq)
    assert written == (tmp_path / "r1.fq.gz").stat().st_size
    from traffic.pairs import fastq_bytes
    assert gzip.decompress((tmp_path / "r1.fq.gz").read_bytes()) == \
        fastq_bytes(law, a.seq, a.qual, 1, 0)


# ----------------------------------------------------------------------
# the plain operations against the program's

def _port_adapter(seq, rlen, adapter):
    from fqtool_tpu_torch.ops import adapter as ops
    return ops.trim_by_sequence(seq, rlen.to(torch.int32), adapter)


def _port_polyg(seq, rlen, *args):
    from fqtool_tpu_torch.ops import polyx as ops
    return ops.trim_polyg(seq, rlen.to(torch.int32), *args)


def _same_adapter_trim(seq, rlen, adapter):
    want = _port_adapter(seq, rlen, adapter)
    got = plain_adapter.trim_by_sequence(seq, rlen, adapter)
    assert torch.equal(got.found, want.found)
    assert torch.equal(got.rlen, want.rlen.long())
    assert torch.equal(got.pos[got.found], want.pos.long()[want.found])
    return got


def _same_polyg_trim(seq, rlen, *args):
    want = _port_polyg(seq, rlen, *args)
    got = plain_polyx.trim_polyg(seq, rlen, *args)
    assert torch.equal(got.trimmed, want.trimmed)
    assert torch.equal(got.rlen, want.rlen.long())
    assert torch.equal(got.trim_len[got.trimmed], want.trim_len.long()[want.trimmed])
    return got


def _random_rows(sample, seed):
    """The sample's reads with lengths drawn from 0 to the read length."""
    _, r = sample
    rng = np.random.default_rng(seed)
    idx = rng.choice(r.count, 8000, replace=False)
    seq = torch.from_numpy(r.seq[idx])
    rlen = torch.from_numpy(rng.integers(0, r.seq.shape[1] + 1, len(idx)))
    full = torch.rand(len(idx), generator=torch.Generator().manual_seed(seed)) < 0.5
    return seq, torch.where(full, torch.full_like(rlen, r.seq.shape[1]), rlen)


@pytest.mark.parametrize("adapter", [ADAPTER_R1, ADAPTER_R1[:14], ADAPTER_R1[:9],
                                     ADAPTER_R1[:6], ADAPTER_R1[:3]])
def test_adapter_scan_equals_the_program_on_seeded_reads(sample, adapter):
    seq, rlen = _random_rows(sample, 5)
    got = _same_adapter_trim(seq, rlen, adapter)
    if len(adapter) >= 16:
        assert int(got.found.sum()) > 200


def _read(prefix: bytes, L: int = 75, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    fill = bytes(b"ACGT"[i] for i in rng.integers(0, 4, L))
    return (prefix + fill)[:L]


def _tensor(reads):
    return torch.tensor([list(x) for x in reads], dtype=torch.uint8)


@pytest.mark.parametrize("start", [-4, -3, -2, -1, 0])
def test_adapter_starting_before_or_at_the_read(start):
    """A read that begins at base ``-start`` of the adapter: the match is at
    ``start``; below 0 it empties the read."""
    reads = [_read(ADAPTER_R1[-start:], seed=s) for s in range(8)]
    seq = _tensor(reads)
    got = _same_adapter_trim(seq, torch.full((8,), 75), ADAPTER_R1)
    assert got.found.all() and (got.pos == start).all()
    assert (got.rlen == 0).all()


@pytest.mark.parametrize("extra", [0, 1])
def test_adapter_at_the_mismatch_limit(extra):
    """At position 40 the scan compares 33 bases and allows 33 / 8 = 4
    mismatches: a fifth one loses the match there."""
    ad = bytearray(ADAPTER_R1)
    for i in (3, 11, 19, 27, 31)[: 4 + extra]:
        ad[i] = ord("T") if ad[i] != ord("T") else ord("C")
    reads = [(_read(b"", 40, seed=s) + bytes(ad) + b"CA")[:75] for s in range(8)]
    got = _same_adapter_trim(_tensor(reads), torch.full((8,), 75), ADAPTER_R1)
    at40 = got.found & (got.pos == 40)
    if extra:
        assert not at40.any()
    else:
        assert at40.all()


def test_adapter_scan_on_short_reads():
    """Reads of no more than the four bases a match needs find nothing."""
    seq = _tensor([ADAPTER_R1[:75].ljust(75, b"A")] * 6)
    rlen = torch.tensor([0, 1, 3, 4, 5, 9])
    got = _same_adapter_trim(seq, rlen, ADAPTER_R1)
    assert got.found.tolist() == [False, False, False, False, True, True]


@pytest.mark.parametrize("params", [(10, 1, 10), (10, 3, 4), (5, 2, 3)])
def test_polyg_equals_the_program_on_seeded_reads(sample, params):
    seq, rlen = _random_rows(sample, 7)
    # G tails with mismatches sprinkled in, over a fifth of the rows
    rng = np.random.default_rng(11)
    s = seq.numpy().copy()
    for i in rng.choice(len(s), len(s) // 5, replace=False):
        k = int(rng.integers(5, 60))
        s[i, -k:] = ord("G")
        for j in rng.integers(75 - k, 75, int(rng.integers(0, 4))):
            s[i, j] = ord("A")
    got = _same_polyg_trim(torch.from_numpy(s), rlen, *params)
    assert int(got.trimmed.sum()) > 100


@pytest.mark.parametrize("case,trimmed,new_len", [
    (b"C" * 60 + b"G" * 15, True, 60),
    (b"C" * 60 + b"GGGGGGGAGGGGGGG", True, 60),       # one mismatch: the budget
    (b"C" * 60 + b"GGGGGGGAGGAGGGG", False, 75),      # two within ten bases
    (b"C" * 65 + b"AGGGGGGGGG", True, 66),            # the mismatch is not cut
    # the scan's length counts the base it breaks at: eight G, one C
    # allowed and the breaking C make ten; seven G make nine
    (b"C" * 67 + b"G" * 8, True, 67),
    (b"C" * 68 + b"G" * 7, False, 75),
])
def test_polyg_at_the_budget_edge(case, trimmed, new_len):
    got = _same_polyg_trim(_tensor([case]), torch.tensor([75]), 10, 1, 10)
    assert bool(got.trimmed[0]) == trimmed and int(got.rlen[0]) == new_len


def test_polyg_on_reads_shorter_than_the_scan():
    """A scan that runs off the read's 5' end counts one step past it."""
    seq = _tensor([b"G" * 75] * 5)
    rlen = torch.tensor([0, 5, 8, 9, 10])
    got = _same_polyg_trim(seq, rlen, 10, 1, 10)
    assert got.trimmed.tolist() == [False, False, False, True, True]
    assert got.rlen.tolist() == [0, 5, 8, 0, 0]


# ----------------------------------------------------------------------
# the reference against the program, and the control

def test_reference_equals_the_program_over_several_chunks(tmp_path):
    w, cfg, law = cell_files()
    inputs = [tmp_path / name for name in gen.INPUTS]
    reads, _ = gen.make_and_write(law, READS, SEED, *map(str, inputs))
    argv = run.job_argv(cfg, tmp_path, inputs)
    # chunks of 8,192 reads, two a pack: the job runs in three chunks
    env = dict(os.environ, FQTOOL_TPU_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT),
               FQTOOL_TPU_SE_CHUNK="8192", FQTOOL_TPU_SE_PACK_CHUNKS="2")
    env.pop("FQTOOL_TPU_TRACE", None)
    subprocess.run([sys.executable, "-m", "fqtool_tpu_torch.main", *argv],
                   env=env, check=True, capture_output=True, timeout=600)
    ref = reference_se.expected(reads, cfg, "cpu")
    assert check.against_reference(tmp_path, cfg["streams"], ref) == \
        {"records_differ": 0, "counters_differ": 0}
    rep = ref.report()
    assert rep["AdapterTrim"]["AdapterTrimmedReads"] > 0.02 * READS
    assert rep["PolyxTrimming"]["PolyxTrimmedReads"]["G"] > 0.005 * READS
    assert rep["FilterResult"]["TooManyNReads"] > 0
    assert rep["Duplication"]["Histogram"][1] > 0


def test_the_control_leaves_the_adapters_in(sample):
    _, cfg, _ = cell_files()
    law, r = sample
    small = gen.Reads(law, r.seq[:READS], r.qual[:READS], r.frag[:READS],
                      r.dark[:READS])
    ref = reference_se.expected(small, cfg, "cpu")
    ctl = reference_se.expected(small, cfg, "cpu", broken="adapter_trim")
    assert ctl.report()["AdapterTrim"]["AdapterTrimmedReads"] == 0
    assert records_differ(ctl.stream_bytes("out1"), ref.stream_bytes("out1")) > \
        0.02 * READS
    assert check.counters_differ(check.flatten(ctl.report()),
                                 check.flatten(ref.report())) > 0


# ----------------------------------------------------------------------
# the cell's entries in BENCHMARK.json and its readers

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SE_METRICS = {"se_prep_s": ("se_prep",), "se_dispatch_s": ("se_dispatch",),
              "se_device_wait_s": ("se_device_wait",), "se_emit_s": ("se_emit",),
              "se_fold_s": ("se_fold",), "se_fold_stats_s": ("se_fold_stats",),
              "se_fold_dup_s": ("se_fold_dup",), "se_fold_count_s": ("se_fold_count",),
              "se_fold_route_s": ("se_fold_route",),
              "se_card_unfed_fold_s": ("card_unfed.se_fold",)}


def test_the_cell_reports_its_metrics():
    cell = run.load_cell(CELL)
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s", "device_s_per_gbp"}
    assert {m["name"] for m in cell["per_layer"]} == \
        set(SE_METRICS) | {"throughput.chip75"}
    for m in cell["per_layer"]:
        assert m["workloads"] == [CELL] and m["moves"] == "device_s_per_gbp"


@pytest.mark.parametrize("name", sorted(SE_METRICS))
def test_se_stage_reader(name):
    rec = json.loads((BENCH / "tests" / "data" / "traced_record.json").read_text())
    assert run.reader(name)(rec) is None  # a paired-end run has no such stage
    rec["stages"] = {"se_prep": 0.1, "se_dispatch": 0.2, "se_device_wait": 0.3,
                     "se_emit": 0.4, "se_fold": 0.5, "se_fold_stats": 0.6,
                     "se_fold_dup": 0.7, "se_fold_count": 0.8, "se_fold_route": 0.9,
                     "card_unfed.se_fold": 1.0, "se_fold_x": 9.0}
    (stage,) = SE_METRICS[name]
    assert run.reader(name)(rec) == pytest.approx(rec["stages"][stage] / rec["gbp"])


def test_throughput_chip75_reads_the_wall_rate():
    rec = json.loads((BENCH / "tests" / "data" / "traced_record.json").read_text())
    assert run.reader("throughput.chip75")(rec) == run.reader("throughput")(rec)
