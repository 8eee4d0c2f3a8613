"""The traffic generator: deterministic by seed, and its insert law and
quality levels as each cell file states them."""

from __future__ import annotations

import gzip
import json

import numpy as np
import pytest

from conftest import BENCH
from traffic.pairs import (ADAPTER_R1, ADAPTER_R2, PairLaw, bin_table,
                           fastq_bytes, make_and_write, make)

CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def law_of(cell: str) -> PairLaw:
    t = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["traffic"]
    return PairLaw.from_dict({k: v for k, v in t.items() if k != "generator"})


def planes(p):
    return (p.seq1, p.qual1, p.seq2, p.qual2, p.isize)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_pairs(cell):
    law = law_of(cell)
    a = make(law, 3000, 2**31 + 11, threads=1)
    b = make(law, 3000, 2**31 + 11, threads=3)
    c = make(law, 3000, 2**31 + 12)
    assert all(np.array_equal(x, y) for x, y in zip(planes(a), planes(b)))
    assert not np.array_equal(a.seq1, c.seq1)


@pytest.mark.parametrize("cell", CELLS)
def test_insert_law(cell):
    law = law_of(cell)
    isize = make(law, 40_000, 77).isize
    assert isize.min() >= law.insert_min and isize.max() <= law.insert_max
    inside = isize[(isize > law.insert_min) & (isize < law.insert_max)]
    assert abs(np.mean(inside) - law.insert_mean) < 2.5
    assert abs(np.std(inside) - law.insert_sd) < 0.06 * law.insert_sd


@pytest.mark.parametrize("cell", CELLS)
def test_quality_levels(cell):
    law = law_of(cell)
    p = make(law, 20_000, 5)
    for q in (p.qual1, p.qual2):
        levels = set(np.unique(q) - 33)
        if law.qual_bins:
            assert levels == set(law.qual_bins)  # N bases take Q2, a level
        else:
            assert min(levels) >= law.qual_min and max(levels) <= law.qual_max
            assert len(levels) > 30


def test_bins_nearest_level():
    t = bin_table([2, 12, 23, 37])
    assert [int(t[q]) for q in (0, 7, 8, 12, 17, 18, 30, 31, 41)] == \
        [2, 2, 12, 12, 12, 23, 23, 37, 37]


def test_reads_are_the_insert_then_the_adapter():
    law = law_of("pe_merge_corr.cfdna")
    p = make(law, 4000, 9)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    short = np.flatnonzero(p.isize < 100)[:50]
    for r in short:
        k = int(p.isize[r])
        ins1 = p.seq1[r, :k].tobytes()
        ins2 = p.seq2[r, :k].tobytes()[::-1].translate(comp)
        assert sum(a != b for a, b in zip(ins1, ins2)) < 0.1 * k  # ~2 % subs
        tail1 = p.seq1[r, k : k + 20].tobytes()
        tail2 = p.seq2[r, k : k + 20].tobytes()
        assert sum(a != b for a, b in zip(tail1, ADAPTER_R1)) < 5
        assert sum(a != b for a, b in zip(tail2, ADAPTER_R2)) < 5


def test_gzip_files_hold_the_planes(tmp_path):
    law = law_of("pe_readme.small_sample")
    p, n = make_and_write(law, 140_000, 3, str(tmp_path / "a"), str(tmp_path / "b"))
    assert n == (tmp_path / "a").stat().st_size + (tmp_path / "b").stat().st_size
    assert gzip.decompress((tmp_path / "b").read_bytes()) == \
        fastq_bytes(law, p.seq2, p.qual2, 2, 0)


@pytest.mark.parametrize("cell", CELLS)
def test_names_in_the_bcl2fastq_layout(cell):
    law = law_of(cell)
    p = make(law, 50, 4)
    for mate in (1, 2):
        for i, line in zip((0, 49, 123_456), p.names(np.array([0, 49, 123_456]), mate)):
            head, tail = line.tobytes().decode().split(" ")
            inst, run, cell_id, lane, tile, x, y = head[1:].split(":")
            assert head[0] == "@" and f"{inst}:{run}:{cell_id}" == law.name_head
            assert int(lane) == law.lane
            assert len(tile) == len(str(law.tile_first)) and len(x) == len(y) == 5
            assert tail == f"{mate}:N:0:{law.index}"
    w = p.names(np.arange(300_000), 1)
    assert len({r.tobytes() for r in w}) == 300_000
