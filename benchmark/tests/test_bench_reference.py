"""The plain reference against the program's CPU run, record for record and
counter for counter, and the control (the reference with one of the
configuration's guarantees broken) against the reference."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import check
from conftest import BENCH, ROOT
from reference.pe import expected
from traffic.pairs import PairLaw, make_and_write

CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
PAIRS = 20_000  # enough reads for the pre-pass to detect both adapters
SEED = 2**33 + 5


def cell_files(cell):
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    law = PairLaw.from_dict({k: v for k, v in w["traffic"].items()
                             if k != "generator"})
    return w, cfg, law


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_program_on_the_cpu(cell, tmp_path):
    _, cfg, law = cell_files(cell)
    r1, r2 = tmp_path / "r1.fq.gz", tmp_path / "r2.fq.gz"
    pairs, _ = make_and_write(law, PAIRS, SEED, str(r1), str(r2))
    argv = [a.format(r1=r1, r2=r2, dir=tmp_path) for a in cfg["argv"]]
    env = dict(os.environ, FQTOOL_TPU_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    env.pop("FQTOOL_TPU_TRACE", None)
    subprocess.run([sys.executable, "-m", "fqtool_tpu_torch.main", *argv],
                   env=env, check=True, capture_output=True, timeout=600)
    ref = expected(pairs, cfg, "cpu")
    assert check.against_reference(tmp_path, cfg["streams"], ref) == \
        {"records_differ": 0, "counters_differ": 0}
    # the traffic reaches the layers the cell is about
    rep = ref.report()
    if cell == "pe_merge_corr.cfdna":
        assert rep["FilterResult"]["CorrectedBases"] > 0
        assert ref.stream_bytes("merged").count(b"_merged_") > PAIRS // 2
    elif cell == "pe_merge_corr.pcrfree550":
        assert ref.stream_bytes("merged").count(b"_merged_") < PAIRS // 100
    else:
        assert rep["AdapterTrim"]["AdapterTrimmedReads"] > 0
        assert rep["Duplication"]["Histogram"][1] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The control breaks a guarantee of the configuration that the cell's
    traffic exercises (the cell file's ``control``); the comparison must see
    it in the records and in the report."""
    w, cfg, law = cell_files(cell)
    from traffic.pairs import make
    pairs = make(law, PAIRS, SEED)
    ref = expected(pairs, cfg, "cpu")
    ctl = expected(pairs, cfg, "cpu", broken=w["control"])
    from reference.records import records_differ
    recs = sum(records_differ(ctl.stream_bytes(s), ref.stream_bytes(s))
               for s in cfg["streams"])
    counters = check.counters_differ(check.flatten(ctl.report()),
                                     check.flatten(ref.report()))
    assert counters > 0 and recs > 0
