"""Every metric reader of BENCHMARK.json on a recorded traced-run record,
and the reduction of a device trace."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, ROOT
import run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the metrics of BENCHMARK.json, and those kept as readers for later cells
NAMES = sorted({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
               | {p.stem for p in (BENCH / "metrics").glob("*.py")})


def record():
    return json.loads((BENCH / "tests" / "data" / "traced_record.json").read_text())


@pytest.mark.parametrize("name", NAMES)
def test_every_metric_has_a_reader(name):
    assert callable(run.reader(name))


def test_readers_on_a_traced_record():
    rec = record()
    got = {n: run.reader(n)(rec) for n in NAMES}
    assert got["throughput"] == pytest.approx(12.0 / 4.395389152000007)
    assert got["setup_s"] == 6.1
    assert got["startup_s"] is None  # in-process jobs have no start-up
    assert got["dispatch_s"] == pytest.approx(3.551 / 0.012)
    assert got["fold_s"] == pytest.approx(0.028 / 0.012)
    assert got["format_merged_s"] == pytest.approx(0.142 / 0.012)
    assert got["device_idle"] == pytest.approx(100 * (1 - 0.0521 / 4.395389152000007))
    least = 25680000 / 3.35e12
    assert got["overlap_kernel_roofline"] == pytest.approx(100 * least / 0.00041)
    assert got["overlap_kernel_roofline.cfdna"] == got["overlap_kernel_roofline"]
    assert got["throughput.cfdna"] == got["throughput"]
    assert got["device_s_per_gbp"] == pytest.approx(0.0521 / 0.012)


def test_readers_find_nothing_to_read():
    rec = record()
    rec["stages"] = {}
    rec["device"] = {}
    for n in ("prepass_s", "fold_s", "gzip_out_s", "device_idle",
              "overlap_kernel_roofline", "overlap_kernel_roofline.cfdna",
              "device_s_per_gbp"):
        assert run.reader(n)(rec) is None
    rec["startup_s"] = [2.0, 4.0]
    assert run.reader("startup_s")(rec) == 3.0


def test_reduce_events():
    ev = [("k_a", 0.0, 10.0), ("overlap_kernel", 5.0, 20.0),
          ("Memcpy HtoD", 50.0, 60.0), ("k_b", 55.0, 58.0), ("k_c", 100.0, 101.0)]
    d = run.reduce_events(ev)
    assert d["busy_s"] == pytest.approx(31e-6)  # 0-20, 50-60, 100-101
    assert d["overlap_kernel_s"] == pytest.approx(15e-6)
    assert d["launches"] == 1
    assert d["idle_gaps"] == [("after Memcpy HtoD", pytest.approx(40e-6)),
                              ("after overlap_kernel", pytest.approx(30e-6))]
    assert d["device_ops"][0] == ("overlap_kernel", pytest.approx(15e-6))


def test_overlap_bytes_counts_both_scans_with_merging():
    one = run.overlap_bytes(16_384, 150, 1)
    assert one == 16_384 * (300 + 8 + 1 + 12)
    assert run.overlap_bytes(16_384, 150, 2) == 2 * one
