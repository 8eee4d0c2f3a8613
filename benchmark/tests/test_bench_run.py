"""A whole run of a cell, here on the CPU at a tiny size with the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct.  And ``run.py`` refuses to run
without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, bench_json_with
import run

PAIRS = 20_000  # enough reads for the pre-pass to detect both adapters
SEED = 2**32 + 3


def run_small(cell, monkeypatch, trace=False):
    for k in ("FQTOOL_TPU_TORCH_DEVICE", "FQTOOL_TPU_TRACE", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "")
    run.set_environment(trace, "cpu")
    spec = bench_json_with(cell, Path(os.environ["TMPDIR"]))
    return run.run_cell(run.load_cell(cell, spec), SEED, 0.0, trace,
                        device="cpu", job_pairs=PAIRS)


@pytest.mark.parametrize("cell", ["pe_readme.lane", "pe_merge_corr.cfdna",
                                  "pe_readme.small_sample"])
def test_sound_run_is_correct(cell, tmp_env, monkeypatch):
    res = run_small(cell, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    # here on the CPU, the cell's end-to-end metrics but those of the card's trace
    cell_spec = run.load_cell(cell, bench_json_with(cell, tmp_env))
    assert set(res["metrics"]) == {m["name"] for m in cell_spec["end_to_end"]
                                   if m["source"] != "device_trace"}
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert not (tmp_env / "fqtool_bench").exists() or \
        not any((tmp_env / "fqtool_bench").iterdir())


def _alter_record(fn):
    def altered(*a, **kw):
        out = fn(*a, **kw)
        if len(out) > 40:  # one base of the first record's read
            out = out[:30] + (b"A" if out[30:31] != b"A" else b"C") + out[31:]
        return out
    return altered


def _alter_overlap(fn):
    import torch

    def altered(*a, **kw):
        ov = fn(*a, **kw)
        row = torch.nonzero(ov.overlapped)[:1, 0]
        ol = ov.overlap_len.clone()
        ol[row] -= 1
        return ov._replace(overlap_len=ol)
    return altered


def _drop_half(fn):
    def dropped(*a, **kw):
        a = list(a)
        keep = a[8].clone()
        keep[len(keep) // 2 :] = False
        a[8] = keep
        return fn(*a, **kw)
    return dropped


@pytest.mark.parametrize("fault", ["record_altered", "overlap_answer_altered",
                                   "half_the_pairs_left_out"])
@pytest.mark.parametrize("cell", ["pe_readme.lane", "pe_merge_corr.cfdna"])
def test_broken_timed_path_is_not_correct(cell, fault, tmp_env, monkeypatch):
    from fqtool_tpu_torch.pipeline import pe, pe_runner

    if fault == "record_altered":
        for name in ("format_array_records", "format_plane_array_records"):
            monkeypatch.setattr(pe_runner, name,
                                _alter_record(getattr(pe_runner, name)))
    elif fault == "overlap_answer_altered":
        monkeypatch.setattr(pe.ops_overlap, "analyze",
                            _alter_overlap(pe.ops_overlap.analyze))
    else:
        monkeypatch.setattr(pe_runner, "pe_pipeline",
                            _drop_half(pe_runner.pe_pipeline))
    res = run_small(cell, monkeypatch)
    assert not res["correct"]
    assert res["checks"]["records_differ"]["value"] + \
        res["checks"]["counters_differ"]["value"] > 0


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "pe_readme.lane", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.card
def test_refuses_without_the_program(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pe_readme.lane", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=600, cwd=tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_on_the_card(card, cell, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "1"],
                       capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
