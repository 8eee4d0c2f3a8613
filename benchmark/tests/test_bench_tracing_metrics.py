"""The readers of the program's nested spans, main-thread books and card
timeline (``metrics/<name>.py``) on a synthetic traced record, each None
where its entries are missing; and a whole traced run of the lane at a tiny
size on the CPU, whose stage registry ``run.py::add_stages`` takes whole."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, bench_json_with
import run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
GBP = 0.012

# each reader and the registry entries it reads
STAGE_READERS = {
    "reports_s": ("reports",),
    "emit_s": ("pe_emit",),
    "main_other_s": ("main_other",),
    "h2d_s": ("dispatch_h2d",),
    "launch_s": ("dispatch_launch",),
    "fold_stats_s": ("pe_fold_stats",),
    "fold_dup_s": ("pe_fold_dup",),
    "fold_count_s": ("pe_fold_count",),
    "fold_route_s": ("pe_fold_route",),
    "prep_s": ("pe_prep",),
    "d2h_s": ("d2h",),
    "card_unfed_s": ("card_unfed",),
    "card_unfed_fold_s": ("card_unfed.pe_fold",),
    "card_unfed_prepass_s": ("card_unfed.prepass",),
    "card_unfed_tail_s": ("card_unfed.writer_close", "card_unfed.reports"),
}
NEW = sorted(STAGE_READERS) + ["main_cpu_share", "launch_gap_s"]


def record(stages=None, busy_s=0.0521):
    rec = json.loads((BENCH / "tests" / "data" / "traced_record.json").read_text())
    rec["stages"] = dict(stages or {})
    rec["device"]["busy_s"] = busy_s
    return rec


def synthetic_stages() -> dict:
    """Distinct seconds for every entry the new readers read."""
    names = sorted({s for ss in STAGE_READERS.values() for s in ss})
    stages = {n: 0.1 * (i + 1) for i, n in enumerate(names)}
    stages.update({"job": 4.0, "job@cpu": 3.0, "card_fed": 0.5})
    return stages


def test_every_new_metric_is_in_the_lane():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["pe_readme.lane"]
        assert m["moves"] == "throughput"
        assert (m["unit"], m["better"]) == (
            ("%", "higher") if name == "main_cpu_share" else ("s/Gbp", "lower"))
        assert callable(run.reader(name))


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader(name):
    stages = synthetic_stages()
    want = sum(stages[s] for s in STAGE_READERS[name]) / GBP
    assert run.reader(name)(record(stages)) == pytest.approx(want)


def test_main_cpu_share():
    assert run.reader("main_cpu_share")(record(synthetic_stages())) == \
        pytest.approx(75.0)


def test_launch_gap():
    got = run.reader("launch_gap_s")(record(synthetic_stages(), busy_s=0.2))
    assert got == pytest.approx((0.5 - 0.2) / GBP)


def test_tail_reads_either_half():
    assert run.reader("card_unfed_tail_s")(
        record({"card_unfed.reports": 0.3})) == pytest.approx(0.3 / GBP)


@pytest.mark.parametrize("name", NEW)
def test_missing_entries_read_none(name):
    assert run.reader(name)(record({"pe_fold": 1.0, "pe_dispatch": 2.0})) is None


def test_launch_gap_needs_the_device_trace():
    rec = record(synthetic_stages())
    rec["device"] = {}
    assert run.reader("launch_gap_s")(rec) is None


def test_card_idle_closes_with_the_window():
    """``card_unfed_s`` + ``launch_gap_s`` is the card's idle time inside the
    jobs: ``device_idle``'s idle seconds less the time between jobs."""
    stages = synthetic_stages()
    rec = record(stages, busy_s=0.2)
    idle_s = rec["window_s"] - 0.2
    inside = (run.reader("card_unfed_s")(rec) + run.reader("launch_gap_s")(rec)) * GBP
    assert inside == pytest.approx(stages["card_unfed"] + 0.5 - 0.2)
    assert inside < idle_s


def test_traced_cpu_run_feeds_the_new_readers(tmp_env, monkeypatch):
    """A traced run of the lane on the CPU: the registry's new entries reach
    the record through ``add_stages``; the card's readers find nothing."""
    from fqtool_tpu_torch.host import tracing

    for k in ("FQTOOL_TPU_TORCH_DEVICE", "FQTOOL_TPU_TRACE", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "")
    run.set_environment(True, "cpu")
    monkeypatch.setattr(tracing, "_ENABLED", True)
    cell = "pe_readme.lane"
    spec = bench_json_with(cell, Path(os.environ["TMPDIR"]))
    try:
        res = run.run_cell(run.load_cell(cell, spec), 2**32 + 5, 0.0, True,
                           device="cpu", job_pairs=20_000)
    finally:
        tracing.reset()
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in sorted(STAGE_READERS) + ["main_cpu_share"]:
        if name.startswith("card_"):
            assert name not in got  # no card on the CPU
        else:
            assert got[name]["value"] >= 0, name
    assert "launch_gap_s" not in got
    assert 0 < got["main_cpu_share"]["value"] <= 100.5
    assert got["fold_stats_s"]["value"] + got["fold_dup_s"]["value"] + \
        got["fold_count_s"]["value"] + got["fold_route_s"]["value"] <= \
        got["fold_s"]["value"]
    assert got["h2d_s"]["value"] + got["launch_s"]["value"] <= \
        got["dispatch_s"]["value"]


def _first_after(starts, htod, slack=100_000) -> list:
    """For each anchored start, the start of the profiler's first upload
    from ``slack`` ns before it on, less it."""
    out = []
    for a in starts:
        later = [h for h in htod if h >= a - slack]
        if later:
            out.append(later[0] - a)
    return sorted(out)


def _summary(errors) -> dict:
    return {"n": len(errors), "min_ns": errors[0], "median_ns": errors[len(errors) // 2],
            "max_ns": errors[-1],
            "within_1ms": sum(1 for e in errors if abs(e) < 1_000_000)}


def clock_check(pairs: int, seed: int, work: Path) -> dict:
    """The span clock against torch.profiler's device clock on the card,
    under one CPU and CUDA profiler session:

    - quiet: 50 uploads alone, each just after ``tracing.card_begin``'s event,
      with nothing else running: the anchored start of each against the
      profiler's ``Memcpy HtoD``, which only the clocks part;
    - job: a traced lane job of ``pairs`` pairs after a warm one: each
      chunk's anchored start against the first plane upload after it (the
      main thread may lose the interpreter lock in between);
    - the anchor's bound: the host clock from before an event's record to
      the return of the synchronize after it, 20 times."""
    import time

    import torch
    from torch.autograd import DeviceType

    from fqtool_tpu_torch.host import tracing
    from fqtool_tpu_torch.main import main as port_main

    cell = run.load_cell("pe_readme.lane")
    gen, law = run.traffic_of(cell["cell"])
    (work / "in").mkdir(parents=True)
    r1, r2 = work / "in" / "r1.fq.gz", work / "in" / "r2.fq.gz"
    gen.make_and_write(law, pairs, seed, str(r1), str(r2))
    jobs = run.Jobs(cell, work, (r1, r2), "cuda:0", False)
    out = work / "out"
    out.mkdir()
    argv = jobs.argv(out, r1, r2)
    assert port_main(argv) == 0  # warm: the kernel's build, the caches
    dev = torch.device("cuda", 0)
    host = torch.ones(1 << 20, dtype=torch.uint8)

    def htod(prof, least_ns):
        """Starts of the profiler's uploads that last ``least_ns`` or more:
        a chunk's planes, not the pipeline's small constants."""
        return sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA and "HtoD" in e.name()
                      and e.duration_ns() >= least_ns)

    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t_quiet = time.time_ns()
        with tracing.job():
            for _ in range(50):
                begun = tracing.card_begin(dev)
                host.to(dev, non_blocking=True)
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                torch.cuda.synchronize()
                tracing.card_end(begun, done, torch.cuda.current_stream(dev))
                time.sleep(0.002)
            quiet = [a for a, _, _ in tracing.card_chunks()]
        torch.cuda.synchronize()
        t_job = time.time_ns()
        assert port_main(argv) == 0
        torch.cuda.synchronize()
    chunks = [a for a, _, _ in tracing.card_chunks()]
    copies = htod(prof, 0)
    planes = htod(prof, 50_000)  # a 16,384 x 150 plane, not a length vector
    bounds = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = tracing._clock()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        bounds.append(tracing._clock() - t0)
    job = _first_after(chunks, [h for h in planes if h >= t_job])
    return {"quiet": _summary(_first_after(quiet, [h for h in copies if h < t_job])),
            "job": _summary(job), "job_error_ns": job,
            "anchor_bound_ns": sorted(bounds),
            "time_ns_minus_profiler_first_htod": t_quiet - copies[0],
            "monotonic_ns_minus_profiler_first_htod":
                time.monotonic_ns() - (time.time_ns() - t_quiet) - copies[0]}


@pytest.mark.card
def test_span_clock_meets_the_profiler(card, tmp_env, monkeypatch, capsys):
    """The span clock is the profiler's: an upload's anchored start lands
    within 1 ms of the profiler's ``Memcpy HtoD`` for it, every one of them
    when nothing else runs, and the median one in a lane job."""
    from fqtool_tpu_torch.host import tracing

    monkeypatch.setattr(tracing, "_ENABLED", True)
    for k in ("FQTOOL_TPU_TORCH_DEVICE", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "")
    run.set_environment(True, card)
    pairs = int(os.environ.get("CLOCK_CHECK_PAIRS", "1000000"))
    try:
        got = clock_check(pairs, 2**31 + 17, tmp_env / "clock")
    finally:
        tracing.reset()
    with capsys.disabled():
        print("clock_check " + json.dumps(got))
    assert got["quiet"]["within_1ms"] == got["quiet"]["n"] == 50
    assert got["job"]["n"] > 0 and abs(got["job"]["median_ns"]) < 1_000_000
