"""The port's host tracing (``fqtool_tpu_torch/host/tracing.py``) on the CPU.

Spans nest and keep self and CPU time; the root span ``job`` closes the
books of its thread (``main_other``); every registry entry keeps the shape
the benchmark reads; tracing off costs one shared null context; the card's
unfed time is put down to the spans open during it; and a traced paired-end
CLI run records every stage and writes the same bytes as an untraced one.
"""

from __future__ import annotations

import json
import threading

import pytest
import torch

from fqtool_tpu_torch.host import tracing
from fqtool_tpu_torch.main import main as torch_main
from fqtool_tpu_torch.pipeline import device as device_mod
from fqtool_tpu_torch.pipeline import pe_runner

from .test_torch_cli import _run
from .torch_multihost import assert_same_bytes
from .torch_pairs import write_pairs

S = 10**9  # ns in a second


class Clock:
    """A span clock that reads what the test sets."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def traced(monkeypatch):
    """Tracing on, an empty registry, and an empty one again afterwards."""
    monkeypatch.setattr(tracing, "_ENABLED", True)
    tracing.reset()
    yield tracing
    tracing.reset()


@pytest.fixture
def clock(monkeypatch):
    clk = Clock()
    monkeypatch.setattr(tracing, "_clock", clk)
    return clk


def _seconds(snap, name):
    return snap[name]["seconds"]


def _job_a_b_c(clk, fed=None, monkeypatch=None):
    """job [0, 100] s holding a [10, 40] (which holds b [20, 30]) and
    c [50, 60]."""
    if fed is not None:
        monkeypatch.setattr(tracing, "_card_intervals", lambda c, a: fed)
    clk.now = 0
    with tracing.job():
        clk.now = 10 * S
        with tracing.stage("a"):
            clk.now = 20 * S
            with tracing.stage("b"):
                clk.now = 30 * S
            clk.now = 40 * S
        clk.now = 50 * S
        with tracing.stage("c"):
            clk.now = 60 * S
        clk.now = 100 * S


def test_nesting_and_self_time(traced, clock):
    _job_a_b_c(clock)
    snap = tracing.snapshot()
    assert [_seconds(snap, n) for n in ("job", "a", "b", "c")] == [100, 30, 10, 10]
    assert {n: tracing._self[n] / S for n in ("job", "a", "b", "c")} == \
        {"job": 60, "a": 20, "b": 10, "c": 10}
    assert tracing._parent == {"job": None, "a": "job", "b": "a", "c": "job"}
    # each span keeps its name, start, end, parent and thread
    main = threading.get_ident()
    got = {s[0]: s[1:] for s in tracing.spans()}
    assert got["b"] == (20 * S, 30 * S, "a", main)
    assert got["job"] == (0, 100 * S, None, main)


def test_other_threads_are_roots_of_their_own(traced, clock):
    def work():
        with tracing.stage("side"):
            pass

    with tracing.job():
        with tracing.stage("a"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert tracing._parent["side"] is None
    assert tracing._threaded == {"side"}


def test_main_other_is_the_job_less_its_top_level_stages(traced, clock):
    _job_a_b_c(clock)
    snap = tracing.snapshot()
    assert _seconds(snap, "main_other") == 60
    assert _seconds(snap, "main_other") + _seconds(snap, "a") + \
        _seconds(snap, "c") == _seconds(snap, "job")


def test_main_other_on_the_real_clock(traced):
    def spin(n):
        return sum(i * i for i in range(n))

    with tracing.job():
        spin(20_000)
        for _ in range(3):
            with tracing.stage("outer"):
                spin(10_000)
                with tracing.stage("inner"):
                    spin(10_000)
        with tracing.stage("last"):
            spin(5_000)
        spin(20_000)
    snap = tracing.snapshot()
    top = _seconds(snap, "outer") + _seconds(snap, "last")
    assert _seconds(snap, "main_other") > 0
    assert _seconds(snap, "main_other") + top == \
        pytest.approx(_seconds(snap, "job"), abs=1e-5)
    assert _seconds(snap, "inner") < _seconds(snap, "outer")


def test_every_span_has_its_cpu_time(traced):
    with tracing.job():
        with tracing.stage("a"):
            sum(range(100_000))
    snap = tracing.snapshot()
    for name in ("job", "a"):
        assert snap[f"{name}@cpu"]["calls"] == snap[name]["calls"] == 1
        assert 0 < snap[f"{name}@cpu"]["seconds"]


def test_every_entry_is_seconds_and_calls(traced, clock, monkeypatch):
    _job_a_b_c(clock, fed=[(30 * S, 55 * S)], monkeypatch=monkeypatch)
    with tracing.stage("outside_the_job"):
        pass
    snap = tracing.snapshot()
    assert {"job", "job@cpu", "a@cpu", "main_other", "card_fed", "card_unfed",
            "card_unfed.a", "card_unfed.main_other"} <= set(snap)
    for name, entry in snap.items():
        assert set(entry) == {"seconds", "calls"}, name
        float(entry["seconds"])
    # the benchmark's reading of the registry (run.py::add_stages)
    assert json.loads(json.dumps(snap)) == snap


def test_the_card_timeline_is_registered_at_the_job_end(traced, clock, monkeypatch):
    _job_a_b_c(clock, fed=[(30 * S, 55 * S)], monkeypatch=monkeypatch)
    snap = tracing.snapshot()
    got = {n: _seconds(snap, n) for n in snap if n.startswith("card_")}
    assert got == {"card_fed": 25, "card_unfed": 75, "card_unfed.a": 20,
                   "card_unfed.b": 10, "card_unfed.c": 5,
                   "card_unfed.main_other": 50}
    assert got["card_unfed"] == got["card_unfed.a"] + got["card_unfed.c"] + \
        got["card_unfed.main_other"]


def test_no_card_no_card_entries(traced, clock):
    _job_a_b_c(clock)
    assert not [n for n in tracing.snapshot() if n.startswith("card_")]


def test_card_events_make_the_fed_intervals(traced, clock, monkeypatch):
    """card_begin anchors the card's events to the span clock once a job;
    card_end closes each chunk; the job's end reads them (CUDA faked on the
    host's clock, shifted as a card's own clock would be)."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, stream=None):
            self.t = clock.now + 123_456_789  # the card's clock

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) / 1e6

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda")
    clock.now = 0
    with tracing.job():
        clock.now = 10 * S
        with tracing.stage("pe_dispatch"):
            first = tracing.card_begin(card)
            clock.now = 12 * S
            second = tracing.card_begin(card)
        clock.now = 20 * S
        with tracing.stage("pe_fold"):
            done = Event(True)
            done.record()
            tracing.card_end(first, done, None)
            clock.now = 25 * S
            done = Event(True)
            done.record()
            tracing.card_end(second, done, None)
            clock.now = 60 * S
        assert tracing.card_chunks() == [(10 * S, 20 * S, 20 * S),
                                         (12 * S, 25 * S, 25 * S)]
        clock.now = 100 * S
    assert len(tracing._anchors) == 1  # one anchor a card a job
    snap = tracing.snapshot()
    got = {n: _seconds(snap, n) for n in snap if n.startswith("card_")}
    assert got == {"card_fed": 15, "card_unfed": 85, "card_unfed.pe_dispatch": 0,
                   "card_unfed.pe_fold": 35, "card_unfed.main_other": 50}


def test_tracing_off_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(tracing, "_ENABLED", False)
    monkeypatch.setattr(tracing, "_profiling", False)
    tracing.reset()

    def no_clock():
        raise AssertionError("the span clock was read with tracing off")

    monkeypatch.setattr(tracing, "_clock", no_clock)
    first = tracing.stage("a")
    assert tracing.stage("b") is first
    assert type(first).__slots__ == ()
    with tracing.job():
        with tracing.stage("a"):
            with first:
                pass
    assert tracing.snapshot() == {}
    assert tracing.spans() == []

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert tracing.card_begin(torch.device("cuda", 0)) is None


def test_the_launch_stream_event_times_only_when_traced(monkeypatch):
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(enable_timing)

        def record(self, stream=None):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    device_mod.PipelineResult({}, torch.device("cuda", 0))
    device_mod.PipelineResult({}, torch.device("cuda", 0), begun=("key", None))
    assert made == [False, True]


# the unfed attribution as a pure function: job [0, 100], spans a [10, 40]
# holding b [20, 30], and c [50, 60]
SPANS = [("b", 20, 30), ("a", 10, 40), ("c", 50, 60)]


@pytest.mark.parametrize("fed,want", [
    ([], (0, 100, {"a": 30, "b": 10, "c": 10, "main_other": 60})),
    ([(-5, 120)], (100, 0, {"a": 0, "b": 0, "c": 0, "main_other": 0})),
    # a fed interval that a and c straddle
    ([(30, 55)], (25, 75, {"a": 20, "b": 10, "c": 5, "main_other": 50})),
    # overlapping intervals, one past the job's end, one from its start
    ([(90, 110), (95, 100), (0, 5)],
     (15, 85, {"a": 30, "b": 10, "c": 10, "main_other": 45})),
    # fed exactly over a span, edges touching
    ([(10, 40), (40, 50)], (40, 60, {"a": 0, "b": 0, "c": 10, "main_other": 50})),
], ids=["nothing_fed", "all_fed", "straddled", "overlapping_and_clipped",
        "edges_touch"])
def test_attribute_unfed(fed, want):
    fed_t, unfed_t, by = tracing.attribute_unfed(0, 100, fed, SPANS)
    assert (fed_t, unfed_t, by) == want
    assert fed_t + unfed_t == 100


def test_attribute_unfed_no_spans():
    assert tracing.attribute_unfed(0, 10, [(2, 4)], []) == \
        (2, 8, {"main_other": 8})


def test_dump_prints_the_tree(traced, clock, capsys):
    def work():
        with tracing.stage("side"):
            pass

    _job_a_b_c(clock)
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    tracing.dump()
    err = capsys.readouterr().err
    lines = err.splitlines()
    assert lines[1].split() == ["stage", "total", "self", "cpu", "calls"]
    rows = {line.split()[0]: line for line in lines[2:]}
    assert rows["job"].split()[1:3] == ["100.000", "60.000"]
    assert rows["a"].startswith("  a ") and rows["b"].startswith("    b ")
    assert "side (thread time)" in err
    assert "%" not in err


LANE = ["-q", "--kmer", "--kmer_length", "6", "-d", "-a", "--detect_pe_adapter"]
NEW_STAGES = {"job", "reports", "pe_emit", "pe_prep", "dispatch_h2d",
              "dispatch_launch", "pe_fold_stats", "pe_fold_dup", "pe_fold_count",
              "pe_fold_route", "d2h", "main_other"}


def test_traced_cli_run_has_every_stage_and_the_same_bytes(tmp_path, monkeypatch):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 1500, seed=41,
                adapters=True)
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    # two chunks a pack, so that the fetch thread runs
    monkeypatch.setattr(pe_runner, "PE_CHUNK", 256)
    argv = ["-i", str(tmp_path / "r1.fq"), "-I", str(tmp_path / "r2.fq"),
            "-o", "o1.fq.gz", "-O", "o2.fq.gz", *LANE,
            "-J", "report.json", "-H", "report.html"]
    assert _run(torch_main, argv, tmp_path / "plain") == 0
    monkeypatch.setattr(tracing, "_ENABLED", True)
    tracing.reset()
    try:
        assert _run(torch_main, argv, tmp_path / "traced") == 0
        snap = tracing.snapshot()
        parents = dict(tracing._parent)
    finally:
        tracing.reset()
    assert NEW_STAGES <= set(snap), NEW_STAGES - set(snap)
    assert assert_same_bytes(tmp_path / "plain", tmp_path / "traced") == \
        ["o1.fq.gz", "o2.fq.gz"]
    assert snap["job"]["calls"] == 1
    # the sub-stages stay inside their stages
    subs = ("pe_fold_stats", "pe_fold_dup", "pe_fold_count", "pe_fold_route")
    assert sum(snap[n]["seconds"] for n in subs) <= snap["pe_fold"]["seconds"]
    assert snap["dispatch_h2d"]["seconds"] + snap["dispatch_launch"]["seconds"] \
        <= snap["pe_dispatch"]["seconds"]
    top = {n for n, p in parents.items() if p == "job"}
    assert {"prepass", "input_wait", "pe_prep", "pe_dispatch", "pe_device_wait",
            "pe_fold", "pe_emit", "writer_close", "reports"} <= top
    assert parents["d2h"] is None  # the fetch thread's


def test_profile_dir_traces_the_paired_end_stages(tmp_path, monkeypatch):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 300, seed=43)
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FQTOOL_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setattr(tracing, "_ENABLED", False)
    argv = ["-i", str(tmp_path / "r1.fq"), "-I", str(tmp_path / "r2.fq"),
            "-o", "o1.fq.gz", "-O", "o2.fq.gz", "-q"]
    assert _run(torch_main, argv, tmp_path / "run") == 0
    assert not tracing._profiling
    assert tracing.snapshot() == {}
    traces = list((tmp_path / "prof").glob("fqtool_tpu_torch.*.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"pe_dispatch", "dispatch_h2d", "dispatch_launch", "pe_fold",
            "pe_fold_route", "input_wait"} <= names
