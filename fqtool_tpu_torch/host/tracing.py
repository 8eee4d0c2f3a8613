"""Host spans of a run: ``FQTOOL_TPU_TRACE=1``.

The reference's only observability is timestamped stderr logs
(reference: src/util.h:469-478 loginfo calls at stage transitions).  Here
every pipeline stage is a span, ``with stage(name):``, timed into a
process-wide registry that is printed at exit as a tree (:func:`dump`) and
read by the benchmark through :func:`snapshot`.

- Each span keeps its name, its start and end on the span clock
  (``time.time_ns``, the clock of torch.profiler's events), its parent (the
  span open on the same thread when it started) and its thread.  The spans
  of the current job stay in memory (:func:`spans`).
- The registry holds, per name, the summed wall seconds and the number of
  calls, and under ``<name>@cpu`` the thread CPU time (``time.thread_time``)
  of the same spans.  A span on another thread than the main one (tokenize,
  gzip_out, d2h, the shared pool's formatters) sums that thread's time,
  which can exceed the wall.
- :func:`job` is the root span of one CLI invocation (``main.py::run``).  At
  its end it registers ``main_other``, the time of the job on its thread that
  no child span covers, so that the job thread's top-level stages plus
  ``main_other`` sum to ``job``; and, where the job dispatched to a card,
  the card's timeline: ``card_fed`` (the union of the chunks' device
  intervals, from the event before a chunk's first upload to the end of its
  copies back, :func:`card_begin`/:func:`card_end`), ``card_unfed`` (the rest
  of the job) and ``card_unfed.<stage>`` (the unfed time during which a span
  of that name was open on the job thread, ``card_unfed.main_other`` where
  none was).
- With tracing off, :func:`stage` returns one shared null context: no clock
  reading, no lock, no CUDA event.  While a ``FQTOOL_TPU_PROFILE_DIR``
  profile runs (``host/profile.py``), every stage also opens a
  ``torch.profiler.record_function`` of its name.

Every entry of :func:`snapshot` has the shape ``{"seconds": ..., "calls":
...}``.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

_ENABLED = os.environ.get("FQTOOL_TPU_TRACE", "") == "1"
# set by host/profile.py while its torch.profiler session runs
_profiling = False

# the span clock: torch.profiler stamps its host and device events on the
# same one (their ``start_ns()``)
_clock = time.time_ns

_lock = threading.Lock()
_totals: Dict[str, int] = defaultdict(int)  # ns, cpu ns under "<name>@cpu"
_counts: Dict[str, int] = defaultdict(int)
_self: Dict[str, int] = defaultdict(int)  # ns not covered by child spans
_parent: Dict[str, str] = {}  # name -> the parent's name, first seen
_threaded: set = set()  # names recorded off the main thread
_marks: Dict[str, float] = {}
# the current job's spans: (name, start ns, end ns, parent name, thread id)
_spans: List[tuple] = []
# the current job's chunks on a card: (device, begin, done, end) events
_chunks: List[tuple] = []
_anchors: Dict[object, tuple] = {}  # device -> (event, span clock ns)
_local = threading.local()


class _Null:
    """The context :func:`stage` returns with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "t0", "t1", "c0", "child", "parent", "rf")

    def __init__(self, name: str):
        self.name = name
        self.t0 = None
        self.rf = None

    def __enter__(self):
        if _profiling:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if _ENABLED:
            st = _stack()
            self.parent = st[-1] if st else None
            st.append(self)
            self.child = 0
            self.c0 = time.thread_time_ns()
            self.t0 = _clock()
        return None

    def __exit__(self, *exc):
        if self.t0 is not None:
            t1 = self.t1 = _clock()
            cpu = time.thread_time_ns() - self.c0
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            elif self in st:
                st.remove(self)
            dur = t1 - self.t0
            parent = self.parent
            if parent is not None:
                parent.child += dur
            name = self.name
            pname = parent.name if parent is not None else None
            tid = threading.get_ident()
            with _lock:
                _totals[name] += dur
                _counts[name] += 1
                _totals[name + "@cpu"] += cpu
                _counts[name + "@cpu"] += 1
                _self[name] += dur - self.child
                _parent.setdefault(name, pname)
                if tid != threading.main_thread().ident:
                    _threaded.add(name)
                _spans.append((name, self.t0, t1, pname, tid))
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False


def stage(name: str):
    """The span of a pipeline stage, as a context: ``with stage(name):``.
    With tracing off (and no profile running), one shared null context."""
    if _ENABLED or _profiling:
        return _Span(name)
    return _NULL


def set_profiling(on: bool) -> None:
    """Open a ``record_function`` in every stage while a profile runs
    (host/profile.py)."""
    global _profiling
    _profiling = bool(on)


def _add(name: str, ns: int) -> None:
    _totals[name] += ns
    _counts[name] += 1


@contextmanager
def job():
    """The root span ``job`` of one CLI invocation.  Starts the job's span
    list and card timeline afresh; at its end registers ``main_other`` and,
    where it dispatched to a card, ``card_fed``, ``card_unfed`` and
    ``card_unfed.<stage>``."""
    if not _ENABLED:
        with stage("job"):
            yield
        return
    with _lock:
        _spans.clear()
        _chunks.clear()
        _anchors.clear()
    span = _Span("job")
    try:
        with span:
            yield
    finally:
        _close_job(span)


def _close_job(span: _Span) -> None:
    if span.t0 is None:  # tracing turned on inside the job
        return
    tid = threading.get_ident()
    t0, t1 = span.t0, span.t1
    with _lock:
        _add("main_other", (t1 - t0) - span.child)
        mine = [(n, a, b) for n, a, b, _, th in _spans
                if th == tid and n != "job" and a >= t0 and b <= t1]
        chunks = list(_chunks)
        anchors = dict(_anchors)
    fed = _card_intervals(chunks, anchors)
    if fed is None:
        return
    fed_ns, unfed_ns, by = attribute_unfed(t0, t1, fed, mine)
    with _lock:
        _add("card_fed", fed_ns)
        _add("card_unfed", unfed_ns)
        for name, ns in by.items():
            _add(f"card_unfed.{name}", ns)


# ----------------------------------------------------------------------
# the card's timeline

def card_begin(device):
    """At a chunk's dispatch, before its first upload: with tracing on and
    ``device`` a card, a timing CUDA event recorded on the current stream;
    None otherwise.  The first on a card in a job anchors that card's
    events to the span clock: synchronize, record an event, synchronize,
    read the span clock."""
    if not _ENABLED or device.type != "cuda":
        return None
    import torch

    key = torch.device("cuda", device.index if device.index is not None
                       else torch.cuda.current_device())
    with _lock:
        anchored = key in _anchors
    if not anchored:
        torch.cuda.synchronize(key)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(key))
        torch.cuda.synchronize(key)
        t = _clock()
        with _lock:
            _anchors.setdefault(key, (ev, t))
    begin = torch.cuda.Event(enable_timing=True)
    begin.record(torch.cuda.current_stream(key))
    return key, begin


def card_end(begun, done, stream) -> None:
    """After a chunk's copies back, on ``stream``: closes the interval that
    :func:`card_begin` opened (``begun``); ``done`` is the event after the
    chunk's last device work."""
    import torch

    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    key, begin = begun
    with _lock:
        _chunks.append((key, begin, done, end))


def _resolved(chunks, anchors) -> List[Tuple[int, ...]]:
    """Each chunk's (begin, done, end) events on the span clock, ns; a chunk
    whose events never completed is left out."""
    out = []
    for key, *events in chunks:
        ev, t = anchors[key]
        try:
            events[-1].synchronize()
            out.append(tuple(t + round(ev.elapsed_time(e) * 1e6) for e in events))
        except RuntimeError:
            continue
    return out


def _card_intervals(chunks, anchors):
    """The chunks' (start, end of the copies back); None when the job put
    nothing on a card."""
    if not chunks:
        return None
    return [(a, c) for a, _, c in _resolved(chunks, anchors)]


def card_chunks() -> List[Tuple[int, ...]]:
    """The current job's chunks on the span clock: (start before the first
    upload, end of the last device work, end of the copies back), ns."""
    with _lock:
        chunks = list(_chunks)
        anchors = dict(_anchors)
    return _resolved(chunks, anchors)


def _union(iv: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[list] = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(x: Sequence[Tuple[int, int]], y: Sequence[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0
    while i < len(x) and j < len(y):
        a = max(x[i][0], y[j][0])
        b = min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute_unfed(t0, t1, fed, spans):
    """Split the job ``[t0, t1]`` into the card's fed time (the union of the
    ``fed`` intervals, clipped to the job) and its unfed rest, and put each
    unfed stretch down to the spans ``(name, start, end)`` of the job's
    thread open during it.  Returns ``(fed, unfed, by_stage)``:
    ``by_stage[name]`` is the unfed time during which a span of that name
    was open (a stretch counts for its innermost span and each span that
    holds it), ``by_stage["main_other"]`` the unfed time when none was."""
    fed_u = _union([(max(a, t0), min(b, t1)) for a, b in fed])
    fed_t = sum(b - a for a, b in fed_u)
    unfed, at = [], t0
    for a, b in fed_u:
        if a > at:
            unfed.append((at, a))
        at = b
    if t1 > at:
        unfed.append((at, t1))
    unfed_t = (t1 - t0) - fed_t
    by_name: Dict[str, list] = defaultdict(list)
    for name, a, b in spans:
        by_name[name].append((a, b))
    by = {name: _overlap(_union(iv), unfed) for name, iv in by_name.items()}
    by["main_other"] = unfed_t - _overlap(
        _union([(a, b) for _, a, b in spans]), unfed)
    return fed_t, unfed_t, by


# ----------------------------------------------------------------------

def reset() -> None:
    """Empty the registry, the marks and the current job's spans (the
    benchmark resets after its warm job, so that the registry holds the
    window's jobs alone)."""
    with _lock:
        for d in (_totals, _counts, _self, _parent, _marks, _anchors):
            d.clear()
        _threaded.clear()
        _spans.clear()
        _chunks.clear()


def mark(name: str) -> None:
    """Record a wall-clock phase timestamp (multi-host phase attribution:
    landed in the FQTOOL_TPU_TIMING_JSON file, main.py)."""
    with _lock:
        _marks[name] = time.time()


def marks() -> Dict[str, float]:
    with _lock:
        return dict(_marks)


def spans() -> List[tuple]:
    """The current job's spans: (name, start ns, end ns, parent name,
    thread id), in the order they ended."""
    with _lock:
        return list(_spans)


def snapshot() -> Dict[str, Dict[str, float]]:
    """``{name: {"seconds", "calls"}}`` of every registered entry."""
    with _lock:
        return {k: {"seconds": round(v / 1e9, 6), "calls": _counts[k]}
                for k, v in _totals.items()}


_DERIVED = ("main_other", "card_fed", "card_unfed")


def dump() -> None:
    """Print the registry at exit: the spans as a tree of total, self and
    CPU seconds, the other threads' stages (thread time), then the derived
    entries."""
    with _lock:  # background threads may still be recording at exit
        totals = dict(_totals)
        counts = dict(_counts)
        selfs = dict(_self)
        parent = dict(_parent)
        threaded = set(_threaded)
    if not totals:
        return
    w = sys.stderr.write
    children: Dict[object, list] = defaultdict(list)
    for name in selfs:
        children[parent.get(name)].append(name)
    seen: set = set()

    def row(name: str, depth: int, tag: str = "") -> None:
        if name in seen:
            return
        seen.add(name)
        label = ("  " * depth + name + tag)[:40]
        w(f"{label:<40} {totals[name] / 1e9:10.3f} {selfs[name] / 1e9:10.3f} "
          f"{totals.get(name + '@cpu', 0) / 1e9:10.3f} {counts[name]:8d}\n")
        for c in sorted(children.get(name, ()), key=lambda n: -totals[n]):
            row(c, depth + 1, " (thread time)" if c in threaded else "")

    w("=== fqtool_tpu_torch stages (seconds) ===\n")
    w(f"{'stage':<40} {'total':>10} {'self':>10} {'cpu':>10} {'calls':>8}\n")
    roots = sorted(children.get(None, ()), key=lambda n: -totals[n])
    for name in roots:
        if name not in threaded:
            row(name, 0)
    for name in roots:
        row(name, 0, " (thread time)")
    derived = [k for k in totals
               if k in _DERIVED or k.startswith("card_unfed.")]
    for name in sorted(derived, key=lambda k: (k.count("."), -totals[k])):
        w(f"{name:<40} {totals[name] / 1e9:10.3f} {'':>10} {'':>10} "
          f"{counts[name]:8d}\n")


if _ENABLED:
    atexit.register(dump)
