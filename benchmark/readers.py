"""Arithmetic that the per-layer metric readers (``metrics/<name>.py``)
share.  A reader takes the run's record (``run.py::run_cell``) and returns a
number, or None when the run has nothing for it to read."""

from __future__ import annotations

from typing import Optional


def stage_per_gbp(record: dict, *stages: str) -> Optional[float]:
    """Seconds of the program's trace stages over the window, per input
    gigabase; None when no stage fired."""
    got = [record["stages"][s] for s in stages if s in record["stages"]]
    if not got or record["gbp"] <= 0:
        return None
    return sum(got) / record["gbp"]
