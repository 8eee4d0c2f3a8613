"""Seconds per input gigabase of the stage ``se_fold``:
pipeline/runner.py::SingleEndRunner (the chunks' statistics and
duplicate adds, then the pack's counters and records on the main thread)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_fold")
