"""Seconds per input gigabase of the stage ``se_emit``:
pipeline/runner.py::SingleEndRunner.run's emit (the hand-off to the
writers' queues, a wait on a full queue included)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_emit")
