"""Seconds per input gigabase of the stage ``se_device_wait``:
pipeline/runner.py::SingleEndRunner._drain_chunks (waiting on the card
and the copies back; no fold work)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_device_wait")
