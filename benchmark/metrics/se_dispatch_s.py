"""Seconds per input gigabase of the stage ``se_dispatch``:
pipeline/runner.py::SingleEndRunner._dispatch (slicing, uploads and
launches of every chunk of a pack)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_dispatch")
