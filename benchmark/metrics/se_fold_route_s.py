"""Seconds per input gigabase of the stage ``se_fold_route``:
pipeline/runner.py::SingleEndRunner._fold (format_selected for the
pass and failed streams)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_fold_route")
