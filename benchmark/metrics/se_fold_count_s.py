"""Seconds per input gigabase of the stage ``se_fold_count``:
pipeline/runner.py::SingleEndRunner._count (filter results, polyG and
adapter accounting, ORA sampling)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_fold_count")
