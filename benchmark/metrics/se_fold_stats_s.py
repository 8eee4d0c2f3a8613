"""Seconds per input gigabase of the stage ``se_fold_stats``:
pipeline/runner.py::SingleEndRunner._drain_chunks (the pre- and
post-filter StatsAccumulator adds)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_fold_stats")
