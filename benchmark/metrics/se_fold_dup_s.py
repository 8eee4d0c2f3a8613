"""Seconds per input gigabase of the stage ``se_fold_dup``:
pipeline/runner.py::SingleEndRunner._drain_chunks
(DuplicateTable.add_batch)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_fold_dup")
