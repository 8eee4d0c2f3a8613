"""Seconds per input gigabase of the stage ``pe_fold``:
pipeline/pe_runner.py::_fold_chunk (statistics, routing and record
formatting on the main thread; its patch and assembly stages are inside it)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold")
