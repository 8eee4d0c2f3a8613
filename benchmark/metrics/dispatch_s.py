"""Seconds per input gigabase of the stage ``pe_dispatch``:
pipeline/pe_runner.py::submit_pack (slicing, uploads and launches of every
chunk)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_dispatch")
