"""Seconds per input gigabase of the stage ``pe_emit``: the main thread
handing each pack's output streams to their writers in
pipeline/pe_runner.py::run (a wait on a full writer queue included)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_emit")
