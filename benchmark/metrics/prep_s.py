"""Seconds per input gigabase of the stage ``pe_prep``: the host preparation
of a pack in pipeline/pe_runner.py::submit_pack before its chunks are
dispatched (transport encodings, index filter, UMI, chunk size)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_prep")
