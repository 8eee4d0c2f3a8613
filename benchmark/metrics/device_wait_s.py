"""Seconds per input gigabase of the stage ``pe_device_wait``:
pipeline/device.py::PipelineResult.get (waiting on the card and the copies
back)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_device_wait")
