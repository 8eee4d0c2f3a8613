"""Seconds per input gigabase of the stage ``d2h``: the copies out of
pipeline/device.py::PipelineResult.get, on the fetch thread (thread time,
beside the main thread's wall)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "d2h")
