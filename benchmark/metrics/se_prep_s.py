"""Seconds per input gigabase of the stage ``se_prep``:
pipeline/runner.py::SingleEndRunner.submit_pack before the
chunks (index filter, UMI offsets, the transport encoding's hand-over)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "se_prep")
