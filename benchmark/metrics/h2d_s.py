"""Seconds per input gigabase of the stage ``dispatch_h2d``, inside
``pe_dispatch``: pipeline/device.py::to_device (contiguous copies, int32
casts and the enqueue of the uploads)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "dispatch_h2d")
