"""Seconds per input gigabase of the stage ``prepass``: main.py::_prepass (the
read-length and adapter pre-passes)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "prepass")
