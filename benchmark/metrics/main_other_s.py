"""Seconds per input gigabase of ``main_other``: the time of each job
(``main.py::run``, the span ``job``) on its thread that no stage covers."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "main_other")
