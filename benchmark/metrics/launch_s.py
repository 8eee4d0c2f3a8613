"""Seconds per input gigabase of the stage ``dispatch_launch``, inside
``pe_dispatch``: the launches of the pipeline body (pipeline/pe.py) on the
host."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "dispatch_launch")
