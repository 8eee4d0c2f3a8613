"""Seconds per input gigabase of the stage ``pe_fold_count``, inside
``pe_fold``: insert sizes, correction, polyG/polyX and adapter accounting
and the ORA sampling of a chunk."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold_count")
