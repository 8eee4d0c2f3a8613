"""Seconds per input gigabase of the stage ``pe_fold_dup``, inside
``pe_fold``: a chunk's keys added to the duplication table
(host/duplicate.py)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold_dup")
