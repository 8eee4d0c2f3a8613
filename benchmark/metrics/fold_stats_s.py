"""Seconds per input gigabase of the stage ``pe_fold_stats``, inside
``pe_fold``: the base statistics and k-mer counts of a chunk folded into the
accumulators (host/stats.py)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold_stats")
