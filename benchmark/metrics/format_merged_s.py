"""Seconds per input gigabase of the stage ``pe_fold_format_merged``: the
merged stream's record formatter on the shared pool (thread time, so it can
exceed the wall)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold_format_merged")
