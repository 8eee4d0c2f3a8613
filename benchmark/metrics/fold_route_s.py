"""Seconds per input gigabase of the stage ``pe_fold_route``, inside
``pe_fold``: routing and record formatting on the main thread
(``pe_fold_assemble`` inside it where merging is on)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "pe_fold_route")
