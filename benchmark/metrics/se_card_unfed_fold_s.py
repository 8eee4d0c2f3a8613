"""Seconds per input gigabase of ``card_unfed.se_fold``: the card's unfed
time while the main thread was in the single-end fold."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "card_unfed.se_fold")
