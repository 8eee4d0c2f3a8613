"""Seconds per input gigabase of ``card_unfed.prepass``: the card's unfed
time while the main thread was in the pre-pass."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "card_unfed.prepass")
