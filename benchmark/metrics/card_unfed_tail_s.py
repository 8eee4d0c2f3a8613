"""Seconds per input gigabase of ``card_unfed.writer_close`` plus
``card_unfed.reports``: the card's unfed time at each job's tail, while the
writers flushed and the reports were written."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "card_unfed.writer_close", "card_unfed.reports")
