"""Seconds per input gigabase of ``card_unfed``: the time of each job in
which the card had no chunk of it queued (host/tracing.py: the job less the
union of its chunks' intervals, from the event before a chunk's first
upload to the end of its copies back)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "card_unfed")
