"""Seconds per input gigabase of the stage ``writer_close``: the writers' final
flush at the end of each job."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "writer_close")
