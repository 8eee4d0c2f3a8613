"""Seconds per input gigabase of the stage ``gzip_out``: the writers' deflate
(io/fastq.py, thread time, so it can exceed the wall)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "gzip_out")
