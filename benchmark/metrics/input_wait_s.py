"""Seconds per input gigabase of the stage ``input_wait``: the main loop
waiting on the prefetch thread's next pack (io/fastq.py,
pipeline/runner.py::prefetched)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "input_wait")
