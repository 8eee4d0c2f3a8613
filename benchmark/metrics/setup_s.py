"""Seconds from the start of the run's process to the start of its window:
imports, the input made from the seed, the warm job."""


def read(record):
    return record["setup_s"]
