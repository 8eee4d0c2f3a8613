"""Seconds per input gigabase of the stage ``reports``:
pipeline/pe_runner.py::write_reports (the JSON and HTML reports)."""

from readers import stage_per_gbp


def read(record):
    return stage_per_gbp(record, "reports")
