"""Seconds in which the card ran anything (the union of its kernel, copy
and set intervals in torch.profiler's device activity) over the window's
jobs, per input gigabase: the card time that a job's bases cost."""


def read(record):
    dev = record["device"]
    if not dev or dev["busy_s"] <= 0 or record["gbp"] <= 0:
        return None
    return dev["busy_s"] / record["gbp"]
