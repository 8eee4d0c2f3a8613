"""Percent of the window in which the card ran nothing: 1 minus the union of
its kernel, copy and set intervals (torch.profiler's device activity) over
the window's wall."""


def read(record):
    dev = record["device"]
    if not dev or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / record["window_s"])
