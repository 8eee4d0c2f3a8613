"""Seconds per input gigabase in which the card had a chunk of the job
queued and ran nothing: ``card_fed`` (the union of the chunks' intervals,
host/tracing.py) less the card's busy seconds in the profiler's trace.  The
trickle between launch-bound kernels, waits on the host's copies included."""


def read(record):
    dev = record["device"]
    fed = record["stages"].get("card_fed")
    if fed is None or not dev or record["gbp"] <= 0:
        return None
    return (fed - dev["busy_s"]) / record["gbp"]
