"""Percent of each job's wall on its thread (the span ``job``) that was the
thread's own CPU time (``job@cpu``, ``time.thread_time``): the rest is
waiting, on the interpreter lock, the card or the writers, or a host that
runs the thread slower."""


def read(record):
    stages = record["stages"]
    if stages.get("job", 0) <= 0 or "job@cpu" not in stages:
        return None
    return 100.0 * stages["job@cpu"] / stages["job"]
