"""Input bases of the window's jobs (the bases of the generator's input
files, ``bases`` of its records, for each job), in Mbp, over the wall from
the window's start to the end of its last job."""


def read(record):
    return record["bases"] / 1e6 / record["window_s"]
