"""Input bases of the window's jobs (pairs x 2 x read length), in Mbp,
over the wall from the window's start to the end of its last job."""


def read(record):
    return record["bases"] / 1e6 / record["window_s"]
