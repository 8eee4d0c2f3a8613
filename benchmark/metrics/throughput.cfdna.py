"""``throughput``'s number (input Mbp of the window's jobs over its wall),
read per layer in a cell whose host-clock rate spreads too widely between
runs to hold a bound."""


def read(record):
    return record["bases"] / 1e6 / record["window_s"]
