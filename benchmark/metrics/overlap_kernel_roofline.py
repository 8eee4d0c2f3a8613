"""Percent of its bytes roofline that the overlap kernel (csrc/overlap.cu)
reaches: the least time its bytes take at the card's peak bandwidth (run.py
``overlap_bytes``: the pairs the window's jobs scanned, once a pair, twice
with merging) over the device time of its launches in the trace."""


def read(record):
    dev = record["device"]
    if not dev or dev["overlap_kernel_s"] <= 0:
        return None
    least = record["overlap_bytes"] / record["peak_hbm_bytes_per_s"]
    return 100.0 * least / dev["overlap_kernel_s"]
