"""``overlap_kernel_roofline``'s number, read in a cell whose end-to-end
metric is the card's time: percent of its bytes roofline that the overlap
kernel reaches (run.py ``overlap_bytes`` at the card's peak bandwidth over
the device time of its launches in the trace)."""


def read(record):
    dev = record["device"]
    if not dev or dev["overlap_kernel_s"] <= 0:
        return None
    least = record["overlap_bytes"] / record["peak_hbm_bytes_per_s"]
    return 100.0 * least / dev["overlap_kernel_s"]
