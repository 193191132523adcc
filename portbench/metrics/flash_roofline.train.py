"""The kernels: K1 and K2 (flash forward and backward) against their floors over
the traced steps, in percent."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "train":
        return None
    return readings.roofline_percent(r, ("flash", "flash_bwd"))
