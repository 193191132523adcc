"""The kernels: K3 and K4 (GroupNorm forward and backward) against their floors
over the traced steps, in percent."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "train":
        return None
    return readings.roofline_percent(r, ("gn", "gn_bwd"))
