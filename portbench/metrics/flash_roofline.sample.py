"""The kernels: K1 (flash forward) against its floor over the traced calls, in
percent."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "sample":
        return None
    return readings.roofline_percent(r, ("flash",))
