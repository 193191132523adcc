"""The device: the share of the traced span in which no kernel, memcpy or memset
ran, in percent."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "sample":
        return None
    return readings.idle_percent(r)
