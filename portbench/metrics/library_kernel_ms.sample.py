"""The models' library kernels: device time per traced image of every kernel
that is none of the four, in ms."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "sample":
        return None
    return readings.library_ms(r)
