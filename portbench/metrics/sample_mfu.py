"""The pipeline layer: the model FLOPs of the traced sampling calls
(counts/flops.py) over the traced span and the card's dense bf16 peak, in
percent."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "sample":
        return None
    return readings.mfu_percent(r["flops"], r["trace"]["window_us"] / 1e6)
