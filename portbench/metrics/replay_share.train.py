"""The capture layer: the step graph's replays in the window over the window's
steps (`Trainer.graph_stats()`), in percent."""


def read(r):
    if r["kind"] != "train":
        return None
    return 100.0 * r["replays"] / r["steps"]
