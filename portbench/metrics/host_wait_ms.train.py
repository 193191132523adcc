"""The data layer: the trainer's own host clock around next() on its two loaders
(`host_wait_ms_by_step`), the mean over the window's steps."""


def read(r):
    if r["kind"] != "train":
        return None
    return sum(r["host_wait_ms"]) / len(r["host_wait_ms"]) if r["host_wait_ms"] else None
