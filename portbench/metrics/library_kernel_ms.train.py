"""The models' library kernels (cuDNN, cuBLAS, PyTorch's elementwise): device
time per traced step of every kernel that is none of the four, in ms."""
from portbench.counts import readings


def read(r):
    if r["kind"] != "train":
        return None
    return readings.library_ms(r)
