"""textboost_torch: the PyTorch/CUDA port of textboost_tpu.

Same models, samplers and on-disk artifacts as the JAX package, in PyTorch
idiom (NCHW `nn.Module`s with diffusers/transformers state-dict keys), with
the TPU's Pallas kernels rewritten as CUDA kernels for Hopper
(`textboost_torch/csrc/`).  Entry points run on the GPU unless the caller
passes `device="cpu"`.  The package imports neither JAX nor textboost_tpu.
"""

__version__ = "0.1.0"
