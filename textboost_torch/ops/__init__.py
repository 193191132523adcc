"""Kernels (CUDA, with plain PyTorch versions), attention dispatch and the
noise schedule."""
