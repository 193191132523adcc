"""Sampling pipeline and the model-dir loader."""
