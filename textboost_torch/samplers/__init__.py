"""Diffusion samplers."""
