"""Pallas kernels for the GPU (Triton route)."""
