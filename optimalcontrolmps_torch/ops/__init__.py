"""Kernels and gate construction of the PyTorch port."""
