"""Kernels and ops of the PyTorch port."""
