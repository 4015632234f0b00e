"""Numerical building blocks and the CUDA kernels."""
