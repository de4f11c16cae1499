"""Kernels (CUDA wrappers beside their plain PyTorch versions) and decoding."""
