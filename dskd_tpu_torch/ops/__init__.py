"""Kernels of the port: CUDA launch wrappers with their plain PyTorch twins."""
