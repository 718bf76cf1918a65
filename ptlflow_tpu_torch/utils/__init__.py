"""Utilities of the PyTorch port: registry, checkpoints, weight
conversion, input adapter and the build of the CUDA kernels."""
