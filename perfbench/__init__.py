"""The benchmark of sienerf_torch, the PyTorch and CUDA port (README.md)."""
