"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions."""
