"""PyTorch/CUDA kernels and plain PyTorch ops of the port."""
