"""Device operations of the port: plain PyTorch and the CUDA kernel wrappers."""
