"""Device operators (PyTorch and hand-written CUDA kernels) and their golden CPU reference."""
