"""Build and bind the hand-written CUDA kernels in ``csrc/``."""
