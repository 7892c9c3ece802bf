"""Hand-written CUDA kernels, their plain torch versions and wrappers."""
