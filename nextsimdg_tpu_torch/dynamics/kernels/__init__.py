"""Hand-written CUDA kernels of the dynamics (built at first use)."""
