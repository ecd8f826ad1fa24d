"""Hand-written CUDA kernels (wrappers, plain versions) and their registry."""
