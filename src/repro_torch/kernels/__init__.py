"""Hand-written CUDA kernels for Hopper, their builds and plain versions."""
