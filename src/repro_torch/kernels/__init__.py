"""Hand-written CUDA kernels of the port, one directory per TPU kernel replaced."""
