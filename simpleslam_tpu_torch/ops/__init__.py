"""Device math on torch tensors, and the wrappers of the CUDA kernels."""
