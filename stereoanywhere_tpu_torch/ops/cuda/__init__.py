"""Hand-written Hopper kernels of the port.

Each module holds a kernel's wrapper, its plain PyTorch version and the
wrapper's launch counter.  A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches its kernel or raises.
"""
